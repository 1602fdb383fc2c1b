"""Numerical-health checks: typed factorization status, NaN guards, f64
shadow runs (the port of ``spike_petsc_tpu.utils.debug``).

The reference's failure model is fail-fast SETERRQ plus MC64's structured
INFO(1) codes (+1 structurally singular, +2 scaling overflow,
reference/src/hslmc64.c:259-287).  The hazards here are numerical:
singular Schur pivots, silent f32 degradation, NaN propagation.  These
helpers surface them as typed results (``-pc_<name>_check``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# status codes, MC64 INFO(1)-style
OK = 0
SINGULAR = 1            # non-finite factors: a Schur pivot was singular
ILL_CONDITIONED = 2     # pivot growth beyond threshold


@dataclass(frozen=True)
class FactorHealth:
    """Health report of a block-Thomas/CR/SPIKE factorization (host
    values)."""

    status: int
    max_inverse_norm: float
    nonfinite: bool


def _tensors(obj):
    """Every tensor of a factor: dataclass fields, tuples and lists walked
    in order (the JAX pytree leaves)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)


def factor_health(fact, growth_threshold: float = 1e12) -> FactorHealth:
    """Inspect a ``BlockTriFactor``, ``CRFactor`` or ``SpikeFactor`` for
    singular or exploding pivots: a non-finite entry in any real floating
    tensor is ``SINGULAR``, a largest magnitude above ``growth_threshold``
    ``ILL_CONDITIONED``, else ``OK``.  The scan stays on the factor's
    device; its two results come to the host in one synchronization."""
    leaves = [t for t in _tensors(fact)
              if t.is_floating_point() and t.numel() > 0]
    if not leaves:
        return FactorHealth(status=OK, max_inverse_norm=0.0, nonfinite=False)
    stats = torch.stack([
        torch.stack([(~torch.isfinite(t)).any().to(torch.float64),
                     t.abs().amax().to(torch.float64)]) for t in leaves])
    bad, peak = stats.amax(dim=0).tolist()
    nonfinite = bad > 0
    status = (SINGULAR if nonfinite else
              ILL_CONDITIONED if peak > growth_threshold else OK)
    return FactorHealth(status=status, max_inverse_norm=peak,
                        nonfinite=nonfinite)


def check_finite(x, name: str = "array") -> None:
    """Host-side fail-fast NaN/Inf check (CHKMEMQ analogue for numerics)."""
    arr = (x.detach().cpu() if isinstance(x, torch.Tensor)
           else torch.as_tensor(np.asarray(x)))
    finite = torch.isfinite(arr)
    if not bool(finite.all()):
        bad = int((~finite).sum())
        raise FloatingPointError(
            f"{name}: {bad}/{arr.numel()} non-finite entries")


def _promote(x):
    """Real floating tensors to float64, complex ones to complex128,
    through tuples, lists and dicts; everything else as is."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return x.to(torch.complex128)
        return x.to(torch.float64) if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_promote(v) for v in x)
    if isinstance(x, dict):
        return {k: _promote(v) for k, v in x.items()}
    return x


def _first_tensor(res) -> torch.Tensor:
    if isinstance(res, torch.Tensor):
        return res
    if dataclasses.is_dataclass(res) or isinstance(res, (tuple, list)):
        return next(_tensors(res))
    if isinstance(res, dict):
        return _first_tensor(list(res.values()))
    raise TypeError(f"no tensor in {type(res).__name__}")


def shadow_check(fn, *args, rtol: float = 1e-4, **kwargs):
    """Run ``fn`` twice, as given and with its floating inputs promoted to
    float64, and report the relative deviation of the first tensor of the
    results (the optional float64 shadow run).  Returns ``(result,
    deviation)``; ``rtol`` is accepted for the JAX signature and not
    read."""
    res = fn(*args, **kwargs)
    res64 = fn(*_promote(args), **_promote(kwargs))
    a = _first_tensor(res).detach().cpu().to(torch.complex128)
    b = _first_tensor(res64).detach().cpu().to(torch.complex128)
    denom = float(torch.linalg.vector_norm(b)) or 1.0
    return res, float(torch.linalg.vector_norm(a - b)) / denom

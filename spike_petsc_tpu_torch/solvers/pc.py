"""Preconditioners (the PC layer), PyTorch.

A PC is a small object with an ``apply`` closure over device factorization
state (and, where the type has one, a multi-RHS ``apply_many``); factories
are registered by name and read their parameters from a prefix-scoped
options database.  Ported: ``none``, ``spike`` and ``cholesky`` (the
symmetric ``spd`` factorization of the spike family; forward apply and
multi-RHS apply, with the Newton safety net).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield
from functools import partial
from typing import Callable, Optional

import torch

from ..ops.band import BandedMatrix, banded_matvec
from ..ops.cuda.fused_sweep_spd import require_spd_feasible, spd_block_for
from ..ops.spike import spike_factor, spike_solve, spike_solve_many
from ..utils.options import Options
from ..utils.registry import PRECONDITIONERS, register_pc


@dataclass
class PC:
    """A configured preconditioner: ``apply`` maps residual -> correction."""

    name: str
    apply: Callable
    info: dict = dfield(default_factory=dict)
    inner: Optional["PC"] = None
    # native multi-RHS apply ([n, r] -> [n, r]) where the PC type has one
    # (the spike PC: spike_solve_many streams the factors once for all r
    # columns); None: callers apply ``apply`` column by column
    apply_many: Optional[Callable] = dfield(default=None, repr=False)
    # host-side builder for the M^{-T} apply (PCApplyTranspose)
    make_transpose: Optional[Callable] = dfield(default=None, repr=False)

    def describe(self, indent: int = 0) -> str:
        """PCView-style description: ``PC <name>: key=value, ...``, then
        the inner PC's, one level deeper."""
        pad = "  " * indent
        s = f"{pad}PC {self.name}: " + ", ".join(
            f"{k}={v}" for k, v in self.info.items())
        if self.inner is not None:
            s += "\n" + self.inner.describe(indent + 1)
        return s


def _as_banded(pmat, opts: Options) -> BandedMatrix:
    if isinstance(pmat, BandedMatrix):
        return pmat
    raise NotImplementedError(
        f"preconditioning matrices of type {type(pmat).__name__} are not yet "
        "ported to spike_petsc_tpu_torch (BandedMatrix is)")


def make_pc(name: str, pmat, options: Optional[Options] = None,
            prefix: str = "") -> PC:
    """Build a preconditioner by registry name, PETSc ``PCSetType`` style."""
    opts = (options or Options()).scoped(prefix)
    if not PRECONDITIONERS.has(name):
        raise NotImplementedError(
            f"pc type {name!r} is not yet ported to spike_petsc_tpu_torch "
            f"(ported: {', '.join(PRECONDITIONERS.names())})")
    return PRECONDITIONERS.get(name)(pmat, opts)


@register_pc("none")
def pc_none(pmat, opts: Options) -> PC:
    pc = PC(name="none", apply=lambda x: x)
    pc.make_transpose = lambda: pc                  # identity is symmetric
    return pc


def _newton_probe_active(inverter: str) -> bool:
    return inverter in ("newton", "newton_fixed")


def _probe_tolerance(store_dtype, spike_dtype) -> float:
    """Probe-residual acceptance threshold: reduced-precision storage
    legitimately floors the probe residual."""
    if store_dtype is not None:
        return 5e-2
    if spike_dtype is not None:
        return 5e-3
    return 1e-3


def _newton_safety_net(band, sf, inverter, store_dtype, spike_dtype,
                       refactor, exact: bool = True):
    """The Newton inverters assume the near-diagonally dominant regime (and
    'newton_fixed' has no convergence check at all): verify the
    factorization on a probe solve and re-factor with the pivoted blocked
    recursion if the result is junk.  ``exact=False`` (truncated
    factorizations, which drop coupling on purpose) rejects only
    non-finite or exploding probes.  Returns (sf, fell_back)."""
    if not _newton_probe_active(inverter):
        return sf, False
    probe = banded_matvec(band, torch.ones(band.n, dtype=band.dtype,
                                           device=band.device))
    xs = spike_solve(sf, probe)
    err = float(torch.linalg.norm(banded_matvec(band, xs) - probe)
                / torch.linalg.norm(probe))
    tol = _probe_tolerance(store_dtype, spike_dtype)
    bad = not math.isfinite(err) or (exact and err > tol) or err > 1e6
    if bad:
        return refactor(), True
    return sf, False


_DTYPES = {"": None, "none": None, "bf16": torch.bfloat16,
           "f32": torch.float32, "f64": torch.float64}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cast_apply(fn: Callable, factor_dtype: torch.dtype,
                dtype: torch.dtype) -> Callable:
    """``fn`` on a residual cast to the factors' dtype, its result cast back
    (``-pc_<name>_factor_dtype``).  The JAX package traces the inner solve
    with x64 off there, a Pallas lowering workaround with no counterpart
    here."""
    return lambda r: fn(r.to(factor_dtype)).to(dtype)


def _reject_unported(opts: Options, name: str) -> None:
    """Raise on spike options whose code paths are not yet ported."""
    unported = [f"-pc_{name}_{o}" for o in ("store_lt", "check")
                if opts.get_bool(f"pc_{name}_{o}", False)]
    if opts.get_string("pc_factor_shift_type", "none") != "none":
        unported.append("-pc_factor_shift_type")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)} not yet ported to spike_petsc_tpu_torch")


def _spike_pc(pmat, opts: Options, *, name: str, default_K: int,
              default_method: str = "inv") -> PC:
    band = _as_banded(pmat, opts)
    _reject_unported(opts, name)
    k = max(band.kl, band.ku, 1)
    K = opts.get_int(f"pc_{name}_partitions", default_K)
    K = max(1, min(K, band.n // (2 * k)))   # partitions must cover 2k rows
    block = opts.get_int(f"pc_{name}_block", None)
    method = opts.get_string(f"pc_{name}_method", default_method)
    on_card = method == "spd" and band.data.is_cuda
    if on_card and block is None:
        block = spd_block_for(k)        # a block size the spd kernels take
    truncated = opts.get_bool(f"pc_{name}_truncated", False)
    store = opts.get_bool(f"pc_{name}_store_spikes", False)
    inverter = opts.get_string(f"pc_{name}_inverter", "auto")
    store_dtype = _DTYPES[opts.get_string(f"pc_{name}_store_dtype", "")]
    spike_dtype = _DTYPES[opts.get_string(f"pc_{name}_spike_dtype", "")]
    # -pc_<name>_factor_dtype casts the BAND before factoring (store_dtype
    # casts the finished factor): an f64 operator with f32 factors, the
    # refinement recipe; every apply casts at the boundary
    orig_dtype = band.dtype
    factor_dtype = _DTYPES[opts.get_string(f"pc_{name}_factor_dtype", "")]
    cast = factor_dtype is not None and factor_dtype != orig_dtype
    if cast:
        band = BandedMatrix(data=band.data.to(factor_dtype), kl=band.kl,
                            ku=band.ku)

    def factor(inv):
        return spike_factor(band, K=K, block_b=block, method=method,
                            truncated=truncated, store_spikes=store,
                            inverter=inv,
                            store_dtype=store_dtype, spike_dtype=spike_dtype)

    sf = factor(inverter)
    if on_card:                         # every apply runs the spd kernels
        require_spd_feasible(sf.fact, sf.b, band.dtype,
                             f"pc '{name}' on the card: the spd sweep kernel")
    info = dict(partitions=K, block=sf.b, tip=sf.k, method=method,
                truncated=truncated)
    if cast:
        info["factor_dtype"] = _dtype_name(factor_dtype)
    if store_dtype is not None:
        info["store_dtype"] = _dtype_name(store_dtype)
    if spike_dtype is not None and store:
        info["spike_dtype"] = _dtype_name(spike_dtype)
    sf, fb = _newton_safety_net(band, sf, inverter, store_dtype, spike_dtype,
                                lambda: factor("blocked"),
                                exact=not truncated)
    if fb:
        info["inverter_fallback"] = "blocked"

    def _no_transpose():
        raise NotImplementedError(
            f"pc '{name}' transpose apply is not yet ported")

    apply = partial(spike_solve, sf)
    apply_many = partial(spike_solve_many, sf)
    if cast:
        apply = _cast_apply(apply, factor_dtype, orig_dtype)
        apply_many = _cast_apply(apply_many, factor_dtype, orig_dtype)
    return PC(name=name, apply=apply, info=info, apply_many=apply_many,
              make_transpose=_no_transpose)


@register_pc("spike")
def pc_spike(pmat, opts: Options) -> PC:
    return _spike_pc(pmat, opts, name="spike", default_K=16)


@register_pc("cholesky")
def pc_cholesky(pmat, opts: Options) -> PC:
    """Symmetric direct factorization, PETSc's ``-pc_type cholesky`` role:
    ``method='spd'`` block-LDL^T factors (F and Sinv stored, 2/3 of
    ``inv``'s block arrays).  The matrix must be symmetric: the factor reads
    only the diagonal and subdiagonal blocks.  The ``pc_cholesky_*``
    options of the spike family apply (partitions, default 1; block,
    default the tip size k, and on the card the smallest block the spd
    sweep kernels take, 64 or 128; truncated; store_spikes; inverter;
    store_dtype; factor_dtype); ``-pc_cholesky_method inv`` overrides the
    method.  On the card a factor the kernels refuse (another block size,
    an f64 band without ``-pc_cholesky_factor_dtype f32``) raises here."""
    return _spike_pc(pmat, opts, name="cholesky", default_K=1,
                     default_method="spd")

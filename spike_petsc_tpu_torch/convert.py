"""Carry the JAX package's objects, given as numpy arrays, into the port's.

``np.asarray`` of a JAX array gives the numpy arrays these take (a bfloat16
array comes as ``ml_dtypes.bfloat16``, which is accepted).  With these a
test can feed a JAX-computed factorization to the port's solve and hold
solve parity apart from factor parity.

Every function here puts its tensors on the card (``device="cuda"``) unless
the caller names another device, as the CPU tests do with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.band import BandedMatrix
from .ops.blocktri import BlockTriFactor, BlockTridiagonal
from .ops.spike import SpikeFactor

CUDA = torch.device("cuda")


def to_tensor(a, device=CUDA) -> Optional[torch.Tensor]:
    """numpy array -> tensor on ``device``; bfloat16 arrays keep their bits."""
    if a is None:
        return None
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def banded_from_numpy(data, kl: int, ku: int, device=CUDA) -> BandedMatrix:
    return BandedMatrix(data=to_tensor(data, device), kl=int(kl), ku=int(ku))


def blocktri_from_numpy(D, L, U, device=CUDA) -> BlockTridiagonal:
    """A BlockTridiagonal from its D, L, U blocks (``[..., nb, b, b]``)."""
    return BlockTridiagonal(D=to_tensor(D, device), L=to_tensor(L, device),
                            U=to_tensor(U, device))


def blocktri_factor_from_numpy(F, U, Sinv, device=CUDA,
                               method: str = "inv") -> BlockTriFactor:
    """A block-Thomas factor from its F, U, Sinv blocks: ``method='inv'``,
    or ``'spd'`` with an empty U (``[..., nb, 0, 0]``, as the JAX spd
    factor stores it)."""
    if method not in ("inv", "spd"):
        raise NotImplementedError(
            f"method={method!r} factors are not yet ported to "
            "spike_petsc_tpu_torch")
    return BlockTriFactor(F=to_tensor(F, device), U=to_tensor(U, device),
                          Sinv=to_tensor(Sinv, device), method=method)


def spike_factor_from_numpy(*, fact, Btip, Ctip, red_fact, V, W, n: int,
                            K: int, m: int, b: int, k: int,
                            truncated: bool = False, red_Dinv=None,
                            method: str = "inv",
                            device=CUDA) -> SpikeFactor:
    """A SpikeFactor from numpy arrays: ``fact`` and ``red_fact`` are
    ``(F, U, Sinv)`` triples (``red_fact`` None for K == 1 and for
    ``truncated`` factors, which carry ``red_Dinv`` ``[K-1, 2k, 2k]``
    instead), ``V``/``W`` None when spikes are not stored.  ``method`` is
    the partition factors' (the reduced factor is always ``inv``)."""
    return SpikeFactor(
        fact=blocktri_factor_from_numpy(*fact, device=device, method=method),
        Btip=to_tensor(Btip, device), Ctip=to_tensor(Ctip, device),
        red_fact=(None if red_fact is None
                  else blocktri_factor_from_numpy(*red_fact, device=device)),
        V=to_tensor(V, device), W=to_tensor(W, device),
        n=int(n), K=int(K), m=int(m), b=int(b), k=int(k),
        red_Dinv=to_tensor(red_Dinv, device), truncated=bool(truncated))

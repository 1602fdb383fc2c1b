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
from .ops.cyclic import CRFactor, CRLevel
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


def blocktri_factor_from_numpy(F, U, Sinv, device=CUDA, method: str = "inv",
                               Slu=None, piv=None,
                               nshift=None) -> BlockTriFactor:
    """A block-Thomas factor from its blocks: ``method='inv'``; ``'spd'``
    with an empty U (``[..., nb, 0, 0]``, as the JAX spd factor stores it);
    or ``'lu'`` with ``Slu`` and ``piv``.  ``piv`` is taken in the JAX
    package's 0-based convention and stored 1-based, the port's (see
    ``BlockTriFactor``).  ``nshift``: the shifted-pivot count, or None."""
    if method not in ("inv", "spd", "lu"):
        raise ValueError(f"unknown method {method!r}")
    if method == "lu" and (Slu is None or piv is None):
        raise ValueError("an 'lu' factor needs Slu and piv")
    piv = to_tensor(piv, device)
    if piv is not None:
        piv = (piv + 1 if piv.numel() else piv).to(torch.int32)
    return BlockTriFactor(F=to_tensor(F, device), U=to_tensor(U, device),
                          Sinv=to_tensor(Sinv, device), method=method,
                          Slu=to_tensor(Slu, device), piv=piv,
                          nshift=to_tensor(nshift, device))


def cr_factor_from_numpy(levels, root_Dinv, nb: int, n_pad: int,
                         nshift=None, device=CUDA) -> CRFactor:
    """A cyclic-reduction factor from its blocks: ``levels`` a sequence of
    ``(Dinv_e, P, Q, L_e, U_e)`` tuples, as the JAX ``CRLevel`` holds
    them."""
    return CRFactor(
        levels=tuple(CRLevel(*(to_tensor(a, device) for a in lv))
                     for lv in levels),
        root_Dinv=to_tensor(root_Dinv, device), nb=int(nb),
        n_pad=int(n_pad), nshift=to_tensor(nshift, device))


def _factor_from_numpy(f, method: str, device):
    """A factor from a ``(F, U, Sinv)`` triple of ``method``, or from the
    keyword arguments of ``blocktri_factor_from_numpy`` or (with
    ``levels``) ``cr_factor_from_numpy``."""
    if isinstance(f, dict):
        if "levels" in f:
            return cr_factor_from_numpy(**f, device=device)
        return blocktri_factor_from_numpy(**f, device=device)
    return blocktri_factor_from_numpy(*f, device=device, method=method)


def spike_factor_from_numpy(*, fact, Btip, Ctip, red_fact, V, W, n: int,
                            K: int, m: int, b: int, k: int,
                            truncated: bool = False, red_Dinv=None,
                            method: str = "inv", Lb=None,
                            device=CUDA) -> SpikeFactor:
    """A SpikeFactor from numpy arrays.  ``fact`` and ``red_fact``: a
    ``(F, U, Sinv)`` triple (of ``method`` for ``fact``, ``inv`` for
    ``red_fact``), or a dict of the keyword arguments of
    ``blocktri_factor_from_numpy`` (``lu`` factors, ``nshift``) or of
    ``cr_factor_from_numpy`` (CR factors); ``red_fact`` None for K == 1
    and for ``truncated`` factors, which carry ``red_Dinv``
    ``[K-1, 2k, 2k]`` instead.  ``V``/``W`` None when spikes are not
    stored; ``Lb`` the kept L blocks (store_lt) or None."""
    return SpikeFactor(
        fact=_factor_from_numpy(fact, method, device),
        Btip=to_tensor(Btip, device), Ctip=to_tensor(Ctip, device),
        red_fact=(None if red_fact is None
                  else _factor_from_numpy(red_fact, "inv", device)),
        V=to_tensor(V, device), W=to_tensor(W, device),
        n=int(n), K=int(K), m=int(m), b=int(b), k=int(k),
        red_Dinv=to_tensor(red_Dinv, device), truncated=bool(truncated),
        Lb=to_tensor(Lb, device))

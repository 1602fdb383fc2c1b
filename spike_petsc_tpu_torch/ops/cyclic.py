"""Block cyclic reduction (CR) for block-tridiagonal systems (PyTorch).

The port of ``spike_petsc_tpu.ops.cyclic``.  Block-Thomas
(``blocktri.py``) is a loop of ``nb`` steps with one small batched inverse
each; cyclic reduction eliminates every even-indexed block unknown of a
level at once, so a level is one batched inverse of ``[..., ne, b, b]``
blocks and a handful of batched products: log2(nb) levels in all, ~2x the
work and the stored blocks.  The SPIKE factor uses it for the reduced
interface system at large partition counts (K - 1 >= 255 block rows), and
as a partition factor (``spike_factor(method="cr")``).

Every tensor may carry leading batch dimensions (the SPIKE partition axis,
which the JAX package ``vmap``s); the block axis is ``-3``.

Elimination (0-based; nb padded to 2^L - 1 with decoupled identity blocks):
even unknowns x_i = Dinv_i (b_i - L_i x_{i-1} - U_i x_{i+1}) substitute into
odd rows j:

    P_j = L_j Dinv_{j-1}        Q_j = U_j Dinv_{j+1}
    D'_j = D_j - P_j U_{j-1} - Q_j L_{j+1}
    L'_j = -P_j L_{j-1}         U'_j = -Q_j U_{j+1}
    b'_j = b_j - P_j b_{j-1} - Q_j b_{j+1}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .blocktri import (BlockTridiagonal, _Guard, batched_inverse,
                       sweep_precision)


@dataclass(frozen=True)
class CRLevel:
    """One level's stored blocks, ``[..., n, b, b]`` each."""

    Dinv_e: torch.Tensor   # [..., ne, b, b] inverses of the even diagonals
    P: torch.Tensor        # [..., no, b, b] L_odd @ Dinv_left
    Q: torch.Tensor        # [..., no, b, b] U_odd @ Dinv_right
    L_e: torch.Tensor      # [..., ne, b, b] even sub-blocks (back-subst)
    U_e: torch.Tensor      # [..., ne, b, b] even super-blocks


@dataclass(frozen=True)
class CRFactor:
    """A cyclic-reduction factorization: the levels, the root block's
    inverse ``[..., b, b]``, the original block count ``nb`` and the padded
    one ``n_pad = 2^L - 1``; ``nshift`` as in ``BlockTriFactor`` (one count
    per leading batch entry, None without a shift)."""

    levels: Tuple[CRLevel, ...]
    root_Dinv: torch.Tensor
    nb: int
    n_pad: int
    nshift: Optional[torch.Tensor] = None

    @property
    def b(self) -> int:
        return self.root_Dinv.shape[-1]


def _pad_pow2m1(t: BlockTridiagonal) -> Tuple[BlockTridiagonal, int]:
    """Pad the block rows to the next 2^L - 1 with identity diagonal blocks
    decoupled from the rest (the last real row's U zeroed)."""
    nb, b = t.nb, t.b
    n_pad = 1
    while n_pad < nb:
        n_pad = 2 * n_pad + 1
    if n_pad == nb:
        return t, n_pad
    lead = t.D.shape[:-3]
    extra = (*lead, n_pad - nb, b, b)
    eye = torch.eye(b, dtype=t.dtype, device=t.D.device).expand(extra)
    zero = t.D.new_zeros(extra)
    U = t.U.clone()
    U[..., nb - 1, :, :] = 0
    return BlockTridiagonal(D=torch.cat([t.D, eye], dim=-3),
                            L=torch.cat([t.L, zero], dim=-3),
                            U=torch.cat([U, zero], dim=-3)), n_pad


def cr_factor(t: BlockTridiagonal, shift: str = "none",
              shift_amount: float = 0.0,
              inverter: str = "auto") -> CRFactor:
    """Cyclic-reduction factorization of ``[..., nb, b, b]`` blocks (JAX
    ``ops/cyclic.py:79-124``): log2(nb) levels, each one batched inverse
    (``blocktri.batched_inverse``, engine ``inverter``) and six batched
    products.  ``shift="nonzero"`` boosts small pivots of each level's even
    diagonal blocks and of the root before they are inverted
    (``blocktri.boost_diag``), the default floor taken from the PADDED
    blocks, as in JAX."""
    nb = t.nb
    tp, n_pad = _pad_pow2m1(t)
    guard = _Guard(tp, shift, shift_amount)
    D, L, U = tp.D, tp.L, tp.U
    levels = []
    while D.shape[-3] > 1:
        De, Do = D[..., 0::2, :, :], D[..., 1::2, :, :]
        Le, Lo = L[..., 0::2, :, :], L[..., 1::2, :, :]
        Ue, Uo = U[..., 0::2, :, :], U[..., 1::2, :, :]
        Dinv_e = batched_inverse(guard(De, extra_dims=1), inverter)
        # odd row j = 2t+1: left even t, right even t+1
        P = Lo @ Dinv_e[..., :-1, :, :]
        Q = Uo @ Dinv_e[..., 1:, :, :]
        D = Do - P @ Ue[..., :-1, :, :] - Q @ Le[..., 1:, :, :]
        L = -(P @ Le[..., :-1, :, :])
        U = -(Q @ Ue[..., 1:, :, :])
        levels.append(CRLevel(Dinv_e=Dinv_e, P=P, Q=Q, L_e=Le, U_e=Ue))
    root_Dinv = batched_inverse(guard(D[..., 0, :, :]), inverter)
    return CRFactor(levels=tuple(levels), root_Dinv=root_Dinv, nb=nb,
                    n_pad=n_pad, nshift=guard.count)


def cast_cr_factor(fact: CRFactor, dtype: torch.dtype) -> CRFactor:
    """Store the CR blocks in a lower precision (e.g. bfloat16): the solve
    promotes them to the f32-or-wider sweep precision, as
    ``blocktri.cast_factor``'s factors are."""
    def cast(lv: CRLevel) -> CRLevel:
        return CRLevel(Dinv_e=lv.Dinv_e.to(dtype), P=lv.P.to(dtype),
                       Q=lv.Q.to(dtype), L_e=lv.L_e.to(dtype),
                       U_e=lv.U_e.to(dtype))
    return CRFactor(levels=tuple(cast(lv) for lv in fact.levels),
                    root_Dinv=fact.root_Dinv.to(dtype), nb=fact.nb,
                    n_pad=fact.n_pad, nshift=fact.nshift)


def cr_solve(fact: CRFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs; rhs ``[..., nb, b]`` or ``[..., nb, b, r]`` with the
    factor's leading dims (JAX ``ops/cyclic.py:140-178``).  The products
    run at the sweep precision of the blocks and the rhs (bf16 blocks
    promote to f32), and so does the result.  Plain PyTorch: a down sweep
    folding the even right-hand sides into the odd ones, level by level, the
    root, and an up sweep recovering the even unknowns."""
    squeeze = rhs.dim() == fact.root_Dinv.dim()
    if squeeze:
        rhs = rhs[..., None]
    dtype = sweep_precision(fact.root_Dinv, rhs)
    cur = rhs.to(dtype)
    pad = fact.n_pad - fact.nb
    if pad:
        cur = torch.cat([cur, cur.new_zeros(
            (*cur.shape[:-3], pad, *cur.shape[-2:]))], dim=-3)

    def mm(a, v):
        return a.to(dtype) @ v

    stack = []
    for lv in fact.levels:
        be, bo = cur[..., 0::2, :, :], cur[..., 1::2, :, :]
        stack.append(be)
        cur = (bo - mm(lv.P, be[..., :-1, :, :])
               - mm(lv.Q, be[..., 1:, :, :]))
    x = mm(fact.root_Dinv, cur[..., 0, :, :])[..., None, :, :]
    for lv, be in zip(reversed(fact.levels), reversed(stack)):
        zero = x.new_zeros((*x.shape[:-3], 1, *x.shape[-2:]))
        x_left = torch.cat([zero, x], dim=-3)                  # x_{2t-1}
        x_right = torch.cat([x, zero], dim=-3)                 # x_{2t+1}
        xe = mm(lv.Dinv_e, be - mm(lv.L_e, x_left) - mm(lv.U_e, x_right))
        merged = x.new_empty((*x.shape[:-3], be.shape[-3] + x.shape[-3],
                              *x.shape[-2:]))
        merged[..., 0::2, :, :] = xe
        merged[..., 1::2, :, :] = x
        x = merged
    x = x[..., :fact.nb, :, :]
    return x[..., 0] if squeeze else x

"""Block-tridiagonal representation and block-Thomas factorization (PyTorch).

The port of ``spike_petsc_tpu.ops.blocktri``: the block conversions both
ways (``band_to_blocktri``, ``blocktri_to_band``, ``blocktri_to_dense``),
the factor methods ``inv``, ``spd`` and ``lu`` with the pivot-shift guard
(``shift='nonzero'``, ``boost_diag``), the batched inverses (LAPACK,
Newton–Schulz from the Jacobi or the Pan start, the blocked recursion),
the plain sweeps, and the transpose solve on the forward factor (the
``TransposedBlockTriFactor`` marker, ``blocktri_solve_transpose``) and the
regular-form transposed factor (``transposed_factor_from_L``).  A banded
matrix with half-bandwidths kl, ku <= b is a block-tridiagonal matrix with
dense ``b x b`` blocks; block-Thomas factorization does, per block row,

    F_i = L_i @ inv(S_{i-1}),     S_i = D_i - F_i @ U_{i-1},

i.e. two ``b x b`` matmuls and one batched inversion (``method="inv"``);
the symmetric ``method="spd"`` takes ``S_i = D_i - F_i @ L_i^H`` and stores
no U; ``method="lu"`` keeps pivoted LU factors of each S_i in place of its
inverse.  The JAX ``lax.scan`` over block rows becomes a Python loop over
``nb``; every tensor may carry leading batch dimensions (the SPIKE
partition axis K takes the place of ``jax.vmap``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .band import BandedMatrix, pad_banded


@dataclass(frozen=True)
class BlockTridiagonal:
    """Blocks of a block-tridiagonal matrix, ``[..., nb, b, b]`` each.

    D[i] is the diagonal block, L[i] couples block-row i to block i-1
    (L[0] == 0), U[i] couples block-row i to block i+1 (U[nb-1] == 0).
    """

    D: torch.Tensor
    L: torch.Tensor
    U: torch.Tensor

    @property
    def nb(self) -> int:
        return self.D.shape[-3]

    @property
    def b(self) -> int:
        return self.D.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.D.dtype


@dataclass(frozen=True)
class BlockTriFactor:
    """Block-Thomas factorization state (JAX ``ops/blocktri.py:59-92``).

    ``method == "inv"``: F, U, Sinv are ``[..., nb, b, b]``; F[0] == 0 and
    U[nb-1] == 0.  ``method == "spd"`` (symmetric or Hermitian block-LDL^H):
    F and Sinv only; U is an empty ``[..., nb, 0, 0]`` placeholder, the
    sweeps read F^H in its place.  ``method == "lu"``: F and U as for
    ``inv``, ``Slu`` ``[..., nb, b, b]`` the packed LU factors of each Schur
    complement S_i and ``piv`` ``[..., nb, b]`` int32 their row pivots, Sinv
    an empty placeholder.

    **Pivot convention:** ``piv`` is 1-based, as LAPACK's ``getrf`` and
    ``torch.linalg.lu_factor`` give it (row i was swapped with row
    ``piv[i] - 1``).  The JAX package stores 0-based pivots
    (``jax.scipy.linalg.lu_factor``); ``convert.blocktri_factor_from_numpy``
    adds one.

    A field a method does not use is a zero-size placeholder (``Slu``
    ``[..., nb, 0, 0]``, ``piv`` ``[..., nb, 0]``), filled in here when the
    caller passes None, as the JAX factor carries them.  ``nshift``: the
    count of Schur pivots the diagonal shift raised (int32, one per leading
    batch entry), or None when the factor was computed without a shift.
    """

    F: torch.Tensor
    U: torch.Tensor
    Sinv: torch.Tensor
    method: str = "inv"
    Slu: Optional[torch.Tensor] = None
    piv: Optional[torch.Tensor] = None
    nshift: Optional[torch.Tensor] = None

    def __post_init__(self):
        lead = self.F.shape[:-2]
        if self.Slu is None:
            object.__setattr__(self, "Slu", self.F.new_zeros((*lead, 0, 0)))
        if self.piv is None:
            object.__setattr__(self, "piv", self.F.new_zeros(
                (*lead, 0), dtype=torch.int32))

    @property
    def nb(self) -> int:
        return self.F.shape[-3]

    @property
    def b(self) -> int:
        return self.F.shape[-1]


@dataclass(frozen=True)
class TransposedBlockTriFactor:
    """Marker: solve with the TRANSPOSE of the wrapped factorization.

    Carries no data of its own: the SPIKE partition solve dispatches it to
    ``blocktri_solve_transpose``, which reuses ``base``'s stored blocks
    (the storage-sharing form of ``ops.spike.spike_transpose``; its sweeps
    are plain PyTorch, no kernel takes it)."""

    base: BlockTriFactor

    @property
    def nb(self) -> int:
        return self.base.nb

    @property
    def b(self) -> int:
        return self.base.b


# ---------------------------------------------------------------------------
# Conversion: band -> block-tridiagonal
# ---------------------------------------------------------------------------

def _skew_block_rows(X: torch.Tensor, b: int, kl: int, ku: int):
    """Band rows ``X [..., b, w]`` of one block row -> dense ``(l, d, u)``.

    ``Y[r, j] = X[r, j - r - b + kl]`` for ``j in [0, 3b)``, zero where the
    band index leaves ``[0, w)``; ``l, d, u = Y[:, :b], Y[:, b:2b],
    Y[:, 2b:]``.  The JAX version realizes the same index map with a
    pad-flatten-reshape skew.
    """
    w = X.shape[-1]
    r = torch.arange(b, device=X.device)[:, None]
    j = torch.arange(3 * b, device=X.device)[None, :]
    idx = j - r - b + kl
    valid = (idx >= 0) & (idx < w)
    idx = idx.clamp(0, w - 1).expand(*X.shape[:-1], 3 * b)
    Y = torch.where(valid, torch.gather(X, -1, idx),
                    torch.zeros((), dtype=X.dtype, device=X.device))
    return Y[..., :b], Y[..., b:2 * b], Y[..., 2 * b:]


def band_to_blocktri(band: BandedMatrix, b: int) -> BlockTridiagonal:
    """Diagonal-offset band storage -> block-tridiagonal blocks.

    Requires kl, ku <= b; rows are padded (unit diagonal) to a multiple of b.
    """
    if band.kl > b or band.ku > b:
        raise ValueError(f"block size {b} must cover half-bandwidths "
                         f"(kl={band.kl}, ku={band.ku})")
    nb = -(-band.n // b)
    band = pad_banded(band, nb * b)
    L, D, U = _skew_block_rows(band.data.reshape(nb, b, band.width), b,
                               band.kl, band.ku)
    L, U = L.clone(), U.clone()
    L[0] = 0
    U[nb - 1] = 0
    return BlockTridiagonal(D=D.contiguous(), L=L, U=U)


def blocktri_to_band(t: BlockTridiagonal, kl: int, ku: int) -> BandedMatrix:
    """Inverse of :func:`band_to_blocktri` (JAX ``ops/blocktri.py:158-181``):
    global block-tridiagonal blocks ``[nb, b, b]`` of a band with kl, ku <=
    b -> diagonal-offset storage ``[nb * b, kl + ku + 1]``.

    Row p of block row i holds ``[L_i | D_i | U_i][p, :]``; its band slot d
    is column ``p + b - kl + d`` of that row, always inside ``[0, 3b)``
    (the JAX version reads the same index through a widened-row skew)."""
    nb, b = t.nb, t.b
    if kl > b or ku > b:
        raise ValueError(f"half-bandwidths (kl={kl}, ku={ku}) must be <= "
                         f"block size {b}")
    w = kl + ku + 1
    cat = torch.cat([t.L, t.D, t.U], dim=-1)                 # [nb, b, 3b]
    idx = (torch.arange(b, device=cat.device)[:, None] + (b - kl)
           + torch.arange(w, device=cat.device)[None, :])
    band = torch.gather(cat, -1, idx.expand(nb, b, w))
    return BandedMatrix(data=band.reshape(nb * b, w), kl=kl, ku=ku)


def blocktri_to_dense(t: BlockTridiagonal) -> torch.Tensor:
    """Dense ``[nb b, nb b]`` copy of the blocks (JAX ``:184-193``)."""
    nb, b = t.nb, t.b
    a = t.D.new_zeros((nb * b, nb * b))
    for i in range(nb):
        a[i * b:(i + 1) * b, i * b:(i + 1) * b] = t.D[i]
        if i + 1 < nb:
            a[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = t.U[i]
            a[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = t.L[i + 1]
    return a


def blocktri_matvec(t: BlockTridiagonal, x: torch.Tensor) -> torch.Tensor:
    """y_i = L_i x_{i-1} + D_i x_i + U_i x_{i+1}; x: [nb, b] or [nb, b, r]."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    z = torch.zeros_like(x[:1])
    xm = torch.cat([z, x[:-1]], dim=0)
    xp = torch.cat([x[1:], z], dim=0)
    y = (_sweep_matvec(t.D, x) + _sweep_matvec(t.L, xm)
         + _sweep_matvec(t.U, xp))
    return y[..., 0] if squeeze else y


# ---------------------------------------------------------------------------
# Batched inverses
# ---------------------------------------------------------------------------

def _eye_like(S: torch.Tensor) -> torch.Tensor:
    return torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def lapack_inv(S: torch.Tensor) -> torch.Tensor:
    """Batched inverse by pivoted LU, with no error check: a singular block
    gives inf/NaN, as ``jnp.linalg.solve`` does, and the card is not
    synchronized to read LAPACK's status."""
    return torch.linalg.solve_ex(S, _eye_like(S).expand_as(S))[0]


def _jacobi_init(S: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    safe = torch.where(d != 0, d, torch.ones_like(d))
    return _eye_like(S) * (1.0 / safe)[..., None, :]


def blocked_inv(S: torch.Tensor, base: int = 32) -> torch.Tensor:
    """Batched inverse via recursive 2x2 blocked Schur complements, with
    pivoted LU solves at ``base`` size.  No pivoting ACROSS the 2x2 split:
    valid in the diagonally dominant regime (the safety net's re-factor)."""
    n = S.shape[-1]
    if n <= base:
        return lapack_inv(S)
    h = n // 2
    A, B = S[..., :h, :h], S[..., :h, h:]
    C, D = S[..., h:, :h], S[..., h:, h:]
    Ai = blocked_inv(A, base)
    CAi = C @ Ai
    Sci = blocked_inv(D - CAi @ B, base)
    AiB = Ai @ B
    TL = Ai + (AiB @ Sci) @ CAi
    top = torch.cat([TL, -(AiB @ Sci)], dim=-1)
    bot = torch.cat([-(Sci @ CAi), Sci], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _pan_init(S: torch.Tensor) -> torch.Tensor:
    """X0 = S^H / (||S||_1 ||S||_inf), per block."""
    a = S.abs()
    n1 = a.sum(dim=-2).amax(dim=-1)
    ninf = a.sum(dim=-1).amax(dim=-1)
    scale = (n1 * ninf).clamp_min(torch.finfo(a.dtype).tiny)
    return S.transpose(-1, -2).conj() / scale[..., None, None].to(S.dtype)


def newton_inv(S: torch.Tensor, tol: float = None, max_steps: int = 16,
               init: str = "jacobi") -> torch.Tensor:
    """Batched inverse via Newton–Schulz X <- X (2I - S X), at full
    precision, until max|SX - I| <= tol (default 50 eps), ``max_steps``, or
    divergence (error > 1e8 or NaN); JAX ``ops/blocktri.py:513-561``.

    ``init="jacobi"``: X0 = inv(diag S), which converges in the diagonally
    dominant regime.  ``init="pan"``: X0 = S^H / (||S||_1 ||S||_inf), which
    converges for any nonsingular S in ~log2(cond^2) more steps.  The
    convergence test reads the error on the host once per step (the JAX
    version's ``lax.while_loop`` predicate)."""
    eye = _eye_like(S)
    if tol is None:
        tol = 50 * torch.finfo(S.abs().dtype).eps
    if init == "pan":
        X = _pan_init(S)
    elif init == "jacobi":
        X = _jacobi_init(S)
    else:
        raise ValueError(f"unknown init {init!r}: expected jacobi or pan")
    for _ in range(max_steps):
        R = 2.0 * eye - S @ X
        err = float(torch.max(torch.abs(R - eye)))
        X = X @ R
        if not (tol < err < 1e8):
            break
    return X


def _cheap_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cheap-step product of ``newton_inv_fixed``.

    Precision mapping of JAX ``Precision.DEFAULT``: on the TPU that is one
    bf16 pass with f32 accumulation; on the CPU it is full precision.  Here
    an f32 product on a CUDA device rounds both operands to bf16 (cuBLAS
    accumulates in f32) and returns to f32 — set per call, no global
    matmul flag is touched.  Every other device or dtype runs at full
    precision, as XLA's DEFAULT does on the CPU."""
    if a.is_cuda and a.dtype == torch.float32:
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(a.dtype)
    return a @ b


def newton_inv_fixed(S: torch.Tensor, cheap_steps: int = 10,
                     polish_steps: int = 2) -> torch.Tensor:
    """Newton–Schulz with a FIXED precision schedule: ``cheap_steps`` at the
    cheap precision (see ``_cheap_matmul``; the iteration is
    self-correcting, E_{k+1} = E_k^2) then ``polish_steps`` at full
    precision to set the final accuracy.  No convergence check.  Use only in
    the diagonally dominant regime."""
    eye = _eye_like(S)
    X = _jacobi_init(S)
    for _ in range(cheap_steps):
        X = _cheap_matmul(X, 2.0 * eye - _cheap_matmul(S, X))
    for _ in range(polish_steps):
        X = X @ (2.0 * eye - S @ X)
    return X


def batched_inverse(S: torch.Tensor, inverter: str = "auto") -> torch.Tensor:
    """Dispatch: 'newton' (adaptive Newton–Schulz), 'newton_fixed'
    (fixed-schedule Newton), 'newton_pan' (adaptive Newton–Schulz from the
    Pan start, up to 48 steps: any nonsingular block), 'blocked' (Schur
    recursion), 'lapack' (pivoted LU through ``torch.linalg``).  'auto' is
    'lapack' on every device: the JAX package's "newton on TPU" choice was
    a TPU measurement."""
    if inverter == "newton":
        return newton_inv(S)
    if inverter == "newton_fixed":
        return newton_inv_fixed(S)
    if inverter == "newton_pan":
        return newton_inv(S, init="pan", max_steps=48)
    if inverter == "blocked":
        return blocked_inv(S)
    if inverter in ("auto", "lapack"):
        return lapack_inv(S)
    raise ValueError(f"unknown inverter {inverter!r}: expected auto, lapack, "
                     "newton, newton_fixed, newton_pan or blocked")


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------

def boost_diag(s: torch.Tensor, shift_amount, zeropivot: float = 1e-10):
    """Diagonal-shift guard for a batch of blocks ``[..., b, b]`` (JAX
    ``ops/blocktri.py:219-240``): pivots whose magnitude falls below
    ``max(shift_amount, zeropivot * max|block|, tiny)`` are raised to that
    floor, keeping their sign (phase), as PETSc's
    ``-pc_factor_shift_type nonzero`` repairs a pivot
    (reference/src/makefile:18).

    Returns ``(boosted_blocks, n_boosted)``, the count an int32 scalar."""
    s2, bad = _boost(s, _floor_tensor(shift_amount, s), zeropivot)
    return s2, bad.sum(dtype=torch.int32)


def _floor_tensor(amount, s: torch.Tensor) -> torch.Tensor:
    """``amount`` as a tensor of the real dtype of ``s``, at least that
    dtype's smallest normal number."""
    real = s.abs().dtype if s.is_complex() else s.dtype
    return torch.as_tensor(amount, dtype=real, device=s.device).clamp_min(
        torch.finfo(real).tiny)


def _boost(s: torch.Tensor, amount: torch.Tensor, zeropivot: float = 1e-10):
    """:func:`boost_diag` with ``amount`` a tensor from
    :func:`_floor_tensor`, broadcastable to the batch shape ``s.shape[:-2]``
    (a floor per partition), returning the boosted blocks and the
    ``[..., b]`` mask of the raised pivots."""
    d = torch.diagonal(s, dim1=-2, dim2=-1)
    floor = torch.maximum(amount, zeropivot * s.abs().amax(dim=(-2, -1)))
    floor = floor[..., None]
    bad = d.abs() < floor
    unit = torch.sgn(d)
    dnew = torch.where(bad, torch.where(unit == 0, 1, unit) * floor, d)
    return s + torch.diag_embed(dnew - d), bad


def _shift_amount(t: BlockTridiagonal, shift: str, shift_amount):
    """The absolute pivot floor of a shifted factor, one per leading batch
    entry (JAX ``:259-269``): ``shift_amount`` where it is positive, else
    ``1e-8 * max(|D|, |L|, |U|)`` of the entry's blocks, so that even an
    all-zero pivot block gets a boost of the matrix's scale.  None when
    ``shift == 'none'``."""
    if shift == "none":
        return None
    gscale = torch.stack([a.abs().amax(dim=(-3, -2, -1))
                          for a in (t.D, t.L, t.U)]).amax(dim=0)
    return torch.where(torch.as_tensor(shift_amount > 0),
                       torch.as_tensor(shift_amount, dtype=gscale.dtype,
                                       device=gscale.device),
                       1e-8 * gscale)


class _Guard:
    """The shift guard of one factorization: boosts each Schur complement
    before it is inverted (or LU-factored) and keeps the masks of the
    raised pivots, counted per leading batch entry by :attr:`count`.  A
    no-op without a shift."""

    def __init__(self, t: BlockTridiagonal, shift: str, shift_amount):
        amount = _shift_amount(t, shift, shift_amount)
        self.amount = None if amount is None else _floor_tensor(amount, t.D)
        self.bad = []

    def __call__(self, s: torch.Tensor, extra_dims: int = 0) -> torch.Tensor:
        """Boost ``s [..., (extra dims), b, b]``: ``extra_dims`` block axes
        between the batch and the block (CR's level axis) share the
        batch entry's floor and count."""
        if self.amount is None:
            return s
        amount = self.amount.reshape(self.amount.shape + (1,) * extra_dims)
        s, bad = _boost(s, amount)
        self.bad.append(bad.flatten(self.amount.dim()))
        return s

    @property
    def count(self) -> Optional[torch.Tensor]:
        """The raised pivots per leading batch entry (int32), None without
        a shift."""
        if self.amount is None:
            return None
        return torch.cat(self.bad, dim=-1).sum(dim=-1, dtype=torch.int32)


def _lu_factor(s: torch.Tensor):
    """Pivoted LU of a batch of blocks, no error check (a singular block
    gives inf/NaN downstream, as ``jax.scipy.linalg.lu_factor`` does, and
    no host sync)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(s)
    return lu, piv


def _lu_solve(slu: torch.Tensor, piv: torch.Tensor, rhs: torch.Tensor,
              trans: bool = False) -> torch.Tensor:
    """S x = rhs (``trans``: S^T x = rhs, no conjugation, as JAX's
    ``lu_solve(..., trans=1)``) from packed LU factors and 1-based pivots,
    in the rhs's dtype."""
    slu = slu.to(rhs.dtype)
    if not trans:
        return torch.linalg.lu_solve(slu, piv, rhs)
    return torch.linalg.lu_solve(slu, piv, rhs.conj(), adjoint=True).conj()


def _placeholder(like: torch.Tensor) -> torch.Tensor:
    """The zero-size ``[..., nb, 0, 0]`` block array of an unused field."""
    return like.new_zeros((*like.shape[:-2], 0, 0))


def _stack_F(f_list: list, like: torch.Tensor) -> torch.Tensor:
    """F stacked ``[..., nb, b, b]`` from its rows 1.., row 0 zero."""
    return torch.stack([torch.zeros_like(like)] + f_list, dim=-3)


def blocktri_factor(t: BlockTridiagonal, method: str = "inv",
                    shift: str = "none", shift_amount: float = 0.0,
                    inverter: str = "auto",
                    y0: Optional[torch.Tensor] = None):
    """Block-Thomas factorization over ``[..., nb, b, b]`` blocks (JAX
    ``ops/blocktri.py:243-357``): a loop over block rows of batched matmuls
    and one batched inversion (or LU) each.  No outer pivoting: the
    scaling/ordering pipeline is responsible for diagonal dominance.

    ``method="inv"``: F_i = L_i Sinv_{i-1}, S_i = D_i - F_i U_{i-1}.
    ``method="spd"`` (symmetric or Hermitian matrices): S_i = D_i - F_i
    L_i^H, re-symmetrized as ``(S + S^H) / 2`` before each inversion; the U
    blocks are ignored and not stored.
    ``method="lu"``: S_i kept as pivoted LU factors (``Slu``, ``piv``),
    F_i = L_i S_{i-1}^{-1} by a solve from the right.

    ``shift="nonzero"`` (any value but ``"none"``) runs the guard of
    :func:`boost_diag` on S_0 and on every Schur complement before it is
    inverted, with the floor ``shift_amount`` (or, where it is <= 0,
    ``1e-8`` of the largest entry of the blocks, per leading batch entry);
    ``nshift`` counts the raised pivots.

    ``y0`` (``[..., b, r]``, methods ``inv`` and ``spd``) carries the
    SPIKE factor's W forward sweep ``y_i = -F_i @ y_{i-1}`` along the
    recursion (JAX ``blocktri_factor_inv_waux``, ``:360-412``): the return
    is then ``(fact, y)``, ``y`` stacked ``[..., nb, b, r]``.
    """
    if method not in ("inv", "spd", "lu"):
        raise ValueError(
            f"unknown method {method!r} (use 'inv', 'lu', or 'spd')")
    if y0 is not None and method == "lu":
        raise ValueError("y0 (the W sweep) needs method 'inv' or 'spd'")
    spd = method == "spd"
    guard = _Guard(t, shift, shift_amount)
    d0 = t.D[..., 0, :, :]
    s0 = guard(_symmetrize(d0) if spd else d0)
    if method == "lu":
        lu, piv = _lu_factor(s0)
        f_list, lu_list, piv_list = [], [lu], [piv]
        for i in range(1, t.nb):
            f = torch.linalg.lu_solve(lu, piv, t.L[..., i, :, :], left=False)
            lu, piv = _lu_factor(
                guard(t.D[..., i, :, :] - f @ t.U[..., i - 1, :, :]))
            f_list.append(f)
            lu_list.append(lu)
            piv_list.append(piv)
        F = _stack_F(f_list, s0)
        return BlockTriFactor(F=F, U=t.U, Sinv=_placeholder(F), method="lu",
                              Slu=torch.stack(lu_list, dim=-3),
                              piv=torch.stack(piv_list, dim=-2).to(
                                  torch.int32), nshift=guard.count)
    s_inv = batched_inverse(s0, inverter)
    f_list, sinv_list = [], [s_inv]
    y_list = [] if y0 is None else [y0]
    for i in range(1, t.nb):
        l = t.L[..., i, :, :]
        f = l @ s_inv
        if spd:
            s = _symmetrize(t.D[..., i, :, :] - f @ l.mH)
        else:
            s = t.D[..., i, :, :] - f @ t.U[..., i - 1, :, :]
        s_inv = batched_inverse(guard(s), inverter)
        f_list.append(f)
        sinv_list.append(s_inv)
        if y0 is not None:
            y_list.append(-_sweep_matvec(f, y_list[-1]))
    F = _stack_F(f_list, s0)
    fact = BlockTriFactor(F=F, U=_placeholder(F) if spd else t.U,
                          Sinv=torch.stack(sinv_list, dim=-3), method=method,
                          nshift=guard.count)
    return fact if y0 is None else (fact, torch.stack(y_list, dim=-3))


def _symmetrize(s: torch.Tensor) -> torch.Tensor:
    """``(S + S^H) / 2``: inexact inverters leave O(eps) asymmetry that would
    otherwise compound down the recursion."""
    return 0.5 * (s + s.mH)


def blocktri_factor_inv_waux(t: BlockTridiagonal, y0: torch.Tensor,
                             shift: str = "none", shift_amount: float = 0.0,
                             inverter: str = "auto"):
    """``blocktri_factor(method='inv')`` on materialized blocks with the
    auxiliary W-spike forward sweep ``y_i = -F_i @ y_{i-1}`` carried
    alongside (JAX ``ops/blocktri.py:360-412``), and the shift guard of
    :func:`blocktri_factor`.  The SPIKE factor takes it for ``inv``
    partitions wherever the band-folded loop does not apply (a shift).

    ``t``: ``[..., nb, b, b]`` blocks; ``y0``: ``[..., b, r]``.  Returns
    ``(fact, y)`` with ``y`` stacked ``[..., nb, b, r]``."""
    return blocktri_factor(t, "inv", shift, shift_amount, inverter, y0=y0)


def blocktri_factor_inv_waux_band(local_band: torch.Tensor, y0: torch.Tensor,
                                  kl: int, ku: int, b: int,
                                  inverter: str = "auto",
                                  keep_l: bool = False):
    """``blocktri_factor(method='inv')`` straight from RAW band rows, with
    the auxiliary W-spike forward sweep ``y_i = -F_i @ y_{i-1}`` carried
    alongside.

    ``local_band``: partition band rows ``[..., nb, b, w]``; ``y0``:
    ``[..., b, r]``.  Each step skews its ``[b, w]`` row block to dense
    ``(l, d, u)`` blocks and feeds the Schur recursion.  Boundary semantics
    match ``band_to_blocktri``: block 0's L is never read and the last
    block's U is zeroed in the emitted factor.

    Returns ``(fact, y)`` with ``y`` stacked ``[..., nb, b, r]``; with
    ``keep_l``, ``(fact, y, L)`` with the subdiagonal blocks each step
    skewed, ``L`` ``[..., nb, b, b]`` (``L[0]`` zero, as
    ``band_to_blocktri`` gives it).
    """
    nb = local_band.shape[-3]
    _, d0, u_prev = _skew_block_rows(local_band[..., 0, :, :], b, kl, ku)
    s_inv = batched_inverse(d0, inverter)
    y = y0
    f_list, sinv_list, u_list, y_list = [], [s_inv], [], [y0]
    l_list = [torch.zeros_like(d0)] if keep_l else []
    for i in range(1, nb):
        l, d, u = _skew_block_rows(local_band[..., i, :, :], b, kl, ku)
        if keep_l:
            l_list.append(l)
        f = l @ s_inv
        s = d - f @ u_prev
        s_inv = batched_inverse(s, inverter)
        y = -_sweep_matvec(f, y)
        f_list.append(f)
        sinv_list.append(s_inv)
        u_list.append(u_prev)
        y_list.append(y)
        u_prev = u
    # U[i] is block i's superdiagonal; U[nb-1] is a partition edge -> 0
    U = torch.stack(u_list + [torch.zeros_like(u_prev)], dim=-3)
    fact = BlockTriFactor(F=_stack_F(f_list, d0), U=U,
                          Sinv=torch.stack(sinv_list, dim=-3))
    if keep_l:
        return fact, torch.stack(y_list, -3), torch.stack(l_list, dim=-3)
    return fact, torch.stack(y_list, -3)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------

def sweep_precision(*operands) -> torch.dtype:
    """Compute dtype for solve-sweep math: every operand promoted to the
    widest float type present, and at least float32.

    Precision mapping of the JAX rule (HIGHEST when every operand is a
    >= 32-bit float, DEFAULT when one is stored bf16): f32 products run in
    full FP32 (PyTorch's default; TF32 must stay off), and bf16-stored
    operands are promoted before the product, as the fused sweep kernel
    promotes them in registers — at least as accurate as DEFAULT."""
    dtype = torch.float32
    for o in operands:
        dtype = torch.promote_types(dtype, o.dtype)
    return dtype


def _sweep_matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[..., a, r] = sum_b m[..., a, b] v[..., b, r] at sweep precision."""
    dtype = sweep_precision(m, v)
    return m.to(dtype) @ v.to(dtype)


def cast_factor(fact: BlockTriFactor, dtype: torch.dtype) -> BlockTriFactor:
    """Store factors in a lower precision (e.g. bfloat16) while solves keep
    f32 carries: F/Sinv/U are read-bandwidth-bound in the sweeps."""
    if fact.method not in ("inv", "spd"):
        raise ValueError("cast_factor supports method='inv'/'spd' factors")
    return BlockTriFactor(F=fact.F.to(dtype), U=fact.U.to(dtype),
                          Sinv=fact.Sinv.to(dtype), method=fact.method,
                          nshift=fact.nshift)


def blocktri_solve(fact: BlockTriFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs given a block-Thomas factorization (JAX
    ``ops/blocktri.py:675-739``).

    rhs: ``[..., nb, b]`` or ``[..., nb, b, r]`` with the factor's leading
    dims.  Forward sweep ``y_i = rhs_i - F_i y_{i-1}``; backward sweep
    ``x_i = Sinv_i (y_i - U_i x_{i+1})`` for ``inv``,
    ``x_i = Sinv_i y_i - F_{i+1}^H x_{i+1}`` for ``spd`` (Sinv_i U_i =
    F_{i+1}^H when U_i = L_{i+1}^H and Sinv is Hermitian), and
    ``x_i = S_i^{-1} (y_i - U_i x_{i+1})`` by a pivoted LU solve for
    ``lu``.  The result is in the sweep precision (f32 or wider).  The plain
    version of the fused sweep kernels (``ops/cuda/fused_sweep.py``,
    ``fused_sweep_spd.py``), which take ``inv`` and ``spd`` factors only.
    """
    if fact.method not in ("inv", "spd", "lu"):
        raise ValueError(f"unsupported method {fact.method!r}")
    squeeze = rhs.dim() == fact.F.dim() - 1
    if squeeze:
        rhs = rhs[..., None]
    nb = fact.nb
    mv = _sweep_matvec
    ys = [rhs[..., 0, :, :].to(sweep_precision(fact.F, rhs))]
    for i in range(1, nb):
        ys.append(rhs[..., i, :, :] - mv(fact.F[..., i, :, :], ys[-1]))
    if fact.method == "lu":
        xs = [_lu_solve(fact.Slu[..., nb - 1, :, :], fact.piv[..., nb - 1, :],
                        ys[nb - 1])]
        for i in range(nb - 2, -1, -1):
            xs.append(_lu_solve(fact.Slu[..., i, :, :], fact.piv[..., i, :],
                                ys[i] - mv(fact.U[..., i, :, :], xs[-1])))
        x = torch.stack(xs[::-1], dim=-3)
        return x[..., 0] if squeeze else x
    xs = [mv(fact.Sinv[..., nb - 1, :, :], ys[nb - 1])]
    for i in range(nb - 2, -1, -1):
        if fact.method == "spd":
            xs.append(mv(fact.Sinv[..., i, :, :], ys[i])
                      - mv(fact.F[..., i + 1, :, :].mH, xs[-1]))
        else:
            xs.append(mv(fact.Sinv[..., i, :, :],
                         ys[i] - mv(fact.U[..., i, :, :], xs[-1])))
    x = torch.stack(xs[::-1], dim=-3)
    return x[..., 0] if squeeze else x


# ---------------------------------------------------------------------------
# Transpose solves
# ---------------------------------------------------------------------------

def transposed_factor_from_blocks(fact: BlockTriFactor,
                                  blocks: BlockTridiagonal) -> BlockTriFactor:
    """REGULAR-form factor for T^T from an ``inv`` forward factor and the
    original blocks (only ``blocks.L`` is read): see
    :func:`transposed_factor_from_L`."""
    return transposed_factor_from_L(fact, blocks.L)


def transposed_factor_from_L(fact: BlockTriFactor,
                             L: torch.Tensor) -> BlockTriFactor:
    """REGULAR-form ``inv`` factor for T^T from an ``inv`` forward factor
    and the subdiagonal blocks ``L`` (``[..., nb, b, b]``, row 0 ignored):

        F'_i = (Sinv_{i-1} U_{i-1})^T,  Sinv'_i = Sinv_i^T,
        U'_i = L_{i+1}^T

    The standard block-Thomas sweeps on it compute the transpose solve
    (substitute z_i = Sinv_i^T w_i into the sweeps of
    :func:`blocktri_solve_transpose`), so the sweep kernels take it as they
    take the forward factor.  ``F'`` is computed at the sweep precision and
    stored, with ``U'`` and ``Sinv'``, at the factor's dtype; all three are
    materialized contiguous (a transposed view is not what the kernels
    read).  It is a second factor-sized buffer beside the forward one."""
    if fact.method != "inv":
        raise ValueError("the regular-form transpose needs method='inv' "
                         f"block-Thomas factors (got {fact.method!r})")
    dtype = fact.F.dtype
    prec = sweep_precision(fact.U, fact.Sinv)
    FU = fact.Sinv[..., :-1, :, :].to(prec) @ fact.U[..., :-1, :, :].to(prec)
    zbb = torch.zeros_like(fact.F[..., :1, :, :])
    Fh = torch.cat([zbb, FU.transpose(-1, -2).to(dtype)], dim=-3)
    Uh = torch.cat([L[..., 1:, :, :].transpose(-1, -2).to(fact.U.dtype),
                    zbb], dim=-3)
    return BlockTriFactor(F=Fh.contiguous(), U=Uh.contiguous(),
                          Sinv=fact.Sinv.transpose(-1, -2).contiguous(),
                          method="inv", nshift=fact.nshift)


def blocktri_solve_transpose(fact: BlockTriFactor,
                             rhs: torch.Tensor) -> torch.Tensor:
    """Solve T^T x = rhs on the FORWARD factorization, no refactorization
    (PETSc MatSolveTranspose).

    T = L U with L unit lower block-bidiagonal (subdiagonal F) and U upper
    block-bidiagonal (diagonal S, superdiagonal U), so T^T = U^T L^T solves
    in two sweeps over the same stored blocks, transposed:

        forward:  z_0 = S_0^{-T} r_0,  z_i = S_i^{-T} (r_i - U_{i-1}^T z_{i-1})
        backward: x_{nb-1} = z_{nb-1},  x_i = z_i - F_{i+1}^T x_{i+1}

    (S_i^{-T} by a pivoted LU solve of S_i^T for ``lu``; JAX
    ``ops/blocktri.py:784-847``).  An ``spd`` factor solves its transpose as
    ``conj(solve(conj(rhs)))`` (T^T = conj(T)); for a real one that is the
    forward solve.  rhs: ``[..., nb, b]`` or
    ``[..., nb, b, r]`` with the factor's leading dims; the result is in
    the sweep precision.  Plain PyTorch: no kernel takes this form."""
    if fact.method == "spd":
        # T = (I + E) S (I + E)^H is Hermitian, so T^T = conj(T)
        return blocktri_solve(fact, rhs.conj()).conj().resolve_conj()
    if fact.method not in ("inv", "lu"):
        raise ValueError(f"unsupported method {fact.method!r}")
    squeeze = rhs.dim() == fact.F.dim() - 1
    if squeeze:
        rhs = rhs[..., None]
    nb, mv = fact.nb, _sweep_matvec

    def tT(a):
        return a.transpose(-1, -2)

    if fact.method == "lu":
        def s_inv_t(i, v):
            return _lu_solve(fact.Slu[..., i, :, :], fact.piv[..., i, :],
                             v.to(sweep_precision(fact.F, v)), trans=True)
    else:
        def s_inv_t(i, v):
            return mv(tT(fact.Sinv[..., i, :, :]), v)

    zs = [s_inv_t(0, rhs[..., 0, :, :])]
    for i in range(1, nb):
        zs.append(s_inv_t(i, rhs[..., i, :, :]
                          - mv(tT(fact.U[..., i - 1, :, :]), zs[-1])))
    xs = [zs[nb - 1]]
    for i in range(nb - 2, -1, -1):
        xs.append(zs[i] - mv(tT(fact.F[..., i + 1, :, :]), xs[-1]))
    x = torch.stack(xs[::-1], dim=-3)
    return x[..., 0] if squeeze else x

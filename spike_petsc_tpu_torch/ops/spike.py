"""SPIKE partitioned banded factorization and solve (PyTorch, single device).

The port of the subset of ``spike_petsc_tpu.ops.spike`` that the flagship
and SPD paths run:

* the band is split into K row partitions, each factored by block-Thomas:
  ``method='inv'`` with the band->block conversion folded into the factor
  loop (``blocktri_factor_inv_waux_band``, K batched), ``method='spd'``
  (symmetric block-LDL^T, F and Sinv only) on materialized blocks;
* the k x k coupling tips B_p (to the next partition) and C_p (to the
  previous one) give the spikes V_p = A_p^{-1} E_bot B_p and
  W_p = A_p^{-1} E_top C_p;
* the reduced interface system is block-tridiagonal with 2k x 2k blocks and
  K-1 block rows, factored by block-Thomas, or, ``truncated``, only its
  diagonal blocks, inverted (exact in the diagonally dominant limit);
* a solve is one partition sweep (on the card ``sweep_route`` picks the
  fused CUDA kernel of the factor's method, or for an ``inv`` partition too
  long for its shared memory the two-pass sweep kernels, which
  ``impl="pallas"`` also names), a reduced solve, and the stored-spike
  correction ``x = g - V xt - W xb`` (or a second sweep when spikes are
  not stored);
* ``spike_solve_many`` does the same for ``[n, r]`` right-hand sides, the
  factors streamed once for all r (the multi-RHS fused kernels on the card);
* ``spike_transpose`` turns a factorization of A into one of A^T on the
  same partition factors: a regular-form ``inv`` factor (from the L blocks
  kept by ``store_lt`` or cut from the band), which the sweep kernels take
  as they take the forward one, or the storage-sharing marker, whose
  transpose sweeps are plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .band import BandedMatrix, pad_banded
from .blocktri import (BlockTridiagonal, BlockTriFactor,
                       TransposedBlockTriFactor, _sweep_matvec,
                       band_to_blocktri, blocktri_factor,
                       blocktri_factor_inv_waux_band, blocktri_solve,
                       blocktri_solve_transpose, cast_factor, sweep_precision,
                       transposed_factor_from_L)
from .cuda.fused_sweep import blocktri_solve_fused_cuda, fused_sweep_feasible
from .cuda.fused_sweep_many import (blocktri_solve_fused_many_cuda,
                                    fused_sweep_many_feasible)
from .cuda.fused_sweep_many_spd import blocktri_solve_fused_many_spd_cuda
from .cuda.fused_sweep_spd import blocktri_solve_fused_spd_cuda
from .cuda.sweeps import blocktri_solve_batched_cuda, sweeps_feasible


@dataclass(frozen=True)
class SpikeFactor:
    """Factorization state for SPIKE solves."""

    fact: BlockTriFactor                  # per-partition factors, leading K
    #                                       (or the transpose marker)
    Btip: torch.Tensor                    # [K, k, k], coupling to next
    Ctip: torch.Tensor                    # [K, k, k], coupling to prev
    red_fact: Optional[BlockTriFactor]    # exact reduced-system factorization
    V: Optional[torch.Tensor]             # [K, nb, b, k] right spikes
    W: Optional[torch.Tensor]             # [K, nb, b, k] left spikes
    n: int                                # original size
    K: int                                # partitions
    m: int                                # padded rows per partition
    b: int                                # block size
    k: int                                # tip size = max(kl, ku)
    red_Dinv: Optional[torch.Tensor] = None   # [K-1, 2k, 2k] truncated
    truncated: bool = False
    # [K, nb, b, b] subdiagonal blocks at the factor's storage dtype
    # (store_lt): the regular-form transpose builds from them
    Lb: Optional[torch.Tensor] = None

    @property
    def nb(self) -> int:
        return self.m // self.b


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not yet ported to spike_petsc_tpu_torch")


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def _partition_geometry(n: int, K: int, kl: int, ku: int,
                        block_b: Optional[int]) -> tuple:
    k = max(kl, ku, 1)
    b = block_b if block_b is not None else max(k, 1)
    if b < k:
        raise ValueError(f"block size {b} must be >= tip size {k}")
    rows = -(-n // K)                      # ceil(n / K)
    m = -(-rows // b) * b                  # rounded up to a multiple of b
    if m < 2 * k and K > 1:
        raise ValueError(
            f"partition rows {m} must be >= 2*k={2*k}; reduce K or bandwidth")
    return k, b, m


def _skew_tip(rows: torch.Tensor, off: int, k: int) -> torch.Tensor:
    """``out[..., r, c] = rows[..., r, off - r + c]`` for ``c in [0, k)``,
    zero where that index leaves ``[0, rows.shape[-1])``."""
    W = rows.shape[-1]
    r = torch.arange(rows.shape[-2], device=rows.device)[:, None]
    c = torch.arange(k, device=rows.device)[None, :]
    idx = off - r + c
    valid = (idx >= 0) & (idx < W)
    idx = idx.clamp(0, W - 1).expand(*rows.shape[:-1], k)
    return torch.where(valid, torch.gather(rows, -1, idx),
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def _extract_tips(data: torch.Tensor, K: int, m: int, k: int, kl: int,
                  ku: int):
    """Pull the k x k coupling corners out of global band storage:

    B_tip[p][r, c] = A[p*m + (m-k) + r, (p+1)*m + c]  (band offset c + k - r)
    C_tip[p][r, c] = A[p*m + r,        (p-1)*m + (m-k) + c]  (offset c - k - r)

    with B_tip[K-1] and C_tip[0] zero (the global boundary)."""
    w = kl + ku + 1
    local = data.reshape(K, m, w)
    Btip = _skew_tip(local[:, m - k:, :], k + kl, k).clone()
    Ctip = _skew_tip(local[:, :k, :], kl - k, k).clone()
    Btip[K - 1] = 0
    Ctip[0] = 0
    return Btip, Ctip


def _spike_bwd_one(f: BlockTriFactor, Bt: torch.Tensor, yw: torch.Tensor,
                   b: int, k: int, dtype):
    """Shared V/W backward sweep given the W forward sweep ``yw
    [K, nb, b, k]`` (fused into the ``inv`` factor loop, or from
    ``_spike_columns``).  The partition axis is a batch dimension, so this
    is also the JAX ``_spike_columns_from_waux`` (a ``vmap`` of
    ``_spike_bwd_one``).  ``spd`` factors store no U: their backward sweep
    reads F^T, as ``blocktri_solve`` does.  Returns ``(V, W)``, each
    ``[K, nb, b, k]``."""
    K, nb = Bt.shape[0], f.nb
    Bb = torch.zeros((K, b, k), dtype=dtype, device=Bt.device)
    Bb[:, b - k:, :] = Bt
    zero = torch.zeros_like(Bb)
    xs = [_sweep_matvec(f.Sinv[:, nb - 1],
                        torch.cat([Bb, yw[:, nb - 1]], dim=-1))]
    for i in range(nb - 2, -1, -1):
        y = torch.cat([zero, yw[:, i]], dim=-1)                 # [K, b, 2k]
        if f.method == "spd":
            xs.append(_sweep_matvec(f.Sinv[:, i], y)
                      - _sweep_matvec(f.F[:, i + 1].transpose(-1, -2),
                                      xs[-1]))
        else:
            xs.append(_sweep_matvec(f.Sinv[:, i],
                                    y - _sweep_matvec(f.U[:, i], xs[-1])))
    x = torch.stack(xs[::-1], dim=1)                            # [K,nb,b,2k]
    return x[..., :k], x[..., k:]


def _spike_columns(f: BlockTriFactor, Btip: torch.Tensor, Ctip: torch.Tensor,
                   b: int, k: int, dtype):
    """Spike columns V = A_p^{-1} E_bot B_p and W = A_p^{-1} E_top C_p for
    ``inv``/``spd`` factors: V's forward sweep is free (its right-hand side
    lives in the last block only), W's is ``y_i = -F_i y_{i-1}`` from the
    C-tip block, and both share one backward sweep (``_spike_bwd_one``)."""
    K = Btip.shape[0]
    y = torch.zeros((K, b, k), dtype=dtype, device=Btip.device)
    y[:, :k, :] = Ctip
    ys = [y]
    for i in range(1, f.nb):
        ys.append(-_sweep_matvec(f.F[:, i], ys[-1]))
    return _spike_bwd_one(f, Btip, torch.stack(ys, dim=1), b, k, dtype)


def _reduced_from_tips(V_top, V_bot, W_top, W_bot, *, truncated: bool,
                       inverter: str, cr_threshold: int = 255):
    """The reduced interface system: K-1 block rows of 2k x 2k,
    D_j = [[I, V_bot_j], [W_top_{j+1}, I]], coupled through W_bot and V_top.
    Returns ``(red_fact, red_Dinv)``: ``truncated`` drops the coupling and
    keeps ``red_Dinv = D^{-1}`` (K-1 independent solves); otherwise an
    ``inv`` block-Thomas factor, whatever the partitions' method (the JAX
    ``reduced_factor`` maps ``spd`` to ``inv``), below ``cr_threshold``
    block rows (cyclic reduction beyond it is not yet ported)."""
    K, k = V_top.shape[0], V_top.shape[1]
    dtype, dev = V_top.dtype, V_top.device
    eye = torch.eye(k, dtype=dtype, device=dev).expand(K - 1, k, k)
    z = torch.zeros((K - 1, k, k), dtype=dtype, device=dev)
    D = torch.cat([torch.cat([eye, V_bot[:-1]], dim=2),
                   torch.cat([W_top[1:], eye], dim=2)], dim=1)
    if truncated:
        eye2 = torch.eye(2 * k, dtype=dtype, device=dev).expand_as(D)
        return None, torch.linalg.solve(D, eye2)
    if K - 1 >= cr_threshold:
        raise _not_ported("cyclic reduction of the reduced system (K > 255)")
    L = torch.cat([torch.cat([W_bot[:-1], z], dim=2),
                   torch.cat([z, z], dim=2)], dim=1)
    L[0] = 0
    U = torch.cat([torch.cat([z, z], dim=2),
                   torch.cat([z, V_top[1:]], dim=2)], dim=1)
    U[K - 2] = 0
    return blocktri_factor(BlockTridiagonal(D=D, L=L, U=U), method="inv",
                           inverter=inverter), None


def _finish_factor(fact, yw, Btip, Ctip, *, n, K, m, b, k, truncated,
                   store_spikes, store_dtype, inverter,
                   spike_dtype, Lb=None) -> SpikeFactor:
    """Factorization tail: spikes -> reduced system -> mixed-precision cast.
    ``yw`` is the W forward sweep from the folded factor loop (None when
    the factor was computed without it); ``Lb`` the L blocks to keep
    (store_lt), cast with the factor."""
    nb = m // b
    V = W = red_fact = red_Dinv = None
    if K > 1:
        dtype = fact.Sinv.dtype
        if yw is None:
            Vfull, Wfull = _spike_columns(fact, Btip, Ctip, b, k, dtype)
        else:
            Vfull, Wfull = _spike_bwd_one(fact, Btip, yw, b, k, dtype)
        red_fact, red_Dinv = _reduced_from_tips(
            Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :],
            Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :],
            truncated=truncated, inverter=inverter)
        if store_spikes:
            V, W = Vfull, Wfull
    if store_dtype is not None:
        fact = cast_factor(fact, store_dtype)
        if V is not None:
            V, W = V.to(store_dtype), W.to(store_dtype)
        if Lb is not None:
            Lb = Lb.to(store_dtype)
    if spike_dtype is not None and V is not None:
        V, W = V.to(spike_dtype), W.to(spike_dtype)
    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
                       V=V, W=W, n=n, K=K, m=m, b=b, k=k, red_Dinv=red_Dinv,
                       truncated=truncated, Lb=Lb)


def spike_factor(band: BandedMatrix, K: int, block_b: Optional[int] = None,
                 method: str = "inv", truncated: bool = False,
                 store_spikes: bool = False, store_dtype=None,
                 reduced: str = "auto", shift: str = "none",
                 shift_amount: float = 0.0, inverter: str = "auto",
                 spike_dtype=None, store_lt: bool = False) -> SpikeFactor:
    """Factor a banded matrix for SPIKE solves over K partitions.

    Same arguments as the JAX ``spike_factor``.  Ported: ``method='inv'``
    and ``method='spd'`` (symmetric block-LDL^T for a symmetric band: F and
    Sinv stored, 2/3 of ``inv``'s factor memory, U blocks ignored), the
    exact block-Thomas reduced system and the ``truncated`` one,
    ``store_spikes``, ``store_dtype``, ``spike_dtype`` and ``store_lt``
    (keep the subdiagonal blocks, ``SpikeFactor.Lb`` at ``store_dtype``, so
    that ``spike_transpose`` builds the regular-form transpose without the
    band; ``method='inv'`` only); the rest raise.
    """
    if method not in ("inv", "spd"):
        raise _not_ported(f"spike_factor(method={method!r})")
    if reduced not in ("auto", "thomas"):
        raise _not_ported(f"spike_factor(reduced={reduced!r})")
    if shift != "none":
        raise _not_ported(f"spike_factor(shift={shift!r})")
    if store_lt and method != "inv":
        raise ValueError(
            "store_lt builds the regular-form transpose factor, which "
            f"needs method='inv' block-Thomas factors (got {method!r})")
    n, kl, ku = band.n, band.kl, band.ku
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    band = pad_banded(band, K * m)
    Btip, Ctip = _extract_tips(band.data, K, m, k, kl, ku)
    if method == "inv" and K > 1:
        # the conversion rides the factor loop, with the W forward sweep
        local = band.data.reshape(K, m // b, b, band.width)
        Cb = torch.zeros((K, b, k), dtype=band.dtype, device=band.device)
        Cb[:, :k, :] = Ctip
        fact, yw, *kept = blocktri_factor_inv_waux_band(
            local, Cb, kl, ku, b, inverter=inverter, keep_l=store_lt)
        Lb = kept[0] if kept else None
    else:
        blocks = _partition_blocks(band, K, m, b)
        fact = blocktri_factor(blocks, method=method, inverter=inverter)
        yw = None
        Lb = blocks.L if store_lt else None
    return _finish_factor(fact, yw, Btip, Ctip, n=n, K=K, m=m, b=b, k=k,
                          truncated=truncated, store_spikes=store_spikes,
                          store_dtype=store_dtype, inverter=inverter,
                          spike_dtype=spike_dtype, Lb=Lb)


def _partition_blocks(band: BandedMatrix, K: int, m: int,
                      b: int) -> BlockTridiagonal:
    """The ``[K, nb, b, b]`` blocks of each partition of a band padded to
    ``K * m`` rows, the couplings that leave a partition (``L[:, 0]``,
    ``U[:, -1]``) zeroed."""
    t = band_to_blocktri(band, b)
    L, D, U = (a.reshape(K, m // b, b, b) for a in (t.L, t.D, t.U))
    L[:, 0] = 0
    U[:, -1] = 0
    return BlockTridiagonal(D=D, L=L, U=U)


def _batched_tri_solve(fact, rhs: torch.Tensor) -> torch.Tensor:
    """The plain per-partition solve of ``rhs [K, nb, b(, r)]``,
    dispatching on the factor type: the transpose marker to
    ``blocktri_solve_transpose`` on its base, a block-Thomas factor to
    ``blocktri_solve``."""
    if isinstance(fact, TransposedBlockTriFactor):
        return blocktri_solve_transpose(fact.base, rhs)
    return blocktri_solve(fact, rhs)


def spike_transpose(sf: SpikeFactor, reduced: str = "auto",
                    inverter: str = "auto",
                    store_spikes: Optional[bool] = None,
                    band: Optional[BandedMatrix] = None,
                    fast: bool = True) -> SpikeFactor:
    """SPIKE factorization of A^T REUSING A's partition factors: no band
    transpose, no new block inversions.  The result solves A^T x = rhs
    through the ordinary ``spike_solve``/``spike_solve_many`` (PETSc
    MatSolveTranspose / PCApplyTranspose).

    The partition factors, in preference order (``fast=True``):

    * from ``sf.Lb`` (``spike_factor(store_lt=True)``): the REGULAR-form
      ``inv`` factor of ``transposed_factor_from_L``, which the sweep
      kernels take as they take the forward factor;
    * from ``band``, the ORIGINAL band: the same, its L blocks cut with
      the forward factor's K and m (on the card a PC's default block moves
      the partition boundaries, so they are never recomputed);
    * otherwise (or ``fast=False``) the storage-sharing
      ``TransposedBlockTriFactor`` marker, whose sweeps are plain PyTorch.

    The coupling tips swap and transpose (A^T couples partition p forward
    through C_{p+1}^T and backward through B_{p-1}^T); the transpose
    spikes are one plain batched solve of their 2k columns, and the
    reduced system is rebuilt from their tips with ``inverter`` (pass the
    forward factor's resolved one).  ``store_spikes``: None keeps V/W iff
    the forward factor did.  A real ``spd`` factorization is its own
    transpose and comes back as is."""
    if not isinstance(sf.fact, BlockTriFactor):
        raise ValueError(
            "spike_transpose requires block-Thomas partition factors "
            f"(got {type(sf.fact).__name__}); refactor with method='inv'")
    if reduced not in ("auto", "thomas"):
        raise _not_ported(f"spike_transpose(reduced={reduced!r})")
    K, nb, b, k = sf.K, sf.nb, sf.b, sf.k
    dtype = sf.Btip.dtype
    if sf.fact.method == "spd":
        if dtype.is_complex:
            raise _not_ported("spike_transpose of complex Hermitian 'spd' "
                              "factors")
        return sf
    if fast and (sf.Lb is not None or band is not None):
        L = sf.Lb if sf.Lb is not None else _partition_blocks(
            pad_banded(band, K * sf.m), K, sf.m, b).L
        factT = transposed_factor_from_L(sf.fact, L)
    else:
        factT = TransposedBlockTriFactor(sf.fact)
    zk = torch.zeros((1, k, k), dtype=dtype, device=sf.Btip.device)
    Btip_t = torch.cat([sf.Ctip[1:].transpose(-1, -2), zk]).contiguous()
    Ctip_t = torch.cat([zk, sf.Btip[:-1].transpose(-1, -2)]).contiguous()
    common = dict(n=sf.n, K=K, m=sf.m, b=b, k=k, truncated=sf.truncated)
    if K == 1:
        return SpikeFactor(fact=factT, Btip=Btip_t, Ctip=Ctip_t,
                           red_fact=None, V=None, W=None, **common)
    # V's right-hand side lives in the last block, W's in the first: one
    # solve of both, 2k columns
    rhs = torch.zeros((K, nb, b, 2 * k), dtype=dtype,
                      device=sf.Btip.device)
    rhs[:, nb - 1, b - k:, :k] = Btip_t
    rhs[:, 0, :k, k:] = Ctip_t
    VW = _batched_tri_solve(factT, rhs)
    Vt, Wt = VW[..., :k], VW[..., k:]
    red_fact, red_Dinv = _reduced_from_tips(
        Vt[:, 0, :k, :], Vt[:, nb - 1, b - k:, :],
        Wt[:, 0, :k, :], Wt[:, nb - 1, b - k:, :],
        truncated=sf.truncated, inverter=inverter)
    keep = (sf.V is not None) if store_spikes is None else store_spikes
    V = W = None
    if keep:
        sdt = sf.V.dtype if sf.V is not None else Vt.dtype
        V, W = Vt.contiguous().to(sdt), Wt.contiguous().to(sdt)
    return SpikeFactor(fact=factT, Btip=Btip_t, Ctip=Ctip_t,
                       red_fact=red_fact, red_Dinv=red_Dinv, V=V, W=W,
                       **common)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------

def _reduced_solve(sf: SpikeFactor, g_bot: torch.Tensor, g_top: torch.Tensor):
    """Solve for interface unknowns; ``g_bot``/``g_top`` are ``[K, k]`` or
    ``[K, k, r]``.  Returns (xbot_prev, xtop_next) of the same shape:
    xtop_next[p] = x_{p+1}^top (zero for p = K-1),
    xbot_prev[p] = x_{p-1}^bot (zero for p = 0)."""
    k = sf.k
    rhs = torch.cat([g_bot[:-1], g_top[1:]], dim=1)          # [K-1, 2k(, r)]
    if sf.truncated:
        cols = rhs.dim() == 3
        z = _sweep_matvec(sf.red_Dinv, rhs if cols else rhs[..., None])
        z = z if cols else z[..., 0]
    else:
        z = blocktri_solve(sf.red_fact, rhs)
    zk = torch.zeros_like(z[:1, :k])
    xtop_next = torch.cat([z[:, k:], zk], dim=0)
    xbot_prev = torch.cat([zk, z[:, :k]], dim=0)
    return xbot_prev, xtop_next


# the fused sweep kernel of each factor method, single and multi-RHS
_SWEEPS = {"inv": blocktri_solve_fused_cuda,
           "spd": blocktri_solve_fused_spd_cuda}
_SWEEPS_MANY = {"inv": blocktri_solve_fused_many_cuda,
                "spd": blocktri_solve_fused_many_spd_cuda}


# the JAX package's impl names: 'xla' is the plain sweep, 'pallas_fused' the
# fused kernels; 'pallas' (the two-pass sweeps of a single RHS, the fused
# kernel of many) is resolved by the callers
_IMPLS = ("auto", "cuda", "plain", "xla", "pallas", "pallas_fused")
_JAX_NAMES = {"xla": "plain", "pallas_fused": "cuda"}


def _require_inv_factors(sf: SpikeFactor, impl: str) -> None:
    """The kernels take block-Thomas factors only: ``impl='pallas'``
    ``method='inv'`` ones, the fused kernels (``'cuda'``,
    ``'pallas_fused'``) ``inv`` or ``spd`` ones; the transpose marker none,
    as in JAX."""
    ok = ("inv", "spd") if impl in ("cuda", "pallas_fused") else ("inv",)
    if not (isinstance(sf.fact, BlockTriFactor) and sf.fact.method in ok):
        got = (f"method={sf.fact.method!r}"
               if isinstance(sf.fact, BlockTriFactor)
               else type(sf.fact).__name__)
        raise ValueError(
            f"impl={impl!r} requires method={'/'.join(ok)!r} block-Thomas "
            f"factors; got {got} (use impl='xla', or refactor with "
            "spike_factor(..., method='inv'), or build the regular-form "
            "transpose: spike_transpose(sf, band=...) or store_lt)")


def sweep_route(fact, b: int, rhs_dtype, on_cuda: bool,
                many: bool = False) -> str:
    """The partition sweep ``impl='auto'`` runs: ``"fused"`` (the fused
    kernel of the factor's method: #1 for ``inv``, #3 for ``spd``; #4 and #5
    with ``many``), ``"sweeps"`` (the two-pass kernels #9, single RHS,
    ``inv`` factors) or ``"plain"``.  A CPU right-hand side takes the plain
    sweep.  On the card, ``spd`` factors take their fused kernel, which
    raises where its rule refuses them; ``inv`` factors take #1 where its
    rule admits them, else #9 where its rule does (any nb, so a long single
    partition), else the plain sweep: only f64 factors or a block outside
    64 and 128 come there, and no multi-RHS two-pass kernel exists.  A
    regular-form transpose is an ``inv`` factor and routes as one; the
    transpose marker takes the plain transpose sweeps."""
    if not on_cuda or isinstance(fact, TransposedBlockTriFactor):
        return "plain"
    if fact.method == "spd":
        return "fused"
    fused = fused_sweep_many_feasible if many else fused_sweep_feasible
    if fused(fact, b, rhs_dtype):
        return "fused"
    if not many and sweeps_feasible(fact, b, rhs_dtype):
        return "sweeps"
    return "plain"


def _batched_solver(sf: SpikeFactor, impl: str, rhs: torch.Tensor,
                    many: bool = False):
    """The partition sweep ``r -> x`` for ``sf``'s factor method.  'auto'
    takes the route of :func:`sweep_route`, as the JAX dispatch takes its
    Pallas kernels on the TPU.  The JAX names ``xla`` and ``pallas_fused``
    mean ``plain`` and ``cuda``.  The transpose marker runs the plain
    transpose sweeps under 'auto' and 'plain', and raises under 'cuda'."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}: expected "
                         f"{', '.join(_IMPLS)}")
    impl = _JAX_NAMES.get(impl, impl)
    if isinstance(sf.fact, TransposedBlockTriFactor):
        if impl == "cuda":
            _require_inv_factors(sf, impl)
        return lambda r: _batched_tri_solve(sf.fact, r)
    solve = (_SWEEPS_MANY if many else _SWEEPS)[sf.fact.method]
    if impl == "auto":
        route = sweep_route(sf.fact, sf.b, rhs.dtype, rhs.is_cuda, many=many)
        if route == "sweeps":
            return lambda r: blocktri_solve_batched_cuda(sf.fact, r)
        impl = "cuda" if route == "fused" else "plain"
    return lambda r: solve(sf.fact, r, impl=impl)


def spike_solve(sf: SpikeFactor, rhs: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """Solve A x = rhs with a SPIKE factorization.  rhs: [n].

    impl: "auto" (on a CUDA tensor the route of :func:`sweep_route`: for
    ``inv`` factors #1 where its rule admits them, else the two-pass #9
    where its rule does, else plain; #3 for ``spd``, raising where it does
    not apply), "cuda" (the fused kernel; raises where it
    does not apply), "plain" (the plain PyTorch sweeps on any device), or
    the JAX names: "xla" (plain), "pallas_fused" (cuda) and "pallas" (the
    two-pass sweep kernels #9 of ``ops/cuda/sweeps.py``, one launch per
    sweep; ``inv`` factors only, raising on the card where their rule
    refuses the factors).
    """
    K, m, b, k, nb = sf.K, sf.m, sf.b, sf.k, sf.nb
    rp = torch.zeros(K * m, dtype=rhs.dtype, device=rhs.device)
    rp[:sf.n] = rhs
    rblk = rp.reshape(K, nb, b)
    if impl == "pallas":
        _require_inv_factors(sf, impl)

        def batched_solve(r):
            return blocktri_solve_batched_cuda(sf.fact, r)
    else:
        batched_solve = _batched_solver(sf, impl, rhs)

    g = batched_solve(rblk)                                  # [K, nb, b]
    if K == 1:
        return g.reshape(-1)[:sf.n]

    xbot_prev, xtop_next = _reduced_solve(sf, g[:, nb - 1, b - k:],
                                          g[:, 0, :k])
    if sf.V is not None:
        # one sweep: x = g - V x_{p+1}^top - W x_{p-1}^bot
        dtype = sweep_precision(sf.V, g)
        x = (g - torch.einsum("pnbk,pk->pnb", sf.V.to(dtype),
                              xtop_next.to(dtype))
             - torch.einsum("pnbk,pk->pnb", sf.W.to(dtype),
                            xbot_prev.to(dtype)))
    else:
        # recompute sweep: solve with the boundary-corrected rhs
        dtype = sweep_precision(sf.Btip, g)
        corrB = torch.einsum("prc,pc->pr", sf.Btip.to(dtype),
                             xtop_next.to(dtype))
        corrC = torch.einsum("prc,pc->pr", sf.Ctip.to(dtype),
                             xbot_prev.to(dtype))
        r2 = rblk.clone()
        r2[:, nb - 1, b - k:] -= corrB.to(r2.dtype)
        r2[:, 0, :k] -= corrC.to(r2.dtype)
        x = batched_solve(r2)
    return x.reshape(-1)[:sf.n]


def spike_solve_many(sf: SpikeFactor, rhs: torch.Tensor,
                     impl: str = "auto") -> torch.Tensor:
    """Blocked multi-RHS solve; rhs ``[n, r]`` -> x ``[n, r]``.

    One batched sweep streams the factors once for all r columns (the
    serving path), then the reduced solve on ``[K-1, 2k, r]`` and the
    stored-spike correction ``g - V xt - W xb`` as batched products (or a
    second sweep when spikes are not stored).  The correction promotes
    bf16 spikes to the f32-or-wider sweep precision, so an f32 solve carries
    f32 throughout.

    impl: "auto" (on a CUDA tensor the multi-RHS CUDA kernel of the
    factor's method: #4 for ``inv`` whenever its feasibility rule admits
    the factors, else plain; #5 for ``spd``, raising where its rule refuses
    them), "cuda" (the kernel; raises where it does not apply), or "plain";
    and the JAX names "xla" (plain), "pallas_fused" (cuda) and "pallas"
    (the multi-RHS kernel, as in JAX, for ``inv`` factors only).  The JAX
    dispatch's switch to XLA at large r is a TPU VMEM measurement and is
    not carried over.
    """
    K, m, b, k, nb = sf.K, sf.m, sf.b, sf.k, sf.nb
    r = rhs.shape[1]
    rp = torch.zeros((K * m, r), dtype=rhs.dtype, device=rhs.device)
    rp[:sf.n] = rhs
    rblk = rp.reshape(K, nb, b, r)
    if impl == "pallas":
        _require_inv_factors(sf, impl)
        impl = "cuda"
    batched_solve = _batched_solver(sf, impl, rhs, many=True)

    g = batched_solve(rblk)                                  # [K, nb, b, r]
    if K == 1:
        return g.reshape(K * m, r)[:sf.n]

    xbot_prev, xtop_next = _reduced_solve(sf, g[:, nb - 1, b - k:, :],
                                          g[:, 0, :k, :])    # [K, k, r]
    if sf.V is not None:
        dtype = sweep_precision(sf.V, g)
        x = (g - sf.V.to(dtype) @ xtop_next.to(dtype)[:, None]
             - sf.W.to(dtype) @ xbot_prev.to(dtype)[:, None])
    else:
        dtype = sweep_precision(sf.Btip, g)
        corrB = sf.Btip.to(dtype) @ xtop_next.to(dtype)      # [K, k, r]
        corrC = sf.Ctip.to(dtype) @ xbot_prev.to(dtype)
        r2 = rblk.clone()
        r2[:, nb - 1, b - k:, :] -= corrB.to(r2.dtype)
        r2[:, 0, :k, :] -= corrC.to(r2.dtype)
        x = batched_solve(r2)
    return x.reshape(K * m, r)[:sf.n]

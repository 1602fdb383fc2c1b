"""SPIKE partitioned banded factorization and solve (PyTorch, single device).

The port of ``spike_petsc_tpu.ops.spike``:

* the band is split into K row partitions, each factored by block-Thomas:
  ``method='inv'`` with the band->block conversion folded into the factor
  loop (``blocktri_factor_inv_waux_band``, K batched) or, with a pivot
  shift, on materialized blocks (``blocktri_factor_inv_waux``);
  ``method='spd'`` (symmetric block-LDL^T, F and Sinv only) and
  ``method='lu'`` (pivoted LU of each Schur complement) on materialized
  blocks; or by cyclic reduction (``method='cr'``, ``ops/cyclic.py``);
  ``shift='nonzero'`` guards every pivot block (``blocktri.boost_diag``);
* the k x k coupling tips B_p (to the next partition) and C_p (to the
  previous one) give the spikes V_p = A_p^{-1} E_bot B_p and
  W_p = A_p^{-1} E_top C_p;
* the reduced interface system is block-tridiagonal with 2k x 2k blocks and
  K-1 block rows, factored by block-Thomas (``lu`` for ``lu`` partitions,
  else ``inv``) or by cyclic reduction (K - 1 >= 255 block rows,
  ``reduced='cr'``, or ``cr`` partitions), or, ``truncated``, only its
  diagonal blocks, inverted (exact in the diagonally dominant limit);
* ``spike_factor_blocks`` factors a band already assembled as global
  blocks, and ``spike_factor_grouped`` factors the partitions a group at a
  time, for its peak memory;
* a solve is one partition sweep (on the card ``sweep_route`` picks the
  fused CUDA kernel of the factor's method, or for an ``inv`` partition too
  long for its shared memory the two-pass sweep kernels, which
  ``impl="pallas"`` also names; ``lu`` and CR factors, which no kernel
  takes, the plain sweeps), a reduced solve, and the stored-spike
  correction ``x = g - V xt - W xb`` (or a second sweep when spikes are
  not stored), each in its span (``SPIKESweep``, ``SPIKEReduced``,
  ``SPIKECorrect``; ``utils.profiling.span``);
* ``spike_solve_many`` does the same for ``[n, r]`` right-hand sides, the
  factors streamed once for all r (the multi-RHS fused kernels on the card);
* ``spike_transpose`` turns a factorization of A into one of A^T on the
  same partition factors: a regular-form ``inv`` factor (from the L blocks
  kept by ``store_lt`` or cut from the band), which the sweep kernels take
  as they take the forward one, or the storage-sharing marker (``lu``
  factors always), whose transpose sweeps are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch

from .band import BandedMatrix, pad_banded
from .blocktri import (BlockTridiagonal, BlockTriFactor,
                       TransposedBlockTriFactor, _sweep_matvec,
                       band_to_blocktri, blocktri_factor,
                       blocktri_factor_inv_waux,
                       blocktri_factor_inv_waux_band, blocktri_solve,
                       blocktri_solve_transpose, cast_factor, lapack_inv,
                       sweep_precision, transposed_factor_from_L)
from .cyclic import CRFactor, cast_cr_factor, cr_factor, cr_solve
from .cuda.fused_sweep import blocktri_solve_fused_cuda, fused_sweep_feasible
from .cuda.fused_sweep_many import (blocktri_solve_fused_many_cuda,
                                    fused_sweep_many_feasible)
from .cuda.fused_sweep_many_spd import blocktri_solve_fused_many_spd_cuda
from .cuda.fused_sweep_spd import blocktri_solve_fused_spd_cuda
from .cuda.reduced_thomas import (blocktri_solve_reduced_cuda,
                                  reduced_thomas_feasible)
from .cuda.sweeps import blocktri_solve_batched_cuda, sweeps_feasible
from ..utils.profiling import span


@dataclass(frozen=True)
class SpikeFactor:
    """Factorization state for SPIKE solves."""

    # per-partition factors, leading K: block-Thomas, CR, or the
    # transpose marker
    fact: Union[BlockTriFactor, CRFactor, TransposedBlockTriFactor]
    Btip: torch.Tensor                    # [K, k, k], coupling to next
    Ctip: torch.Tensor                    # [K, k, k], coupling to prev
    # exact reduced-system factorization (block-Thomas or CR)
    red_fact: Optional[Union[BlockTriFactor, CRFactor]]
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
                  ku: int, zero_boundaries: bool = True):
    """Pull the k x k coupling corners out of global band storage:

    B_tip[p][r, c] = A[p*m + (m-k) + r, (p+1)*m + c]  (band offset c + k - r)
    C_tip[p][r, c] = A[p*m + r,        (p-1)*m + (m-k) + c]  (offset c - k - r)

    with B_tip[K-1] and C_tip[0] zero (the global boundary), unless
    ``zero_boundaries`` is off: a group of partitions cut from the middle of
    the band keeps its outward tips (``spike_factor_grouped``)."""
    w = kl + ku + 1
    local = data.reshape(K, m, w)
    Btip = _skew_tip(local[:, m - k:, :], k + kl, k).clone()
    Ctip = _skew_tip(local[:, :k, :], kl - k, k).clone()
    if zero_boundaries:
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
    reads F^H, as ``blocktri_solve`` does.  Returns ``(V, W)``, each
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
                      - _sweep_matvec(f.F[:, i + 1].mH, xs[-1]))
        else:
            xs.append(_sweep_matvec(f.Sinv[:, i],
                                    y - _sweep_matvec(f.U[:, i], xs[-1])))
    x = torch.stack(xs[::-1], dim=1)                            # [K,nb,b,2k]
    return x[..., :k], x[..., k:]


def _spike_columns(f, Btip: torch.Tensor, Ctip: torch.Tensor, nb: int,
                   b: int, k: int, dtype):
    """Spike columns V = A_p^{-1} E_bot B_p and W = A_p^{-1} E_top C_p.

    For ``inv``/``spd`` factors V's forward sweep is free (its right-hand
    side lives in the last block only), W's is ``y_i = -F_i y_{i-1}`` from
    the C-tip block, and both share one backward sweep
    (``_spike_bwd_one``).  Other factors (``lu``, CR) take one plain batched
    solve of both right-hand sides, 2k columns (JAX solves them one after
    the other: the same columns, the same arithmetic)."""
    K = Btip.shape[0]
    if not (isinstance(f, BlockTriFactor) and f.method in ("inv", "spd")):
        rhs = torch.zeros((K, nb, b, 2 * k), dtype=dtype, device=Btip.device)
        rhs[:, nb - 1, b - k:, :k] = Btip
        rhs[:, 0, :k, k:] = Ctip
        VW = _batched_tri_solve(f, rhs)
        return VW[..., :k], VW[..., k:]
    y = torch.zeros((K, b, k), dtype=dtype, device=Btip.device)
    y[:, :k, :] = Ctip
    ys = [y]
    for i in range(1, f.nb):
        ys.append(-_sweep_matvec(f.F[:, i], ys[-1]))
    return _spike_bwd_one(f, Btip, torch.stack(ys, dim=1), b, k, dtype)


_REDUCED = ("auto", "thomas", "cr")


def reduced_factor(red: BlockTridiagonal, method: str, reduced: str = "auto",
                   inverter: str = "auto", cr_threshold: int = 33):
    """Factor the SPIKE reduced interface system (JAX
    ``ops/spike.py:138-159``).  ``reduced``: "thomas" (block-Thomas),
    "cr" (cyclic reduction, ``ops/cyclic.py``: log2(K) levels of batched
    products instead of a loop over K - 1 block rows), or "auto" (CR when
    the system has >= ``cr_threshold`` block rows or the partitions are
    factored by CR).  Block-Thomas takes ``method`` for ``inv`` and ``lu``
    and ``inv`` otherwise.  The SPIKE factor passes ``cr_threshold=255``."""
    if reduced not in _REDUCED:
        raise ValueError(f"unknown reduced {reduced!r}: expected "
                         f"{', '.join(_REDUCED)}")
    if reduced == "cr" or method == "cr" or (
            reduced == "auto" and red.nb >= cr_threshold):
        return cr_factor(red, inverter=inverter)
    return blocktri_factor(red, method=method if method in ("inv", "lu")
                           else "inv", inverter=inverter)


def _reduced_from_tips(V_top, V_bot, W_top, W_bot, *, truncated: bool,
                       inverter: str, method: str = "inv",
                       reduced: str = "auto", cr_threshold: int = 255):
    """The reduced interface system: K-1 block rows of 2k x 2k,
    D_j = [[I, V_bot_j], [W_top_{j+1}, I]], coupled through W_bot and V_top.
    Returns ``(red_fact, red_Dinv)``: ``truncated`` drops the coupling and
    keeps ``red_Dinv = D^{-1}`` (K-1 independent solves); otherwise the
    factor of :func:`reduced_factor` (cyclic reduction from
    ``cr_threshold`` block rows on, JAX ``ops/spike.py:461-487``)."""
    K, k = V_top.shape[0], V_top.shape[1]
    dtype, dev = V_top.dtype, V_top.device
    eye = torch.eye(k, dtype=dtype, device=dev).expand(K - 1, k, k)
    z = torch.zeros((K - 1, k, k), dtype=dtype, device=dev)
    D = torch.cat([torch.cat([eye, V_bot[:-1]], dim=2),
                   torch.cat([W_top[1:], eye], dim=2)], dim=1)
    if truncated:
        return None, lapack_inv(D)
    L = torch.cat([torch.cat([W_bot[:-1], z], dim=2),
                   torch.cat([z, z], dim=2)], dim=1)
    L[0] = 0
    U = torch.cat([torch.cat([z, z], dim=2),
                   torch.cat([z, V_top[1:]], dim=2)], dim=1)
    U[K - 2] = 0
    return reduced_factor(BlockTridiagonal(D=D, L=L, U=U), method, reduced,
                          inverter=inverter, cr_threshold=cr_threshold), None


_METHODS = ("inv", "spd", "lu", "cr")


def _check_options(method: str, store_lt: bool) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}: expected "
                         f"{', '.join(_METHODS)}")
    if store_lt and method != "inv":
        raise ValueError(
            "store_lt builds the regular-form transpose factor, which "
            f"needs method='inv' block-Thomas factors (got {method!r})")


def _factor_partitions(blocks: BlockTridiagonal, Ctip: torch.Tensor, *,
                       method, shift, shift_amount, inverter, b, k):
    """The partition factors of materialized ``[K, nb, b, b]`` blocks and,
    for ``inv`` with K > 1, the W forward sweep carried along (JAX
    ``_finish_factor``, ``ops/spike.py:256-277``).  Returns ``(fact,
    yw)``, ``yw`` None where the factor was computed without it."""
    kw = dict(shift=shift, shift_amount=shift_amount, inverter=inverter)
    if method == "cr":
        return cr_factor(blocks, **kw), None
    K = Ctip.shape[0]
    if method == "inv" and K > 1:
        Cb = torch.zeros((K, b, k), dtype=blocks.dtype,
                         device=blocks.D.device)
        Cb[:, :k, :] = Ctip
        return blocktri_factor_inv_waux(blocks, Cb, **kw)
    return blocktri_factor(blocks, method=method, **kw), None


def _spikes(fact, yw, Btip, Ctip, nb, b, k):
    """Full V and W spikes ``[K, nb, b, k]``."""
    if yw is not None:
        return _spike_bwd_one(fact, Btip, yw, b, k, Btip.dtype)
    return _spike_columns(fact, Btip, Ctip, nb, b, k, Btip.dtype)


def _tips_of(Vfull, Wfull, nb, b, k):
    """(V_top, V_bot, W_top, W_bot): the spikes' interface rows."""
    return (Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :],
            Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :])


def _cast_stored(fact, V, W, Lb, store_dtype, spike_dtype):
    """The mixed-precision cast of the stored state: factors, spikes and
    kept L blocks to ``store_dtype``, then the spikes to ``spike_dtype``
    (``lu`` factors refuse a ``store_dtype``, as in JAX)."""
    if store_dtype is not None:
        fact = (cast_cr_factor if isinstance(fact, CRFactor)
                else cast_factor)(fact, store_dtype)
        if V is not None:
            V, W = V.to(store_dtype), W.to(store_dtype)
        if Lb is not None:
            Lb = Lb.to(store_dtype)
    if spike_dtype is not None and V is not None:
        V, W = V.to(spike_dtype), W.to(spike_dtype)
    return fact, V, W, Lb


def _finish_factor(fact, yw, Btip, Ctip, *, n, K, m, b, k, method,
                   truncated, store_spikes, store_dtype, reduced, inverter,
                   spike_dtype, Lb=None) -> SpikeFactor:
    """Factorization tail: spikes -> reduced system -> mixed-precision cast.
    ``yw`` is the W forward sweep carried by the ``inv`` factor loop (None
    when the factor was computed without it); ``Lb`` the L blocks to keep
    (store_lt), cast with the factor."""
    nb = m // b
    V = W = red_fact = red_Dinv = None
    if K > 1:
        Vfull, Wfull = _spikes(fact, yw, Btip, Ctip, nb, b, k)
        red_fact, red_Dinv = _reduced_from_tips(
            *_tips_of(Vfull, Wfull, nb, b, k), truncated=truncated,
            method=method, reduced=reduced, inverter=inverter)
        if store_spikes:
            V, W = Vfull, Wfull
    fact, V, W, Lb = _cast_stored(fact, V, W, Lb, store_dtype, spike_dtype)
    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
                       V=V, W=W, n=n, K=K, m=m, b=b, k=k, red_Dinv=red_Dinv,
                       truncated=truncated, Lb=Lb)


def spike_factor(band: BandedMatrix, K: int, block_b: Optional[int] = None,
                 method: str = "inv", truncated: bool = False,
                 store_spikes: bool = False, store_dtype=None,
                 reduced: str = "auto", shift: str = "none",
                 shift_amount: float = 0.0, inverter: str = "auto",
                 spike_dtype=None, store_lt: bool = False) -> SpikeFactor:
    """Factor a banded matrix for SPIKE solves over K partitions (JAX
    ``ops/spike.py:588-647``, the same arguments).

    ``method``: ``'inv'`` (block-Thomas with stored Schur inverses),
    ``'lu'`` (pivoted LU factors of the Schur complements), ``'cr'`` (cyclic
    reduction) or ``'spd'`` (symmetric block-LDL^T for a symmetric band: F
    and Sinv stored, 2/3 of ``inv``'s factor memory, U blocks ignored).
    ``reduced``: the reduced system by ``'thomas'``, ``'cr'``, or
    ``'auto'`` (CR when K - 1 >= 255, or for ``cr`` partitions).
    ``shift='nonzero'`` raises small pivots of every partition's Schur
    complements (``blocktri.boost_diag``, floor ``shift_amount`` or, where
    it is <= 0, 1e-8 of the partition's largest block entry); the count is
    ``fact.nshift`` ``[K]``.  The band->block conversion rides the ``inv``
    factor loop where K > 1 and there is no shift; a shift materializes the
    blocks (its default floor needs their maximum).  ``truncated``,
    ``store_spikes``, ``store_dtype`` (not for ``lu``), ``spike_dtype`` and
    ``store_lt`` (keep the subdiagonal blocks, ``SpikeFactor.Lb`` at
    ``store_dtype``, so that ``spike_transpose`` builds the regular-form
    transpose without the band; ``method='inv'`` only) as in JAX.
    """
    _check_options(method, store_lt)
    n, kl, ku = band.n, band.kl, band.ku
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    band = pad_banded(band, K * m)
    Btip, Ctip = _extract_tips(band.data, K, m, k, kl, ku)
    if method == "inv" and K > 1 and shift == "none":
        # the conversion rides the factor loop, with the W forward sweep
        local = band.data.reshape(K, m // b, b, band.width)
        Cb = torch.zeros((K, b, k), dtype=band.dtype, device=band.device)
        Cb[:, :k, :] = Ctip
        fact, yw, *kept = blocktri_factor_inv_waux_band(
            local, Cb, kl, ku, b, inverter=inverter, keep_l=store_lt)
        Lb = kept[0] if kept else None
    else:
        blocks = _partition_blocks(band, K, m, b)
        fact, yw = _factor_partitions(
            blocks, Ctip, method=method, shift=shift,
            shift_amount=shift_amount, inverter=inverter, b=b, k=k)
        Lb = blocks.L if store_lt else None
    return _finish_factor(fact, yw, Btip, Ctip, n=n, K=K, m=m, b=b, k=k,
                          method=method, truncated=truncated,
                          store_spikes=store_spikes, store_dtype=store_dtype,
                          reduced=reduced, inverter=inverter,
                          spike_dtype=spike_dtype, Lb=Lb)


def spike_factor_blocks(T: BlockTridiagonal, n: int, K: int, kl: int,
                        ku: int, method: str = "inv",
                        truncated: bool = False, store_spikes: bool = False,
                        store_dtype=None, reduced: str = "auto",
                        shift: str = "none", shift_amount: float = 0.0,
                        inverter: str = "auto", spike_dtype=None,
                        store_lt: bool = False) -> SpikeFactor:
    """Factor a banded matrix already assembled as GLOBAL block-tridiagonal
    blocks ``T`` (``[NB, b, b]``, p-major; JAX ``ops/spike.py:352-400``):
    the partitions are a reshape, the coupling tips the corners of the
    blocks that cross a partition boundary, and no band->block conversion
    runs.

    ``NB`` must be divisible by K and rows beyond ``n`` must be
    unit-diagonal padding; the band structure (kl, ku <= b) must hold, the
    coupling blocks carrying entries only in their band corners.  ``n`` is
    the true size (solves return ``[n]``); kl, ku set the tip size.  The
    other options as in :func:`spike_factor`."""
    NB, b = T.nb, T.b
    k = max(kl, ku, 1)
    if kl > b or ku > b:
        raise ValueError(f"block size {b} must cover half-bandwidths "
                         f"(kl={kl}, ku={ku})")
    if NB % K:
        raise ValueError(f"block count {NB} must be divisible by K={K}")
    nb = NB // K
    if nb * b < 2 * k and K > 1:
        raise ValueError(
            f"partition rows {nb * b} must be >= 2*k={2 * k}; "
            f"reduce K or bandwidth")
    _check_options(method, store_lt)
    Dr, Lr, Ur = (a.reshape(K, nb, b, b) for a in (T.D, T.L, T.U))
    Btip = Ur[:, nb - 1, b - k:, :k].clone()
    Ctip = Lr[:, 0, :k, b - k:].clone()
    Btip[K - 1] = 0
    Ctip[0] = 0
    L, U = Lr.clone(), Ur.clone()
    L[:, 0] = 0
    U[:, nb - 1] = 0
    blocks = BlockTridiagonal(D=Dr, L=L, U=U)
    fact, yw = _factor_partitions(blocks, Ctip, method=method, shift=shift,
                                  shift_amount=shift_amount,
                                  inverter=inverter, b=b, k=k)
    return _finish_factor(fact, yw, Btip, Ctip, n=n, K=K, m=nb * b, b=b, k=k,
                          method=method, truncated=truncated,
                          store_spikes=store_spikes, store_dtype=store_dtype,
                          reduced=reduced, inverter=inverter,
                          spike_dtype=spike_dtype,
                          Lb=L if store_lt else None)


def _into(out, piece, g: int, Kg: int, K: int):
    """Write group ``g``'s state ``piece`` (leading dim Kg) into the full-K
    ``out`` (allocated from the first piece when ``out`` is None), field by
    field through the factor dataclasses; what is not a tensor (None, a
    method name, CR's block counts) is taken as it is."""
    if isinstance(piece, tuple):
        return tuple(_into(o, p, g, Kg, K)
                     for o, p in zip(out or (None,) * len(piece), piece))
    if dataclasses.is_dataclass(piece):
        return type(piece)(**{
            f.name: _into(None if out is None else getattr(out, f.name),
                          getattr(piece, f.name), g, Kg, K)
            for f in dataclasses.fields(piece)})
    if not isinstance(piece, torch.Tensor):
        return piece
    if out is None:
        out = piece.new_zeros((K, *piece.shape[1:]))
    out[g * Kg:(g + 1) * Kg] = piece
    return out


def spike_factor_grouped(band: BandedMatrix, K: int, groups: int,
                         block_b: Optional[int] = None, method: str = "inv",
                         truncated: bool = False, store_spikes: bool = False,
                         store_dtype=None, reduced: str = "auto",
                         shift: str = "none", shift_amount: float = 0.0,
                         inverter: str = "auto", spike_dtype=None,
                         store_lt: bool = False) -> SpikeFactor:
    """:func:`spike_factor` with the partitions factored in ``groups``
    groups of K / groups, one after the other (JAX ``ops/spike.py:490-578``).

    **The point is the peak memory.**  Partitions are independent, so each
    group's full-precision working set (the block conversion, the factor
    loop, the spike sweeps) is freed before the next group runs, and the
    results are written into full-K buffers allocated once: the peak is the
    final factor storage plus one group's working set, instead of all the
    partitions' working sets at once.  The groups are cut from the
    original band (only the last one is padded), each group's outward tips
    kept but the global ones zeroed; the reduced system is built from all
    the groups' spike tips at the end.  The result equals
    :func:`spike_factor`'s up to summation order (the per-partition
    arithmetic is the same; the ``inv`` partitions are factored on
    materialized blocks, as a shifted :func:`spike_factor` factors them).
    """
    if groups < 1 or K % groups:
        raise ValueError(f"groups={groups} must divide K={K}")
    _check_options(method, store_lt)
    if groups == 1 or K == 1:
        return spike_factor(band, K, block_b=block_b, method=method,
                            truncated=truncated, store_spikes=store_spikes,
                            store_dtype=store_dtype, reduced=reduced,
                            shift=shift, shift_amount=shift_amount,
                            inverter=inverter, spike_dtype=spike_dtype,
                            store_lt=store_lt)
    n, kl, ku = band.n, band.kl, band.ku
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    Kg, nb = K // groups, m // b
    out = None
    for g in range(groups):
        seg = BandedMatrix(data=band.data[g * Kg * m:min((g + 1) * Kg * m,
                                                          n)], kl=kl, ku=ku)
        seg = pad_banded(seg, Kg * m)
        Btip, Ctip = _extract_tips(seg.data, Kg, m, k, kl, ku,
                                   zero_boundaries=False)
        if g == groups - 1:
            Btip[Kg - 1] = 0
        if g == 0:
            Ctip[0] = 0
        blocks = _partition_blocks(seg, Kg, m, b)
        fact, yw = _factor_partitions(
            blocks, Ctip, method=method, shift=shift,
            shift_amount=shift_amount, inverter=inverter, b=b, k=k)
        Vfull, Wfull = _spikes(fact, yw, Btip, Ctip, nb, b, k)
        tips = _tips_of(Vfull, Wfull, nb, b, k)
        V, W = (Vfull, Wfull) if store_spikes else (None, None)
        fact, V, W, Lb = _cast_stored(fact, V, W,
                                      blocks.L if store_lt else None,
                                      store_dtype, spike_dtype)
        out = _into(out, (fact, V, W, tips, Lb, Btip, Ctip), g, Kg, K)
        del blocks, fact, yw, Vfull, Wfull, V, W, Lb
    fact, V, W, tips, Lb, Btip, Ctip = out
    red_fact, red_Dinv = _reduced_from_tips(
        *tips, truncated=truncated, method=method, reduced=reduced,
        inverter=inverter)
    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
                       V=V, W=W, n=n, K=K, m=m, b=b, k=k, red_Dinv=red_Dinv,
                       truncated=truncated, Lb=Lb)


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
    ``blocktri_solve_transpose`` on its base, a CR factor to ``cr_solve``,
    a block-Thomas factor to ``blocktri_solve``."""
    if isinstance(fact, TransposedBlockTriFactor):
        return blocktri_solve_transpose(fact.base, rhs)
    if isinstance(fact, CRFactor):
        return cr_solve(fact, rhs)
    return blocktri_solve(fact, rhs)


def _takes_reduced_kernel(red_fact, rhs: torch.Tensor, impl: str) -> bool:
    """Whether the reduced solve runs the one-launch kernel
    (``ops/cuda/reduced_thomas.py``): a CUDA right-hand side, a kernel
    ``impl`` (not 'plain' or 'xla', which keep the plain loop on any
    device) and a factor that ``reduced_thomas_feasible`` admits."""
    return (impl not in ("plain", "xla") and rhs.is_cuda
            and reduced_thomas_feasible(red_fact, rhs))


def _solve_reduced_system(red_fact, rhs: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """The reduced solve, dispatching on the factor type (Thomas or CR):
    a block-Thomas factor takes the one-launch kernel where
    ``_takes_reduced_kernel`` says so, else ``blocktri_solve``."""
    if isinstance(red_fact, CRFactor):
        return cr_solve(red_fact, rhs)
    if _takes_reduced_kernel(red_fact, rhs, impl):
        return blocktri_solve_reduced_cuda(red_fact, rhs)
    return blocktri_solve(red_fact, rhs)


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
    * otherwise (``lu`` and complex Hermitian ``spd`` factors, or
      ``fast=False``) the storage-sharing ``TransposedBlockTriFactor``
      marker, whose sweeps are plain PyTorch (for ``spd`` the conjugated
      forward sweeps: A^T = conj(A)).

    The coupling tips swap and transpose (A^T couples partition p forward
    through C_{p+1}^T and backward through B_{p-1}^T); the transpose
    spikes are one plain batched solve of their 2k columns, and the
    reduced system is rebuilt from their tips by :func:`reduced_factor`
    (``reduced``: CR from K - 1 >= 255 under 'auto'; ``lu`` for ``lu``
    partitions) with ``inverter`` (pass the forward factor's resolved
    one).  ``store_spikes``: None keeps V/W iff the forward factor did.  A
    real ``spd`` factorization is its own transpose and comes back as is;
    CR partition factors raise ``ValueError``, as in JAX."""
    if not isinstance(sf.fact, BlockTriFactor):
        raise ValueError(
            "spike_transpose requires block-Thomas partition factors "
            f"(got {type(sf.fact).__name__}); refactor with method='inv' "
            "or 'lu'")
    if reduced not in _REDUCED:
        raise ValueError(f"unknown reduced {reduced!r}: expected "
                         f"{', '.join(_REDUCED)}")
    K, nb, b, k = sf.K, sf.nb, sf.b, sf.k
    dtype = sf.Btip.dtype
    if sf.fact.method == "spd" and not dtype.is_complex:
        return sf
    if fast and sf.fact.method == "inv" and (sf.Lb is not None
                                             or band is not None):
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
        truncated=sf.truncated, method=sf.fact.method, reduced=reduced,
        inverter=inverter)
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

def _reduced_solve(sf: SpikeFactor, g_bot: torch.Tensor, g_top: torch.Tensor,
                   impl: str = "auto"):
    """Solve for interface unknowns; ``g_bot``/``g_top`` are ``[K, k]`` or
    ``[K, k, r]``.  Returns (xbot_prev, xtop_next) of the same shape:
    xtop_next[p] = x_{p+1}^top (zero for p = K-1),
    xbot_prev[p] = x_{p-1}^bot (zero for p = 0).  ``impl`` as in
    ``_takes_reduced_kernel``."""
    k = sf.k
    rhs = torch.cat([g_bot[:-1], g_top[1:]], dim=1)          # [K-1, 2k(, r)]
    if not sf.truncated and _takes_reduced_kernel(sf.red_fact, rhs, impl):
        # the kernel writes z into block rows 1 .. K-1 of one zeroed
        # [K+1, 2k(, r)] buffer, whose views are xbot_prev and xtop_next
        buf = rhs.new_zeros((rhs.shape[0] + 2,) + rhs.shape[1:])
        blocktri_solve_reduced_cuda(sf.red_fact, rhs, out=buf[1:-1])
        return buf[:-1, :k], buf[1:, k:]
    if sf.truncated:
        cols = rhs.dim() == 3
        z = _sweep_matvec(sf.red_Dinv, rhs if cols else rhs[..., None])
        z = z if cols else z[..., 0]
    else:
        # the kernel refused above: the plain solve of the factor's type
        z = _solve_reduced_system(sf.red_fact, rhs, "plain")
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
    ``'pallas_fused'``) ``inv`` or ``spd`` ones; ``lu`` and CR factors
    and the transpose marker none, as in JAX."""
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


def _has_kernel(fact) -> bool:
    """Whether a sweep kernel exists for the factor's type and method:
    block-Thomas ``inv`` and ``spd`` factors."""
    return isinstance(fact, BlockTriFactor) and fact.method in ("inv", "spd")


def sweep_route(fact, b: int, rhs_dtype, on_cuda: bool,
                many: bool = False) -> str:
    """The partition sweep ``impl='auto'`` runs: ``"fused"`` (the fused
    kernel of the factor's method: #1 for ``inv``, #3 for ``spd``; #4 and #5
    with ``many``), ``"sweeps"`` (the two-pass kernels #9, single RHS,
    ``inv`` factors) or ``"plain"``.  A CPU right-hand side takes the plain
    sweep.  On the card, real ``spd`` factors take their fused kernel, which
    raises where its rule refuses them, and complex (Hermitian) ones the
    plain sweep, as JAX routes them; ``inv`` factors take #1 where its
    rule admits them, else #9 where its rule does (any nb, so a long single
    partition), else the plain sweep: only f64 factors or a block outside
    64 and 128 come there, and no multi-RHS two-pass kernel exists.  A
    regular-form transpose is an ``inv`` factor and routes as one; the
    transpose marker takes the plain transpose sweeps, and ``lu`` and CR
    factors, which every kernel's rule refuses, the plain sweeps."""
    if not on_cuda or not _has_kernel(fact):
        return "plain"
    if fact.method == "spd":
        # Hermitian factors need conjugated sweeps, which #3 and #5 do
        # not run (JAX fused_sweep_feasible, fused_sweep.py:305-310)
        return "plain" if fact.F.is_complex() else "fused"
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
    mean ``plain`` and ``cuda``.  The factors no kernel takes (``lu``, CR,
    the transpose marker) run their plain sweeps under 'auto' and 'plain',
    and raise ``ValueError`` under 'cuda'."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}: expected "
                         f"{', '.join(_IMPLS)}")
    impl = _JAX_NAMES.get(impl, impl)
    if not _has_kernel(sf.fact) and impl == "cuda":
        _require_inv_factors(sf, impl)
    return partition_solver(sf.fact, sf.b, impl, rhs, many=many)


def partition_solver(fact, b: int, impl: str, rhs: torch.Tensor,
                     many: bool = False):
    """The sweep ``r -> x`` of a partition factor ``fact`` with leading K
    (``r``: ``[K, nb, b]``, or ``[K, nb, b, r]`` with ``many``) under
    ``impl`` 'auto' (the route of :func:`sweep_route` for ``rhs``),
    'cuda' or 'plain'.  Factors no kernel takes run their plain sweeps."""
    if not _has_kernel(fact):
        return lambda r: _batched_tri_solve(fact, r)
    solve = (_SWEEPS_MANY if many else _SWEEPS)[fact.method]
    if impl == "auto":
        route = sweep_route(fact, b, rhs.dtype, rhs.is_cuda, many=many)
        if route == "sweeps":
            return lambda r: blocktri_solve_batched_cuda(fact, r)
        impl = "cuda" if route == "fused" else "plain"
    return lambda r: solve(fact, r, impl=impl)


def spike_solve(sf: SpikeFactor, rhs: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """Solve A x = rhs with a SPIKE factorization.  rhs: [n].

    impl: "auto" (on a CUDA tensor the route of :func:`sweep_route`: for
    ``inv`` factors #1 where its rule admits them, else the two-pass #9
    where its rule does, else plain; #3 for ``spd``, raising where it does
    not apply; plain for ``lu`` and CR factors), "cuda" (the fused kernel;
    raises where it does not apply), "plain" (the plain PyTorch sweeps
    and reduced solve on any device), or the JAX names: "xla" (plain),
    "pallas_fused" (cuda) and "pallas" (the two-pass sweep kernels #9 of
    ``ops/cuda/sweeps.py``, one launch per sweep; ``inv`` factors only,
    raising on the card where their rule refuses the factors).  Every impl
    but the plain ones solves a block-Thomas reduced system on the card
    with the reduced kernel where its rule admits it.
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

    with span("SPIKESweep"):
        g = batched_solve(rblk)                              # [K, nb, b]
    if K == 1:
        return g.reshape(-1)[:sf.n]

    with span("SPIKEReduced"):
        xbot_prev, xtop_next = _reduced_solve(sf, g[:, nb - 1, b - k:],
                                              g[:, 0, :k], impl)
    if sf.V is not None:
        # one sweep: x = g - V x_{p+1}^top - W x_{p-1}^bot
        with span("SPIKECorrect"):
            dtype = sweep_precision(sf.V, g)
            x = (g - torch.einsum("pnbk,pk->pnb", sf.V.to(dtype),
                                  xtop_next.to(dtype))
                 - torch.einsum("pnbk,pk->pnb", sf.W.to(dtype),
                                xbot_prev.to(dtype)))
    else:
        # recompute sweep: solve with the boundary-corrected rhs
        with span("SPIKECorrect"):
            dtype = sweep_precision(sf.Btip, g)
            corrB = torch.einsum("prc,pc->pr", sf.Btip.to(dtype),
                                 xtop_next.to(dtype))
            corrC = torch.einsum("prc,pc->pr", sf.Ctip.to(dtype),
                                 xbot_prev.to(dtype))
            r2 = rblk.clone()
            r2[:, nb - 1, b - k:] -= corrB.to(r2.dtype)
            r2[:, 0, :k] -= corrC.to(r2.dtype)
        with span("SPIKESweep"):
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
    them), "cuda" (the kernel; raises where it does not apply), or "plain"
    (the plain sweeps and reduced solve on any device); and the JAX names
    "xla" (plain), "pallas_fused" (cuda) and "pallas" (the multi-RHS
    kernel, as in JAX, for ``inv`` factors only).  The reduced solve as in
    :func:`spike_solve`.  The JAX
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

    with span("SPIKESweep"):
        g = batched_solve(rblk)                              # [K, nb, b, r]
    if K == 1:
        return g.reshape(K * m, r)[:sf.n]

    with span("SPIKEReduced"):
        xbot_prev, xtop_next = _reduced_solve(
            sf, g[:, nb - 1, b - k:, :], g[:, 0, :k, :], impl)  # [K, k, r]
    if sf.V is not None:
        with span("SPIKECorrect"):
            dtype = sweep_precision(sf.V, g)
            x = (g - sf.V.to(dtype) @ xtop_next.to(dtype)[:, None]
                 - sf.W.to(dtype) @ xbot_prev.to(dtype)[:, None])
    else:
        with span("SPIKECorrect"):
            dtype = sweep_precision(sf.Btip, g)
            corrB = sf.Btip.to(dtype) @ xtop_next.to(dtype)  # [K, k, r]
            corrC = sf.Ctip.to(dtype) @ xbot_prev.to(dtype)
            r2 = rblk.clone()
            r2[:, nb - 1, b - k:, :] -= corrB.to(r2.dtype)
            r2[:, 0, :k, :] -= corrC.to(r2.dtype)
        with span("SPIKESweep"):
            x = batched_solve(r2)
    return x.reshape(K * m, r)[:sf.n]

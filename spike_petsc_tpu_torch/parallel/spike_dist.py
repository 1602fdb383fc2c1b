"""Multi-rank SPIKE on ``torch.distributed``: the partitions-per-rank
factorization, the solves, the halo matvec and the Krylov solvers over a
mesh, 1-D, 2-D (rhs x p), multislice (slice x p) and 3-D (rhs x slice x
p) (the port of ``spike_petsc_tpu.parallel.spike_dist``).

**The SPMD model.**  JAX runs one program over a mesh, global arrays in and
out.  Here one Python process runs per rank, and the API keeps JAX's
contract:

* every rank calls :func:`dist_spike_factor` with the same GLOBAL band (JAX
  receives a replicated one) and keeps only its ``ppd`` partitions: the
  ``DistSpikeFactor`` fields with a partition axis hold this rank's
  ``[ppd, ...]`` block, the reduced system is replicated;
* the solvers take the global right-hand side and return the global
  solution on every rank (one ``all_gather`` at the end);
* ``its``, ``reason``, ``rnorm`` and ``history`` are the same on every
  rank: the Krylov solvers branch only on scalars that came out of an
  ``all_reduce``, which gives every rank the same bits.

K = n_ranks * ppd band partitions along the mesh axis:

* each rank factors its partitions as one batched block-Thomas sweep, as
  the single-device path does;
* the spike tips are all-gathered over the axis (O(K k^2) bytes) and the
  reduced block-tridiagonal system is factored and solved REPLICATED on
  every rank, by cyclic reduction from K - 1 >= 33 block rows under
  ``reduced='auto'`` (JAX's distributed threshold; the single-device path
  takes 255);
* the Krylov matvec couples partitions inside a rank through its blocks
  (or its band rows) and exchanges only the k-wide rank-edge strips with
  the neighbours, one ``batch_isend_irecv`` (JAX's cyclic ``ppermute``);
* inner products are one ``all_reduce`` each over the axis
  (``axis_name`` of the Krylov solvers).

The multislice layout (the section at the end) is SPIKE within each slice
and block-Jacobi across slices; its matvec is exact.

On the card the partition sweeps take the fused kernels of the
single-device path through ``ops.spike.partition_solver`` (#1 for ``inv``,
#3 for ``spd``, #4 and #5 for many right-hand sides, #9 where its rule
routes there), the blocks matvec #7 through the chunked entry and the band
matvec #2; on the CPU their plain versions.  The multi-RHS matvec is the
batched block product of the single-device ``blocktri_many`` route.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..ops.band import BandedMatrix, banded_matvec, pad_banded
from ..ops.blocktri import (BlockTridiagonal, BlockTriFactor,
                            TransposedBlockTriFactor, blocktri_factor,
                            blocktri_factor_inv_waux, blocktri_matvec,
                            sweep_precision, transposed_factor_from_blocks)
from ..ops.cuda.band_matvec import (PreparedBandMV, banded_matvec_prepared,
                                    banded_mv_feasible, prepare_banded_mv)
from ..ops.cuda.blocktri_matvec import (blocktri_matvec_chunked_cuda,
                                        blocktri_matvec_feasible)
from ..ops.cyclic import CRFactor, cr_factor
from ..ops.spike import (_batched_tri_solve, _cast_stored, _extract_tips,
                         _partition_blocks, _partition_geometry,
                         _reduced_from_tips, _solve_reduced_system,
                         _spike_bwd_one, _spike_columns, _tips_of,
                         partition_solver)
from ..solvers.krylov_many import MANY_SOLVERS
from ..solvers.ksp import _TRANSPOSE_TYPES as TRANSPOSE_KSP_TYPES
from ..solvers.types import KSPResult
from ..utils.registry import SOLVERS
from .mesh import Mesh, MeshAxis

#: the reduced system takes cyclic reduction from this many block rows
DIST_CR_THRESHOLD = 33
_MATVEC_IMPLS = ("auto", "blocks", "banded_pallas", "banded_cuda")


@dataclass(frozen=True)
class DistSpikeFactor:
    """One rank's part of a mesh SPIKE factorization: the partition fields
    hold this rank's ``ppd`` partitions (global ids ``rank * ppd + i``),
    the reduced-system fields are replicated."""

    blocks: BlockTridiagonal          # [ppd, nb, b, b] x3
    fact: Union[BlockTriFactor, CRFactor, TransposedBlockTriFactor]
    Btip: torch.Tensor                # [ppd, k, k]
    Ctip: torch.Tensor                # [ppd, k, k]
    red_fact: Optional[Union[BlockTriFactor, CRFactor]]
    red_Dinv: Optional[torch.Tensor]  # [K-1, 2k, 2k] (truncated)
    V: Optional[torch.Tensor]         # [ppd, nb, b, k] (store_spikes)
    W: Optional[torch.Tensor]
    n: int
    K: int
    m: int
    b: int
    k: int
    ppd: int
    truncated: bool
    rank: int                         # this rank's place on the row axis
    #                                   (the (slice, p) plane: multislice)
    # the local band rows for the banded matvec route (the diagonal-major
    # layout of the kernel #2), None for the blocks route
    mv_prep: Optional[PreparedBandMV] = None

    @property
    def nb(self) -> int:
        return self.m // self.b

    @property
    def matvec_route(self) -> str:
        return "blocks" if self.mv_prep is None else "banded_cuda"


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------

def _build_reduced(tips: torch.Tensor, truncated: bool, method: str,
                   reduced: str = "auto", inverter: str = "auto"):
    """Assemble and factor the reduced interface system from the gathered
    tips ``[K, 4, k, k]`` (V_top, V_bot, W_top, W_bot), replicated on every
    rank: the single-device assembly with the distributed CR threshold."""
    return _reduced_from_tips(tips[:, 0], tips[:, 1], tips[:, 2], tips[:, 3],
                              truncated=truncated, method=method,
                              reduced=reduced, inverter=inverter,
                              cr_threshold=DIST_CR_THRESHOLD)


def _local_factor(blocks: BlockTridiagonal, method: str, shift: str,
                  shift_amount, inverter: str):
    """The batched factor of this rank's ``[ppd, nb, b, b]`` partitions
    (``lu`` / ``spd`` by block-Thomas, ``cr`` by cyclic reduction)."""
    kw = dict(shift=shift, shift_amount=shift_amount, inverter=inverter)
    if method == "cr":
        return cr_factor(blocks, **kw)
    return blocktri_factor(blocks, method=method, **kw)


def _factor_and_spikes(blocks, Btip, Ctip, *, method, shift, shift_amount,
                       inverter, nb: int, b: int, k: int):
    """Partition factors and full V/W spikes.  ``inv`` carries the W
    forward sweep in the factor loop (JAX ``blocktri_factor_inv_waux`` and
    ``_spike_columns_from_waux``, the latter the batched
    ``ops.spike._spike_bwd_one``); the other methods take the factor and
    ``_spike_columns``."""
    dtype = blocks.dtype
    if method == "inv":
        Cb = torch.zeros((Ctip.shape[0], b, k), dtype=dtype,
                         device=Ctip.device)
        Cb[:, :k, :] = Ctip
        fact, yw = blocktri_factor_inv_waux(blocks, Cb, shift=shift,
                                            shift_amount=shift_amount,
                                            inverter=inverter)
        Vfull, Wfull = _spike_bwd_one(fact, Btip, yw, b, k, dtype)
    else:
        fact = _local_factor(blocks, method, shift, shift_amount, inverter)
        Vfull, Wfull = _spike_columns(fact, Btip, Ctip, nb, b, k, dtype)
    return fact, Vfull, Wfull


def _resolve_matvec_impl(impl: str, local_band: BandedMatrix) -> str:
    """``matvec_impl`` -> "banded_cuda" or "blocks".  JAX's values
    ("auto", "blocks", "banded_pallas") and the port's alias
    "banded_cuda" (as ``solvers/operator.py`` takes them).  'auto' follows
    no tuning record (the band kernel beat the blocktri kernel at every
    shape ``tools/tune.py`` measured on the card): on a CUDA mesh it takes
    the band kernel where ``banded_mv_feasible`` admits this rank's band
    rows, else blocks; on a CPU mesh blocks, as JAX does off the TPU."""
    if impl not in _MATVEC_IMPLS:
        raise ValueError(f"matvec_impl must be one of "
                         f"{', '.join(_MATVEC_IMPLS)}, got {impl!r}")
    if impl == "auto":
        return "banded_cuda" if (local_band.data.is_cuda and
                                 banded_mv_feasible(local_band)) else "blocks"
    if impl in ("banded_pallas", "banded_cuda"):
        if not banded_mv_feasible(local_band):
            raise ValueError(
                f"matvec_impl={impl!r} infeasible for w={local_band.width}, "
                f"local rows={local_band.n}, dtype={local_band.dtype}; use "
                "'blocks'")
        return "banded_cuda"
    return "blocks"


def dist_spike_factor(band: BandedMatrix, mesh: Mesh, axis: str = "p",
                      method: str = "inv", truncated: bool = False,
                      block_b: Optional[int] = None,
                      parts_per_device: int = 1,
                      reduced: str = "auto",
                      store_spikes: bool = False,
                      store_dtype=None, spike_dtype=None,
                      shift: str = "none", shift_amount: float = 0.0,
                      inverter: str = "auto",
                      safety_net: bool = True,
                      matvec_impl: str = "auto") -> DistSpikeFactor:
    """Factor a global band over the mesh axis ``axis`` with
    K = n_ranks * parts_per_device partitions (JAX
    ``spike_dist.py:208-260``, the same options).  Every rank passes the
    same global band and keeps its own partitions.

    ``store_spikes`` keeps V/W (one sweep and a correction a PC apply);
    ``store_dtype``/``spike_dtype`` the bf16 storage modes; ``shift``
    boosts small Schur pivots; ``inverter`` picks the batched inverse,
    guarded by the Newton-probe ``safety_net`` (a distributed probe solve;
    a junk factorization is re-factored with ``inverter='blocked'``).
    ``reduced``: "thomas", "cr" or "auto" (CR from K - 1 >= 33).
    ``matvec_impl``: "blocks" (the Krylov matvec on the stored blocks,
    kernel #7 on the card), "banded_pallas"/"banded_cuda" (this rank's
    band rows in the layout of the band kernel #2, one band-sized copy;
    only the rank-edge strips are exchanged), or "auto" (see
    :func:`_resolve_matvec_impl`)."""
    def build(inv):
        return _dist_spike_factor_impl(
            band, mesh, axis, method=method, truncated=truncated,
            block_b=block_b, parts_per_device=parts_per_device,
            reduced=reduced, store_spikes=store_spikes,
            store_dtype=store_dtype, spike_dtype=spike_dtype, shift=shift,
            shift_amount=shift_amount, inverter=inv,
            matvec_impl=matvec_impl)

    dsf = build(inverter)
    if safety_net:
        dsf, _ = _dist_safety_net(band, dsf, mesh, axis, inverter,
                                  store_dtype, spike_dtype,
                                  lambda: build("blocked"),
                                  exact=not truncated)
    return dsf


def _dist_safety_net(band, dsf, mesh, axis, inverter, store_dtype,
                     spike_dtype, refactor, exact: bool = True):
    """The PC layer's Newton-probe retry contract on a mesh factorization:
    a distributed probe solve of A x = A 1, and a re-factor with
    ``inverter='blocked'`` when its residual is junk.  The probe's x is the
    gathered global vector and the band the same on every rank, so every
    rank takes the same decision.  Returns ``(dsf, fell_back)``."""
    from ..solvers.pc import _newton_probe_active, _probe_tolerance
    if not _newton_probe_active(inverter):
        return dsf, False
    probe = banded_matvec(band, torch.ones(band.n, dtype=band.dtype,
                                           device=band.device))
    xs = dist_spike_solve(dsf, probe, mesh, axis).to(band.device)
    err = float(torch.linalg.norm(banded_matvec(band, xs) - probe)
                / torch.linalg.norm(probe))
    tol = _probe_tolerance(store_dtype, spike_dtype)
    bad = not math.isfinite(err) or (exact and err > tol) or err > 1e6
    if bad:
        return refactor(), True
    return dsf, False


def _local_band(band: BandedMatrix, ring_rank: int, rows: int,
                device) -> BandedMatrix:
    """This rank's ``rows`` rows of the band padded to the mesh's rows
    (``ring_rank`` its place on the row axis), on the mesh device."""
    n, lo = band.n, ring_rank * rows
    mine = BandedMatrix(data=band.data[min(lo, n):min(lo + rows, n)],
                        kl=band.kl, ku=band.ku)
    mine = pad_banded(mine, rows)
    return BandedMatrix(data=mine.data.to(device).contiguous(), kl=band.kl,
                        ku=band.ku)


def _dist_spike_factor_impl(band: BandedMatrix, mesh: Mesh, axis: str, *,
                            method, truncated, block_b, parts_per_device,
                            reduced, store_spikes, store_dtype, spike_dtype,
                            shift, shift_amount, inverter,
                            matvec_impl="blocks") -> DistSpikeFactor:
    ax = mesh.axis(axis)
    ppd = parts_per_device
    K = ax.size * ppd
    kl, ku, n = band.kl, band.ku, band.n
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    nb = m // b
    local = _local_band(band, ax.rank, ppd * m, mesh.device)
    route = _resolve_matvec_impl(matvec_impl, local)

    gidx = ax.rank * ppd + torch.arange(ppd, device=mesh.device)
    Btip, Ctip = _extract_tips(local.data, ppd, m, k, kl, ku,
                               zero_boundaries=False)
    Btip[gidx == K - 1] = 0
    Ctip[gidx == 0] = 0
    # the couplings that leave a partition live only in the L[0] / U[nb-1]
    # blocks, which _partition_blocks zeroes (b >= k)
    blocks = _partition_blocks(local, ppd, m, b)
    red_fact = red_Dinv = V = W = None
    if K > 1:
        fact, Vfull, Wfull = _factor_and_spikes(
            blocks, Btip, Ctip, method=method, shift=shift,
            shift_amount=shift_amount, inverter=inverter, nb=nb, b=b, k=k)
        tips = torch.stack(_tips_of(Vfull, Wfull, nb, b, k), dim=1)
        all_tips = ax.all_gather(tips).reshape(K, 4, k, k)
        red_fact, red_Dinv = _build_reduced(all_tips, truncated, method,
                                            reduced, inverter)
        if store_spikes:
            V, W = Vfull, Wfull
    else:
        fact = _local_factor(blocks, method, shift, shift_amount, inverter)
    fact, V, W, _ = _cast_stored(fact, V, W, None, store_dtype, spike_dtype)
    return DistSpikeFactor(
        blocks=blocks, fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
        red_Dinv=red_Dinv, V=V, W=W, n=n, K=K, m=m, b=b, k=k, ppd=ppd,
        truncated=truncated, rank=ax.rank,
        mv_prep=prepare_banded_mv(local) if route == "banded_cuda" else None)


# ---------------------------------------------------------------------------
# Local (per-rank) building blocks: [ppd, ...] arrays of this rank
# ---------------------------------------------------------------------------

def _interface_solve(dsf: DistSpikeFactor, g_top: torch.Tensor,
                     g_bot: torch.Tensor, ax: MeshAxis, K: int,
                     impl: str = "auto"):
    """All-gather the interface values over ``ax`` (two ``all_gather``s of
    ``[ppd, k(, r)]``), solve the reduced system of the ``K`` partitions
    along ``ax`` (or apply ``red_Dinv`` when truncated), and slice this
    rank's partitions.  Returns ``(xbot_prev, xtop_next)`` of the shape of
    ``g_top``, zero at the ends of the axis.  ``impl``: the solve's, which
    picks the reduced solve's route (``ops.spike._takes_reduced_kernel``)."""
    k, ppd = dsf.k, dsf.ppd
    trail = tuple(g_top.shape[2:])
    gt = ax.all_gather(g_top).reshape((K, k) + trail)
    gb = ax.all_gather(g_bot).reshape((K, k) + trail)
    rhs = torch.cat([gb[:-1], gt[1:]], dim=1)             # [K-1, 2k(, r)]
    if dsf.truncated:
        cols = rhs if trail else rhs[..., None]
        dtype = sweep_precision(dsf.red_Dinv, cols)
        z = dsf.red_Dinv.to(dtype) @ cols.to(dtype)
        z = z if trail else z[..., 0]
    else:
        z = _solve_reduced_system(dsf.red_fact, rhs, impl)
    zpad = torch.cat([z, torch.zeros_like(z[:1])], dim=0)  # [K, 2k(, r)]
    gp = ax.rank * ppd + torch.arange(ppd, device=z.device)
    mask = (1,) * (1 + len(trail))
    xtop_next = zpad[gp.clamp(max=K - 1), k:] * (gp < K - 1).reshape(
        (ppd,) + mask).to(z.dtype)
    xbot_prev = zpad[(gp - 1).clamp(min=0), :k] * (gp > 0).reshape(
        (ppd,) + mask).to(z.dtype)
    return xbot_prev, xtop_next


def local_interface_solve(dsf: DistSpikeFactor, g_top: torch.Tensor,
                          g_bot: torch.Tensor, ax: MeshAxis,
                          impl: str = "auto"):
    """The interface solve of a 1-D mesh factor: the replicated reduced
    system of all K partitions."""
    return _interface_solve(dsf, g_top, g_bot, ax, dsf.K, impl)


def _local_tri_solve(dsf: DistSpikeFactor, rblk: torch.Tensor,
                     impl: str = "auto") -> torch.Tensor:
    """This rank's batched partition sweep ``[ppd, nb, b]`` on the route of
    the single-device path (``ops.spike.partition_solver``): on the card
    #1 for ``inv``, #3 for ``spd``, #9 where the rule routes there."""
    return partition_solver(dsf.fact, dsf.b, impl, rblk)(rblk)


def _local_tri_solve_many(dsf: DistSpikeFactor, rblk: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """The multi-RHS sweep ``[ppd, nb, b, r]``: #4 for ``inv``, #5 for
    ``spd`` on the card, the factors streamed once for all r."""
    return partition_solver(dsf.fact, dsf.b, impl, rblk, many=True)(rblk)


def _spike_correct(dsf: DistSpikeFactor, g, rblk, xbot_prev, xtop_next,
                   solve_fn):
    """The last SPIKE step: with stored spikes x = g - V x_next^top -
    W x_prev^bot (the factors streamed once a PC apply), else the second
    sweep on the boundary-corrected right-hand side.  Shapes ``[ppd, nb,
    b(, r)]`` with interface vectors ``[ppd, k(, r)]``."""
    nb, b, k = dsf.nb, dsf.b, dsf.k
    many = g.dim() == 4
    if dsf.V is not None:
        dtype = sweep_precision(dsf.V, g)
        eq = "pnbk,pkr->pnbr" if many else "pnbk,pk->pnb"
        return (g - torch.einsum(eq, dsf.V.to(dtype), xtop_next.to(dtype))
                - torch.einsum(eq, dsf.W.to(dtype), xbot_prev.to(dtype)))
    dtype = sweep_precision(dsf.Btip, g)
    eq = "pcd,pdr->pcr" if many else "pcd,pd->pc"
    corrB = torch.einsum(eq, dsf.Btip.to(dtype), xtop_next.to(dtype))
    corrC = torch.einsum(eq, dsf.Ctip.to(dtype), xbot_prev.to(dtype))
    r2 = rblk.clone()
    r2[:, nb - 1, b - k:] -= corrB.to(r2.dtype)
    r2[:, 0, :k] -= corrC.to(r2.dtype)
    return solve_fn(r2)


def local_spike_solve(dsf: DistSpikeFactor, rhs_local: torch.Tensor,
                      ax: MeshAxis, impl: str = "auto") -> torch.Tensor:
    """This rank's part of the SPIKE solve of the global system;
    ``rhs_local`` ``[ppd * m]``."""
    nb, b, k, ppd = dsf.nb, dsf.b, dsf.k, dsf.ppd
    rblk = rhs_local.reshape(ppd, nb, b)
    g = _local_tri_solve(dsf, rblk, impl)
    if dsf.K == 1:
        return g.reshape(-1)
    xbot_prev, xtop_next = local_interface_solve(
        dsf, g[:, 0, :k], g[:, nb - 1, b - k:], ax, impl)
    x = _spike_correct(dsf, g, rblk, xbot_prev, xtop_next,
                       lambda r2: _local_tri_solve(dsf, r2, impl))
    return x.reshape(-1)


def local_spike_solve_many(dsf: DistSpikeFactor, rblk: torch.Tensor,
                           ax: MeshAxis, impl: str = "auto") -> torch.Tensor:
    """This rank's part of the multi-RHS solve; ``rblk`` ``[ppd, nb, b, r]``
    -> the same.  The factors stream once for all r, the interface
    ``all_gather`` carries ``[K, k, r]`` strips and the reduced system is
    solved for every column in one replicated call."""
    nb, b, k = dsf.nb, dsf.b, dsf.k
    g = _local_tri_solve_many(dsf, rblk, impl)
    if dsf.K == 1:
        return g
    xbot_prev, xtop_next = local_interface_solve(
        dsf, g[:, 0, :k, :], g[:, nb - 1, b - k:, :], ax, impl)
    return _spike_correct(
        dsf, g, rblk, xbot_prev, xtop_next,
        lambda r2: _local_tri_solve_many(dsf, r2, impl))


def _local_blocks_matvec(dsf: DistSpikeFactor,
                         xblk: torch.Tensor) -> torch.Tensor:
    """This rank's block-tridiagonal product without the halo,
    ``[ppd, nb, b(, r)]``.  A single right-hand side takes the kernel #7
    through the chunked entry where its rule admits the blocks (the
    ``[ppd, nb, b, b]`` blocks read in place as one sequence; the zero
    ``L[:, 0]`` / ``U[:, -1]`` add no coupling); many right-hand sides
    take the batched block product (the single-device ``blocktri_many``)."""
    blocks = dsf.blocks
    ppd, nb, b = dsf.ppd, dsf.nb, dsf.b
    if xblk.dim() == 3 and xblk.is_cuda \
            and blocktri_matvec_feasible(blocks.dtype, b) \
            and xblk.dtype == torch.float32:
        return blocktri_matvec_chunked_cuda(blocks, xblk)
    flat = BlockTridiagonal(D=blocks.D.reshape(ppd * nb, b, b),
                            L=blocks.L.reshape(ppd * nb, b, b),
                            U=blocks.U.reshape(ppd * nb, b, b))
    y = blocktri_matvec(flat, xblk.reshape((ppd * nb, b) + xblk.shape[3:]))
    return y.reshape(xblk.shape)


def _halo(ax: MeshAxis, x_top: torch.Tensor, x_bot: torch.Tensor):
    """The neighbour vectors of the coupling terms: ``x_top`` / ``x_bot``
    ``[ppd, k(, r)]`` are each partition's first / last k rows.  Returns
    ``(next_tops, prev_bots)``: partition p's successor's top and
    predecessor's bottom, the rank-edge ones from the neighbour ranks (one
    exchange).  The global edge tips are zero, so what the ring wraps
    around multiplies zero."""
    top_from_next, bot_from_prev = ax.exchange(x_top[0], x_bot[-1])
    next_tops = torch.cat([x_top[1:], top_from_next[None]], dim=0)
    prev_bots = torch.cat([bot_from_prev[None], x_bot[:-1]], dim=0)
    return next_tops, prev_bots


def _local_banded_matvec(dsf: DistSpikeFactor, x_local: torch.Tensor,
                         ax: MeshAxis) -> torch.Tensor:
    """The product on this rank's stored band rows (kernel #2 on the
    card): the band keeps every coupling inside the rank, also across its
    partition boundaries, so only the two k-wide rank-edge strips are
    exchanged and added through the edge tips."""
    k, m = dsf.k, dsf.m
    y = banded_matvec_prepared(dsf.mv_prep, x_local)
    if dsf.K == 1:
        return y
    xp = x_local.reshape(dsf.ppd, m)
    top_from_next, bot_from_prev = ax.exchange(xp[0, :k], xp[-1, m - k:])
    y = y.reshape(dsf.ppd, m)
    y[-1, m - k:] += dsf.Btip[-1].to(y.dtype) @ top_from_next.to(y.dtype)
    y[0, :k] += dsf.Ctip[0].to(y.dtype) @ bot_from_prev.to(y.dtype)
    return y.reshape(-1)


def local_matvec(dsf: DistSpikeFactor, x_local: torch.Tensor,
                 ax: MeshAxis) -> torch.Tensor:
    """This rank's rows of A x: the partition couplings inside the rank
    from its blocks (or band rows), the rank-edge strips from the
    neighbours."""
    if dsf.mv_prep is not None:
        return _local_banded_matvec(dsf, x_local, ax)
    nb, b, k, ppd, m = dsf.nb, dsf.b, dsf.k, dsf.ppd, dsf.m
    xp = x_local.reshape(ppd, m)
    y = _local_blocks_matvec(dsf, xp.reshape(ppd, nb, b)).reshape(ppd, m)
    if dsf.K == 1:
        return y.reshape(-1)
    next_tops, prev_bots = _halo(ax, xp[:, :k], xp[:, m - k:])
    y[:, m - k:] += torch.einsum("pcd,pd->pc", dsf.Btip.to(y.dtype),
                                 next_tops.to(y.dtype))
    y[:, :k] += torch.einsum("pcd,pd->pc", dsf.Ctip.to(y.dtype),
                             prev_bots.to(y.dtype))
    return y.reshape(-1)


def local_matvec_many(dsf: DistSpikeFactor, xblk: torch.Tensor,
                      ax: MeshAxis) -> torch.Tensor:
    """Multi-RHS ``local_matvec``; ``xblk`` ``[ppd, nb, b, r]`` -> the
    same (the halo strips ``[k, r]``)."""
    nb, b, k = dsf.nb, dsf.b, dsf.k
    y = _local_blocks_matvec(dsf, xblk)
    if dsf.K == 1:
        return y
    next_tops, prev_bots = _halo(ax, xblk[:, 0, :k, :],
                                 xblk[:, nb - 1, b - k:, :])
    y[:, nb - 1, b - k:, :] += torch.einsum(
        "pcd,pdr->pcr", dsf.Btip.to(y.dtype), next_tops.to(y.dtype))
    y[:, 0, :k, :] += torch.einsum(
        "pcd,pdr->pcr", dsf.Ctip.to(y.dtype), prev_bots.to(y.dtype))
    return y


# ---------------------------------------------------------------------------
# Global entry points
# ---------------------------------------------------------------------------

def _pad_shard_rhs(dsf: DistSpikeFactor, ax: MeshAxis,
                   rhs: torch.Tensor) -> torch.Tensor:
    """This rank's ``[ppd * m(, r)]`` rows of the global ``rhs`` padded to
    K * m with zeros, on the mesh device."""
    rows = dsf.ppd * dsf.m
    lo = ax.rank * rows
    out = torch.zeros((rows,) + tuple(rhs.shape[1:]), dtype=rhs.dtype,
                      device=ax.device)
    piece = rhs[min(lo, dsf.n):min(lo + rows, dsf.n)]
    out[:piece.shape[0]] = piece.to(ax.device)
    return out


def _gather_global(dsf: DistSpikeFactor, ax: MeshAxis,
                   x_local: torch.Tensor) -> torch.Tensor:
    """The global ``[n(, r)]`` vector from every rank's rows (one
    ``all_gather``)."""
    x = ax.all_gather(x_local)
    return x.reshape((dsf.K * dsf.m,) + tuple(x_local.shape[1:]))[:dsf.n]


def dist_spike_solve(dsf: DistSpikeFactor, rhs, mesh: Mesh,
                     axis: str = "p") -> torch.Tensor:
    """Direct SPIKE solve of A x = rhs over the mesh; the global ``rhs``
    ``[n]`` in, the global x out on every rank."""
    ax = mesh.axis(axis)
    r_local = _pad_shard_rhs(dsf, ax, torch.as_tensor(rhs))
    return _gather_global(dsf, ax, local_spike_solve(dsf, r_local, ax))


def dist_spike_solve_many(dsf: DistSpikeFactor, rhs, mesh: Mesh,
                          axis: str = "p") -> torch.Tensor:
    """Direct multi-RHS SPIKE solve over the mesh; ``rhs`` ``[n, r]`` -> x
    ``[n, r]`` on every rank, the factors streamed once for all r."""
    ax = mesh.axis(axis)
    rhs = torch.as_tensor(rhs)
    r = rhs.shape[1]
    rblk = _pad_shard_rhs(dsf, ax, rhs).reshape(dsf.ppd, dsf.nb, dsf.b, r)
    x = local_spike_solve_many(dsf, rblk, ax)
    return _gather_global(dsf, ax, x.reshape(dsf.ppd * dsf.m, r))


def _remove_local(q_loc: torch.Tensor, v: torch.Tensor,
                  ax: MeshAxis) -> torch.Tensor:
    """MatNullSpaceRemove on a row-sharded vector: ``q_loc`` ``[rows, dim]``
    is this rank's block of the orthonormal basis; the dim-sized
    coefficient is the only traffic (one ``all_reduce``).  In ``v``'s
    dtype, as JAX computes it."""
    q = q_loc.to(v.dtype)
    coeff = ax.all_reduce(q.conj().T @ v)
    return v - q @ coeff


# ---------------------------------------------------------------------------
# Transpose
# ---------------------------------------------------------------------------

def _transpose_local_parts(dsf: DistSpikeFactor, ring: MeshAxis, *,
                           spikes: bool, spike_mask=None, fast: bool = True):
    """This rank's part of the factorization of A^T on the same factors,
    shared by the 1-D and the multislice transposes (JAX
    ``spike_dist.py:724``): the coupling tips swap and transpose with one
    exchange around ``ring`` (the stored global-edge zeros zero the new
    edges), the blocks transpose partition by partition, and, where
    ``spikes``, the transpose spikes are one batched solve of their 2k
    columns built from the tips as ``spike_mask(Btip_t, Ctip_t)`` leaves
    them.  Returns ``(blocks_t, Btip_t, Ctip_t, factT, Vt, Wt, tips)``,
    the last three None without ``spikes``."""
    ppd, nb, b, k = dsf.ppd, dsf.nb, dsf.b, dsf.k
    blocks, dtype = dsf.blocks, dsf.Btip.dtype

    def tT(a):
        return a.transpose(-1, -2)

    ct_next, bt_prev = ring.exchange(dsf.Ctip[0], dsf.Btip[-1])
    Btip_t = tT(torch.cat([dsf.Ctip[1:], ct_next[None]])).contiguous()
    Ctip_t = tT(torch.cat([bt_prev[None], dsf.Btip[:-1]])).contiguous()
    zb = torch.zeros_like(blocks.D[:, :1])
    blocks_t = BlockTridiagonal(
        D=tT(blocks.D).contiguous(),
        L=torch.cat([zb, tT(blocks.U[:, :-1])], dim=1),
        U=torch.cat([tT(blocks.L[:, 1:]), zb], dim=1))
    if fast and dsf.fact.method == "inv":
        factT = transposed_factor_from_blocks(dsf.fact, blocks)
    else:
        factT = TransposedBlockTriFactor(dsf.fact)
    if not spikes:
        return blocks_t, Btip_t, Ctip_t, factT, None, None, None
    Bs, Cs = (Btip_t, Ctip_t) if spike_mask is None else \
        spike_mask(Btip_t, Ctip_t)
    rhs = torch.zeros((ppd, nb, b, 2 * k), dtype=dtype,
                      device=dsf.Btip.device)
    rhs[:, nb - 1, b - k:, :k] = Bs
    rhs[:, 0, :k, k:] = Cs
    VW = _batched_tri_solve(factT, rhs).to(dtype)
    Vt, Wt = VW[..., :k], VW[..., k:]
    tips = torch.stack(_tips_of(Vt, Wt, nb, b, k), dim=1)
    return blocks_t, Btip_t, Ctip_t, factT, Vt, Wt, tips


def _keep_spikes(Vt, Wt, keep: bool, sdt):
    """The transpose spikes a transposed factor keeps, in the forward
    factor's spike dtype ``sdt``."""
    if not keep or Vt is None:
        return None, None
    V, W = Vt.contiguous(), Wt.contiguous()
    return (V, W) if sdt is None else (V.to(sdt), W.to(sdt))


def _require_block_thomas(dsf: DistSpikeFactor, name: str) -> None:
    if not isinstance(dsf.fact, BlockTriFactor):
        raise ValueError(
            f"{name} requires block-Thomas partition factors "
            f"(got {type(dsf.fact).__name__})")


def dist_spike_transpose(dsf: DistSpikeFactor, mesh: Mesh, axis: str = "p",
                         reduced: str = "auto", inverter: str = "auto",
                         store_spikes: Optional[bool] = None,
                         fast: bool = True) -> DistSpikeFactor:
    """The factorization of A^T on the SAME mesh factors (JAX
    ``spike_dist.py:776-861``): no refactorization.  On each rank the
    blocks transpose partition by partition (D' = D^T, L'_i = U_{i-1}^T,
    U'_i = L_{i+1}^T); the coupling tips swap and transpose with one
    neighbour exchange (A^T couples partition p forward through
    C_{p+1}^T and backward through B_{p-1}^T; the stored global-edge zeros
    zero the new edges); the transpose spikes are one batched solve of
    their 2k columns; the replicated reduced system is rebuilt from their
    all-gathered tips.

    ``fast=True`` (``inv`` factors) builds the REGULAR-form transposed
    factor (``transposed_factor_from_blocks``), whose solves take the
    sweep kernel #1 as the forward ones do; otherwise the storage-sharing
    ``TransposedBlockTriFactor`` marker (plain transpose sweeps).  The
    result carries no band rows: its matvec takes the blocks route."""
    _require_block_thomas(dsf, "dist_spike_transpose")
    ax = mesh.axis(axis)
    K, k = dsf.K, dsf.k
    keep = (dsf.V is not None) if store_spikes is None else store_spikes
    sdt = dsf.V.dtype if dsf.V is not None else None
    blocks_t, Btip_t, Ctip_t, factT, Vt, Wt, tips = _transpose_local_parts(
        dsf, ax, spikes=K > 1, fast=fast)
    red_fact = red_Dinv = None
    if K > 1:
        all_tips = ax.all_gather(tips).reshape(K, 4, k, k)
        red_fact, red_Dinv = _build_reduced(all_tips, dsf.truncated,
                                            dsf.fact.method, reduced,
                                            inverter)
    V, W = _keep_spikes(Vt, Wt, keep, sdt)
    return DistSpikeFactor(blocks=blocks_t, fact=factT, Btip=Btip_t,
                           Ctip=Ctip_t, red_fact=red_fact,
                           red_Dinv=red_Dinv, V=V, W=W, n=dsf.n, K=K,
                           m=dsf.m, b=dsf.b, k=k, ppd=dsf.ppd,
                           truncated=dsf.truncated, rank=dsf.rank)


# ---------------------------------------------------------------------------
# Krylov solvers on the mesh
# ---------------------------------------------------------------------------

def _krylov_solve_fn(dsf: DistSpikeFactor, ax: MeshAxis, ksp_type: str,
                     use_pc: bool, dsf_transpose, nullspace,
                     transpose_nullspace, params: dict, matvec_of, pc_of):
    """The Krylov solve over the row axis ``ax`` shared by the 1-D and the
    multislice solvers: ``matvec_of(d)`` / ``pc_of(d)`` give the local
    operator and PC of the factor ``d`` (``dsf`` or ``dsf_transpose``),
    every inner product and null-space projection is one ``all_reduce``
    over ``ax``, and x comes back global on every rank."""
    method = SOLVERS.get(ksp_type)
    tns = transpose_nullspace if transpose_nullspace is not None \
        else nullspace
    qn = None if nullspace is None else _pad_shard_rhs(dsf, ax,
                                                       nullspace.vecs)
    qt = None if tns is None else _pad_shard_rhs(dsf, ax, tns.vecs)

    def project(q, fn):
        return fn if q is None else (lambda v: _remove_local(q, fn(v), ax))

    def solve_fn(rhs, x0=None) -> KSPResult:
        r_local = _pad_shard_rhs(dsf, ax, torch.as_tensor(rhs))
        x0_local = None if x0 is None else _pad_shard_rhs(
            dsf, ax, torch.as_tensor(x0))
        if qt is not None:
            # consistency and residual drift by the LEFT null space
            r_local = _remove_local(qt, r_local, ax)
        matvec = project(qt, matvec_of(dsf))
        # every PC output projected (KSP_PCApply + MatNullSpaceRemove)
        pc_apply = project(qn, pc_of(dsf)) if use_pc else None
        kw = dict(params)
        if ksp_type in TRANSPOSE_KSP_TYPES:
            kw["matvec_transpose"] = project(qn, matvec_of(dsf_transpose))
            if use_pc:
                kw["pc_apply_transpose"] = project(qt, pc_of(dsf_transpose))
        res = method(matvec, r_local, x0_local, pc_apply, axis_name=ax,
                     **kw)
        x = res.x if qn is None else _remove_local(qn, res.x, ax)
        return KSPResult(x=_gather_global(dsf, ax, x), its=res.its,
                         reason=res.reason, rnorm=res.rnorm,
                         history=res.history,
                         true_history=res.true_history)

    return solve_fn


def _need_transpose(ksp_type: str, dsf_transpose, how: str) -> None:
    if ksp_type in TRANSPOSE_KSP_TYPES and dsf_transpose is None:
        raise ValueError(
            f"distributed {ksp_type} needs the A^T factorization: pass "
            f"dsf_transpose={how}")


def make_dist_solver(dsf: DistSpikeFactor, mesh: Mesh, axis: str = "p",
                     ksp_type: str = "gmres", use_pc: bool = True,
                     dsf_transpose: Optional[DistSpikeFactor] = None,
                     nullspace=None, transpose_nullspace=None, **params):
    """A SPIKE-preconditioned Krylov solver over the mesh (JAX
    ``spike_dist.py:1763-1857``): the halo matvec, the per-rank SPIKE PC,
    and inner products that ``all_reduce`` over the axis.

    ``ksp_type`` is any registered KSP type; the A^T types (``bicg``,
    ``cgne``/``cgnr``/``cgls``, ``lsqr``) need ``dsf_transpose =
    dist_spike_transpose(dsf, mesh, axis)``, whose matvec and SPIKE solve
    are the transpose operator and PC.  ``nullspace`` /
    ``transpose_nullspace`` (``solvers.nullspace.NullSpace``, global
    ``[n, dim]`` bases): singular consistent systems, projected as
    ``make_solver`` projects them, each projection one ``all_reduce``.

    Returns ``solve(rhs[n], x0=None) -> KSPResult`` whose ``x`` is the
    global ``[n]`` vector on every rank."""
    _need_transpose(ksp_type, dsf_transpose,
                    "dist_spike_transpose(dsf, mesh, axis)")
    ax = mesh.axis(axis)
    return _krylov_solve_fn(
        dsf, ax, ksp_type, use_pc, dsf_transpose, nullspace,
        transpose_nullspace, params,
        matvec_of=lambda d: (lambda v: local_matvec(d, v, ax)),
        pc_of=lambda d: (lambda v: local_spike_solve(d, v, ax)))


def _many_local_fn(dsf: DistSpikeFactor, ksp_type: str, use_pc: bool,
                   params: dict, *, red: MeshAxis, sync: Optional[MeshAxis],
                   pc_many, pc_one, mv_one):
    """The multi-RHS engine of one replica behind the serving surfaces
    (``make_dist_solver_batched``, ``make_dist_solver_multislice_batched``,
    ``make_dist_solver_3d``; JAX ``spike_dist.py:864-993, 1550-1644``):
    ``local_fn(rblk [ppd, nb, b, r]) -> x`` of the same shape.  Sums run
    over the row axis ``red``; the keep-iterating decisions are taken
    over the replica axis ``sync`` where there is one (richardson the
    largest residual of every replica, the solvers ``conv_sync_axis``), so
    every replica takes the same number of trips.  ``pc_many`` / ``pc_one``
    are the multi- and single-RHS PC applies, ``mv_one`` the single-RHS
    matvec; the multi-RHS matvec is ``local_matvec_many`` over ``red``,
    the batched block product, on every route."""
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b

    def to_blocks(X):                       # [ppd * m, r] -> [ppd, nb, b, r]
        return X.reshape(ppd, nb, b, X.shape[-1])

    if ksp_type == "preonly":
        return pc_many
    if ksp_type == "richardson":
        rtol = params.get("rtol", 1e-8)
        maxit = params.get("maxit", 50)

        def local_fn(rblk):
            bnorm2 = red.all_reduce(torch.sum(rblk.square(), dim=(0, 1, 2)))
            bnorm2 = torch.clamp(bnorm2, min=torch.finfo(rblk.dtype).tiny)

            def resid_rel(X):
                R = rblk - local_matvec_many(dsf, X, red)
                rn2 = red.all_reduce(torch.sum(R.square(), dim=(0, 1, 2)))
                rel = torch.sqrt(rn2 / bnorm2).max()[None]
                if sync is not None:
                    rel = sync.all_reduce(rel, "max")
                return R, float(rel)

            # the residual of the CURRENT iterate rides along, so
            # convergence is tested before the next correction is spent
            X = pc_many(rblk)
            R, rel = resid_rel(X)
            it = 1
            while rel > rtol and it < maxit:
                X = X + pc_many(R)
                R, rel = resid_rel(X)
                it += 1
            return X
        return local_fn
    if ksp_type in MANY_SOLVERS:
        method_many = MANY_SOLVERS[ksp_type]

        def local_fn(rblk):
            rloc = rblk.shape[-1]

            def mvm(X):
                return local_matvec_many(dsf, to_blocks(X), red).reshape(
                    ppd * m, rloc)

            def pcm(X):
                return pc_many(to_blocks(X)).reshape(ppd * m, rloc)
            res = method_many(mvm, rblk.reshape(ppd * m, rloc), None,
                              pcm if use_pc else None, axis_name=red,
                              conv_sync_axis=sync, **params)
            return to_blocks(res.x)
        return local_fn
    method = SOLVERS.get(ksp_type)

    def local_fn(rblk):
        cols = [method(mv_one, rblk[..., j].reshape(-1), None,
                       pc_one if use_pc else None, axis_name=red,
                       conv_sync_axis=sync, **params).x
                for j in range(rblk.shape[-1])]
        return to_blocks(torch.stack(cols, dim=-1))
    return local_fn


def _replica_solve_fn(dsf: DistSpikeFactor, rows: MeshAxis, ax_r: MeshAxis,
                      axis_rhs: str, local_fn):
    """``solve(rhs[R, n]) -> x[R, n]`` over a replica axis: row block i of
    ``rhs`` goes to replica i, each replica solves its block over its row
    axis ``rows``, and x is gathered on every rank."""
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b

    def solve_fn(rhs) -> torch.Tensor:
        rhs = torch.as_tensor(rhs)
        R = rhs.shape[0]
        if R % ax_r.size:
            raise ValueError(f"{R} right-hand sides do not split over the "
                             f"{axis_rhs!r} axis of size {ax_r.size}")
        rloc = R // ax_r.size
        mine = rhs[ax_r.rank * rloc:(ax_r.rank + 1) * rloc]      # [Rloc, n]
        r_local = _pad_shard_rhs(dsf, rows, mine.T)       # [ppd * m, Rloc]
        x = local_fn(r_local.reshape(ppd, nb, b, rloc)).reshape(ppd * m,
                                                                 rloc)
        x = _gather_global(dsf, rows, x)                       # [n, Rloc]
        return ax_r.all_gather(x.T.contiguous()).reshape(R, dsf.n)

    return solve_fn


def make_dist_solver_batched(dsf: DistSpikeFactor, mesh: Mesh,
                             axis_p: str = "p", axis_rhs: str = "rhs",
                             ksp_type: str = "gmres", use_pc: bool = True,
                             **params):
    """Multi-RHS serving over a 2-D (``axis_rhs`` x ``axis_p``) mesh (JAX
    ``spike_dist.py:864-993``): each row of the mesh holds a replica of
    the factorization (``dist_spike_factor(band, mesh, axis=axis_p)``)
    and solves its share of the right-hand sides over its partition axis.

    Returns ``solve(rhs[R, n]) -> x[R, n]`` (R divisible by the rhs axis;
    row block i of ``rhs`` goes to mesh row i; x on every rank).
    ``ksp_type``:

    * "preonly": one multi-RHS SPIKE solve of the row's batch;
    * "richardson": multi-RHS refinement X += M^-1 (B - A X) until every
      column of every replica meets ``rtol`` (the largest relative
      residual taken over the replicas, one ``all_reduce``, so every
      replica takes the same number of trips);
    * the ``krylov_many`` engines ("gmres", "bcgs", "cg", ...): one
      batched loop for the row's batch, ``axis_name=axis_p,
      conv_sync_axis=axis_rhs``;
    * any other KSP type: one right-hand side at a time (JAX's
      ``lax.map``), ``conv_sync_axis=axis_rhs``."""
    ax_p, ax_r = mesh.axis(axis_p), mesh.axis(axis_rhs)
    local_fn = _many_local_fn(
        dsf, ksp_type, use_pc, params, red=ax_p, sync=ax_r,
        pc_many=lambda X: local_spike_solve_many(dsf, X, ax_p),
        pc_one=lambda v: local_spike_solve(dsf, v, ax_p),
        mv_one=lambda v: local_matvec(dsf, v, ax_p))
    return _replica_solve_fn(dsf, ax_p, ax_r, axis_rhs, local_fn)


# ---------------------------------------------------------------------------
# Multislice: slices x partitions within a slice, and the 3-D serving mesh
# ---------------------------------------------------------------------------
#
# The rows are split over the (slice, p) plane.  Each slice is factored as
# an exact SPIKE of its own: its tips are all-gathered over the p line
# only and every rank holds its slice's reduced system.  Across slices the
# PC is block-Jacobi (a slice edge is a global edge of the reduced
# system), so a PC apply sends nothing between slices.  The matvec keeps
# the TRUE coupling: its k-wide edge strips ride the ring of the flattened
# plane, and the Krylov sums all_reduce over the plane.

def _plane(mesh: Mesh, axis_slice: str, axis_p: str):
    """``(ax_slice, ax_p, plane)``: the two line axes and the
    ``(slice, p)`` plane axis of this rank."""
    return (mesh.axis(axis_slice), mesh.axis(axis_p),
            mesh.axis((axis_slice, axis_p)))


def dist_spike_factor_multislice(
        band: BandedMatrix, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", method: str = "inv",
        block_b: Optional[int] = None, parts_per_device: int = 1,
        reduced: str = "auto", store_spikes: bool = False,
        store_dtype=None, spike_dtype=None,
        shift: str = "none", shift_amount: float = 0.0,
        inverter: str = "auto", safety_net: bool = True,
        matvec_impl: str = "auto") -> DistSpikeFactor:
    """Factor a global band over a (slice, p) mesh (JAX
    ``spike_dist.py:1062-1116``): exact SPIKE within each slice,
    block-Jacobi across slices, the matvec exact.  K = n_slices *
    per_slice * ppd partitions; the reduced system is this rank's
    slice's.  Every rank passes the same global band.

    The options are :func:`dist_spike_factor`'s; stored V/W spikes come
    from the PC tips (slice edges zeroed).  The safety net's probe is one
    richardson iteration (a PC apply): block-Jacobi across slices is
    inexact by design, so it rejects only a non-finite result or a
    residual above 1e6, and then re-factors with ``inverter='blocked'``.
    The probe's residual comes out of an ``all_reduce``, so every rank
    takes the same decision.  ``matvec_impl``: as in
    :func:`dist_spike_factor`, single right-hand side only (the multi-RHS
    matvec is the batched block product, and a transposed factor carries
    no band rows)."""
    def build(inv):
        return _dist_spike_factor_multislice_impl(
            band, mesh, axis_slice, axis_p, method=method, block_b=block_b,
            parts_per_device=parts_per_device, reduced=reduced,
            store_spikes=store_spikes, store_dtype=store_dtype,
            spike_dtype=spike_dtype, shift=shift,
            shift_amount=shift_amount, inverter=inv,
            matvec_impl=matvec_impl)

    dsf = build(inverter)
    if safety_net:
        from ..solvers.pc import _newton_probe_active
        if _newton_probe_active(inverter):
            probe = banded_matvec(band, torch.ones(band.n, dtype=band.dtype,
                                                   device=band.device))
            res = make_dist_solver_multislice(
                dsf, mesh, axis_slice, axis_p, ksp_type="richardson",
                rtol=1e-30, maxit=1)(probe)
            rel = float(res.rnorm) / float(torch.linalg.norm(probe))
            if not math.isfinite(rel) or rel > 1e6:
                dsf = build("blocked")
    return dsf


def _dist_spike_factor_multislice_impl(
        band: BandedMatrix, mesh: Mesh, axis_slice: str, axis_p: str, *,
        method, block_b, parts_per_device, reduced, store_spikes,
        store_dtype, spike_dtype, shift, shift_amount, inverter,
        matvec_impl: str = "blocks") -> DistSpikeFactor:
    ax_s, ax_p, plane = _plane(mesh, axis_slice, axis_p)
    ppd = parts_per_device
    Ks = ax_p.size * ppd                  # partitions per slice
    K = ax_s.size * Ks
    kl, ku, n = band.kl, band.ku, band.n
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    nb = m // b
    local = _local_band(band, plane.rank, ppd * m, mesh.device)
    route = _resolve_matvec_impl(matvec_impl, local)

    gidx = plane.rank * ppd + torch.arange(ppd, device=mesh.device)
    # the true tips (global edges zeroed), which the matvec takes
    Btip, Ctip = _extract_tips(local.data, ppd, m, k, kl, ku,
                               zero_boundaries=False)
    Btip[gidx == K - 1] = 0
    Ctip[gidx == 0] = 0
    blocks = _partition_blocks(local, ppd, m, b)
    red_fact = V = W = None
    if Ks > 1:
        # the PC tips: a slice edge is a global edge of the PC
        lidx = gidx % Ks
        Btip_pc, Ctip_pc = Btip.clone(), Ctip.clone()
        Btip_pc[lidx == Ks - 1] = 0
        Ctip_pc[lidx == 0] = 0
        fact, Vfull, Wfull = _factor_and_spikes(
            blocks, Btip_pc, Ctip_pc, method=method, shift=shift,
            shift_amount=shift_amount, inverter=inverter, nb=nb, b=b, k=k)
        tips = torch.stack(_tips_of(Vfull, Wfull, nb, b, k), dim=1)
        slice_tips = ax_p.all_gather(tips).reshape(Ks, 4, k, k)
        red_fact, _ = _build_reduced(slice_tips, False, method, reduced,
                                     inverter)
        if store_spikes:
            V, W = Vfull, Wfull
    else:
        fact = _local_factor(blocks, method, shift, shift_amount, inverter)
    fact, V, W, _ = _cast_stored(fact, V, W, None, store_dtype, spike_dtype)
    return DistSpikeFactor(
        blocks=blocks, fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
        red_Dinv=None, V=V, W=W, n=n, K=K, m=m, b=b, k=k, ppd=ppd,
        truncated=False, rank=plane.rank,
        mv_prep=prepare_banded_mv(local) if route == "banded_cuda" else None)


def dist_spike_transpose_multislice(
        dsf: DistSpikeFactor, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", reduced: str = "auto", inverter: str = "auto",
        store_spikes: Optional[bool] = None,
        fast: bool = True) -> DistSpikeFactor:
    """The multislice factorization of A^T on the same factors (JAX
    ``spike_dist.py:1236-1328``): the TRUE tips swap and transpose around
    the ring of the (slice, p) plane, so the A^T matvec keeps the exact
    coupling across slices; the transpose spikes and each slice's reduced
    system come from the tips re-masked at the slice edges, so the
    transposed PC stays block-Jacobi across slices.  ``fast`` as in
    :func:`dist_spike_transpose`; the result takes the blocks route."""
    _require_block_thomas(dsf, "dist_spike_transpose_multislice")
    ax_s, ax_p, plane = _plane(mesh, axis_slice, axis_p)
    ppd, k = dsf.ppd, dsf.k
    Ks = ax_p.size * ppd
    keep = (dsf.V is not None) if store_spikes is None else store_spikes
    sdt = dsf.V.dtype if dsf.V is not None else None
    lidx = ax_p.rank * ppd + torch.arange(ppd, device=dsf.Btip.device)

    def pc_mask(Btip_t, Ctip_t):
        Bs, Cs = Btip_t.clone(), Ctip_t.clone()
        Bs[lidx == Ks - 1] = 0
        Cs[lidx == 0] = 0
        return Bs, Cs

    blocks_t, Btip_t, Ctip_t, factT, Vt, Wt, tips = _transpose_local_parts(
        dsf, plane, spikes=Ks > 1, spike_mask=pc_mask, fast=fast)
    red_fact = None
    if Ks > 1:
        slice_tips = ax_p.all_gather(tips).reshape(Ks, 4, k, k)
        red_fact, _ = _build_reduced(slice_tips, False, dsf.fact.method,
                                     reduced, inverter)
    V, W = _keep_spikes(Vt, Wt, keep, sdt)
    return DistSpikeFactor(blocks=blocks_t, fact=factT, Btip=Btip_t,
                           Ctip=Ctip_t, red_fact=red_fact, red_Dinv=None,
                           V=V, W=W, n=dsf.n, K=dsf.K, m=dsf.m, b=dsf.b,
                           k=k, ppd=ppd, truncated=False, rank=dsf.rank)


def _interface_solve_in_slice(dsf: DistSpikeFactor, g_top, g_bot,
                              ax_p: MeshAxis, impl: str = "auto"):
    """The interface solve of one slice: the values all-gathered over the
    p line only, this slice's reduced system, zero at the slice edges
    (the block-Jacobi PC tips)."""
    return _interface_solve(dsf, g_top, g_bot, ax_p, ax_p.size * dsf.ppd,
                            impl)


def local_spike_solve_multislice(dsf: DistSpikeFactor,
                                 rhs_local: torch.Tensor, ax_p: MeshAxis,
                                 impl: str = "auto") -> torch.Tensor:
    """This rank's PC apply on a (slice, p) mesh: exact SPIKE within the
    slice, block-Jacobi across slices.  The interface vectors are zero
    exactly where the PC tips differ from the true ones (the slice
    edges), so the correction of :func:`_spike_correct` applies as on the
    1-D mesh."""
    nb, b, k, ppd = dsf.nb, dsf.b, dsf.k, dsf.ppd
    rblk = rhs_local.reshape(ppd, nb, b)
    g = _local_tri_solve(dsf, rblk, impl)
    if ax_p.size * ppd == 1:
        return g.reshape(-1)
    xbot_prev, xtop_next = _interface_solve_in_slice(
        dsf, g[:, 0, :k], g[:, nb - 1, b - k:], ax_p, impl)
    x = _spike_correct(dsf, g, rblk, xbot_prev, xtop_next,
                       lambda r2: _local_tri_solve(dsf, r2, impl))
    return x.reshape(-1)


def local_spike_solve_multislice_many(dsf: DistSpikeFactor,
                                      rblk: torch.Tensor, ax_p: MeshAxis,
                                      impl: str = "auto") -> torch.Tensor:
    """The multi-RHS PC apply on a (slice, p) mesh; ``rblk`` ``[ppd, nb,
    b, r]`` -> the same, the factors streamed once for all r."""
    nb, b, k = dsf.nb, dsf.b, dsf.k
    g = _local_tri_solve_many(dsf, rblk, impl)
    if ax_p.size * dsf.ppd == 1:
        return g
    xbot_prev, xtop_next = _interface_solve_in_slice(
        dsf, g[:, 0, :k, :], g[:, nb - 1, b - k:, :], ax_p, impl)
    return _spike_correct(dsf, g, rblk, xbot_prev, xtop_next,
                          lambda r2: _local_tri_solve_many(dsf, r2, impl))


def local_matvec_multislice(dsf: DistSpikeFactor, x_local: torch.Tensor,
                            plane: MeshAxis) -> torch.Tensor:
    """The exact matvec on a (slice, p) mesh: :func:`local_matvec` with the
    edge strips around the ring of the flattened plane (only the
    slice-edge strips cross between slices)."""
    return local_matvec(dsf, x_local, plane)


def make_dist_solver_multislice(dsf: DistSpikeFactor, mesh: Mesh,
                                axis_slice: str = "slice", axis_p: str = "p",
                                ksp_type: str = "gmres", use_pc: bool = True,
                                dsf_transpose: Optional[DistSpikeFactor]
                                = None, nullspace=None,
                                transpose_nullspace=None, **params):
    """The multislice Krylov solver (JAX ``spike_dist.py:1454-1547``): the
    per-slice SPIKE PC, the exact matvec, inner products and null-space
    projections ``all_reduce``d over the (slice, p) plane.  The A^T types
    take ``dsf_transpose=dist_spike_transpose_multislice(dsf, mesh)``.
    Returns ``solve(rhs[n], x0=None) -> KSPResult``, x global on every
    rank."""
    _need_transpose(ksp_type, dsf_transpose,
                    "dist_spike_transpose_multislice(dsf, mesh, ...)")
    _, ax_p, plane = _plane(mesh, axis_slice, axis_p)
    return _krylov_solve_fn(
        dsf, plane, ksp_type, use_pc, dsf_transpose, nullspace,
        transpose_nullspace, params,
        matvec_of=lambda d: (lambda v: local_matvec_multislice(d, v, plane)),
        pc_of=lambda d: (lambda v: local_spike_solve_multislice(d, v, ax_p)))


def _multislice_many_local_fn(dsf: DistSpikeFactor, ksp_type: str,
                              ax_p: MeshAxis, plane: MeshAxis, params: dict,
                              sync_axis: Optional[MeshAxis] = None):
    """The multi-RHS engine on a (slice, p) plane (JAX
    ``spike_dist.py:1550-1644``), behind both the multislice serving
    solver and the 3-D mesh: ``local_fn(rblk [ppd, nb, b, r]) -> x``.  Its
    collectives run on the plane; on a replica mesh ``sync_axis`` keeps
    the replicas' trip counts equal."""
    return _many_local_fn(
        dsf, ksp_type, True, params, red=plane, sync=sync_axis,
        pc_many=lambda X: local_spike_solve_multislice_many(dsf, X, ax_p),
        pc_one=lambda v: local_spike_solve_multislice(dsf, v, ax_p),
        mv_one=lambda v: local_matvec_multislice(dsf, v, plane))


def make_dist_solver_multislice_batched(
        dsf: DistSpikeFactor, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", ksp_type: str = "richardson", **params):
    """Multi-RHS serving on the (slice, p) mesh itself (JAX
    ``spike_dist.py:1647-1693``): the rows span every rank and each rank
    solves all r right-hand sides on its rows.  Returns ``solve(rhs[n, r])
    -> x[n, r]`` on every rank.  ``ksp_type``: "richardson" (refinement
    with the exact matvec, converges to the true solution), "preonly"
    (one PC apply: block-Jacobi across slices, PC-grade), the
    ``krylov_many`` engines, or any other KSP type one column at a time."""
    _, ax_p, plane = _plane(mesh, axis_slice, axis_p)
    local_fn = _multislice_many_local_fn(dsf, ksp_type, ax_p, plane, params)
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b

    def solve_fn(rhs) -> torch.Tensor:
        rhs = torch.as_tensor(rhs)
        r = rhs.shape[1]
        rblk = _pad_shard_rhs(dsf, plane, rhs).reshape(ppd, nb, b, r)
        x = local_fn(rblk).reshape(ppd * m, r)
        return _gather_global(dsf, plane, x)

    return solve_fn


def make_dist_solver_3d(dsf: DistSpikeFactor, mesh: Mesh,
                        axis_rhs: str = "rhs", axis_slice: str = "slice",
                        axis_p: str = "p", ksp_type: str = "richardson",
                        **params):
    """Replicated multislice serving on a 3-D (rhs, slice, p) mesh (JAX
    ``spike_dist.py:1716-1762``): every replica holds the multislice
    factorization (``dist_spike_factor_multislice(band, mesh)`` on the 3-D
    mesh factors over each replica's plane) and solves its row block of
    the right-hand sides.  The engines take their keep-iterating decisions
    over ``axis_rhs``, so the replicas run the same number of trips.
    Returns ``solve(rhs[R, n]) -> x[R, n]`` (R divisible by the rhs axis)
    on every rank."""
    _, ax_p, plane = _plane(mesh, axis_slice, axis_p)
    ax_r = mesh.axis(axis_rhs)
    local_fn = _multislice_many_local_fn(dsf, ksp_type, ax_p, plane, params,
                                         sync_axis=ax_r)
    return _replica_solve_fn(dsf, plane, ax_r, axis_rhs, local_fn)

"""Block-Thomas solve of the SPIKE reduced system through the hand-written
CUDA kernel ``csrc/reduced_thomas.cu``.

No Pallas kernel is its counterpart: the JAX package runs this solve as one
compiled ``lax.scan`` (``spike_petsc_tpu/ops/blocktri.py``), while the
port's plain version (``ops.blocktri.blocktri_solve``) is a Python loop of
3 nb - 2 products and 2 nb - 2 subtractions, about 500 launches a solve of
the flagship's reduced system (nb = 63, B = 200, 32 columns), whose host
time paced the PC apply.  The kernel does the whole solve in one launch.
Its bound is the chain of 3 nb - 2 dependent block products, not the
matrices' 29.9 MB (9 us at 3.35 TB/s) nor their FMAs (7 us at r = 32).

The kernel takes thread block clusters of ``cluster`` blocks, each cluster
``cols`` of the columns and each block an even share of every step's rows,
its matrices streamed by a producer warp through a ring of ``depth`` bulk
copies; ``reduced_thomas_plan`` picks the three from B and r (the single
source of that choice).
"""

from __future__ import annotations

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("reduced_thomas", {
    "reduced_thomas_f32": [P, P, P, P, P, I, I, I, I, I, I, I, P],
    "reduced_thomas_smem": [I, I, I, I],
})

MAX_B = 256
MAX_ROWS = 64
COLS = (1, 2, 4)
RING_BYTES = 96 * 1024
MAX_DEPTH = 8


def reduced_thomas_feasible(fact, rhs) -> bool:
    """Single source of truth for the kernel's applicability: an ``inv``
    block-Thomas factor with no leading dims (``[nb, B, B]``: the SPIKE
    reduced system, B = 2k), F, U and Sinv stored f32, contiguous, 16-byte
    aligned (the bulk copies' reads) and on the right-hand side's device,
    B even and at most 256, and an f32 right-hand side ``[nb, B]`` or
    ``[nb, B, r]`` with any r >= 1.  ``lu``, ``spd`` and cyclic-reduction
    factors, f64, bf16, complex and strided factors take the plain
    solves."""
    if not (isinstance(fact, BlockTriFactor) and fact.method == "inv"):
        return False
    mats = (fact.F, fact.U, fact.Sinv)
    nb, B = fact.F.shape[0], fact.F.shape[-1]
    if any(m.shape != (nb, B, B) or m.dtype != torch.float32
           or m.device != rhs.device or not m.is_contiguous()
           or m.data_ptr() % 16 for m in mats):
        return False
    if B % 2 or not 2 <= B <= MAX_B or rhs.dtype != torch.float32:
        return False
    if rhs.dim() not in (2, 3) or rhs.shape[:2] != (nb, B):
        return False
    return rhs.dim() == 2 or rhs.shape[2] >= 1


def _rows(B: int, cluster: int):
    """Rows a block for clusters of ``cluster`` blocks: ceil(B / cluster),
    made even where B is not a multiple of 4 (each row slab then starts and
    ends on 16 bytes), or None where the last block would have none or a
    block more than 64."""
    rows = -(-B // cluster)
    rows += rows * B % 4 // 2
    if (cluster - 1) * rows >= B or rows > MAX_ROWS:
        return None
    return rows


def reduced_thomas_plan(B: int, r: int, cluster: int | None = None,
                        cols: int | None = None,
                        depth: int | None = None) -> dict:
    """The launch shape for a reduced factor of block size ``B`` and ``r``
    columns: the single source of the kernel's choice.  ``cols``, the
    columns a cluster: 1 for one column, 2 up to 16 columns, else 4.
    ``cluster``, the blocks a cluster: the largest of 8, 4, 2, 1 whose rows
    split B with none left over.  ``depth``: as many row slabs as fit
    96 KB, 2 to 8.  Timed on an H100 at nb = 63, B = 200
    (experiments/torch_lab_reduced.py; device ms a solve): r = 32 at 8
    blocks a cluster 0.198 with 4 columns, 0.209 with 2, 0.283 with 8
    (dropped);
    4 blocks 0.253; 16 blocks of 4 columns 0.209; r = 5: 0.170 with 2
    columns, 0.198 with 4; r = 1: 0.167 at 8 blocks, 0.162 at 16, 0.196
    at 4.  The ring's depth (2 to 8) moved none of them: each step waits
    on the one before, not on its matrix.  Each may be given, for the
    lab."""
    if cols is None:
        cols = 1 if r == 1 else 2 if r <= 16 else 4
    if cols not in COLS:
        raise ValueError(f"cols={cols}: the kernel takes {COLS}")
    if cluster is None:
        cluster = next(c for c in (8, 4, 2, 1) if _rows(B, c) is not None)
    rows = _rows(B, cluster) if 1 <= cluster <= 16 else None
    if rows is None:
        raise ValueError(f"cluster={cluster} does not split B={B} into "
                         f"shares of at most {MAX_ROWS} rows")
    slot = -(-rows * B * 4 // 128) * 128
    if depth is None:
        depth = max(2, min(MAX_DEPTH, RING_BYTES // slot))
    return dict(cluster=cluster, cols=cols, rows=rows, depth=depth,
                warps=-(-rows // 4), clusters=-(-r // cols))


def kernel_config(B: int, r: int, **override) -> dict:
    """``reduced_thomas_plan`` and the shared memory a block takes (from
    the source: builds the kernel, makes no CUDA call)."""
    plan = reduced_thomas_plan(B, r, **override)
    plan["smem_bytes"] = KERNEL.lib().reduced_thomas_smem(
        B, plan["cols"], plan["rows"], plan["depth"])
    return plan


def _launch(fact, rhs, x, ncols, plan) -> None:
    """One launch: the solve of ``rhs`` into ``x``, both contiguous
    ``[nb, B(, ncols)]``."""
    nb, B = fact.F.shape[0], fact.F.shape[-1]
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    KERNEL.launch("reduced_thomas_f32", fact.F.data_ptr(),
                  fact.Sinv.data_ptr(), fact.U.data_ptr(), rhs.data_ptr(),
                  x.data_ptr(), nb, B, ncols, plan["cluster"], plan["cols"],
                  plan["rows"], plan["depth"], stream)


def blocktri_solve_reduced_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                                out: torch.Tensor | None = None,
                                **override) -> torch.Tensor:
    """Block-Thomas solve of an ``inv`` factor ``[nb, B, B]`` in one kernel
    launch.  rhs ``[nb, B]`` or ``[nb, B, r]``; returns x of its shape in
    f32, written into ``out`` (contiguous, of that shape) where given.  A
    CPU tensor takes the plain version (``blocktri_solve``); a CUDA tensor
    launches the kernel and raises on input its rule refuses.
    ``override`` (``cluster``, ``cols``, ``depth``) replaces the plan's
    choice, for the lab."""
    if not rhs.is_cuda:
        x = blocktri_solve(fact, rhs)
        return x if out is None else out.copy_(x)
    if not reduced_thomas_feasible(fact, rhs):
        raise ValueError("reduced Thomas kernel does not take "
                         f"{type(fact).__name__} "
                         f"method={getattr(fact, 'method', None)!r} "
                         f"{tuple(getattr(fact, 'F', rhs).shape)}, rhs "
                         f"{tuple(rhs.shape)} {rhs.dtype} on {rhs.device}")
    if out is None:
        out = torch.empty(rhs.shape, dtype=torch.float32, device=rhs.device)
    elif (out.shape != rhs.shape or out.dtype != torch.float32
          or out.device != rhs.device or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} is not a "
                         f"contiguous f32 {tuple(rhs.shape)} on "
                         f"{rhs.device}")
    r = rhs.shape[2] if rhs.dim() == 3 else 1
    _launch(fact, rhs.contiguous(), out, r,
            reduced_thomas_plan(rhs.shape[1], r, **override))
    return out

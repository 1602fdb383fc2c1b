"""Multi-RHS fused block-Thomas solve through the hand-written CUDA kernel
``csrc/fused_sweep_many.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/fused_sweep.py``
(``blocktri_solve_fused_many_pallas``, ``method='inv'``).  The plain
version is ``ops.blocktri.blocktri_solve`` on ``[K, nb, b, r]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("fused_sweep_many", {
    "fused_sweep_many_f32": [P, P, P, P, P, I, I, I, I, P],
    "fused_sweep_many_bf16": [P, P, P, P, P, I, I, I, I, P],
    "fused_sweep_many_config": [I, I, P],
})

_ENTRY = {torch.float32: "fused_sweep_many_f32",
          torch.bfloat16: "fused_sweep_many_bf16"}
_BLOCK_SIZES = (64, 128)
# the columns of one thread block cluster (two blocks of 16): the wrapper
# pads r with zero columns to a multiple of it
CLUSTER_COLS = 32


def fused_sweep_many_feasible(fact, b: int,
                              rhs_dtype=torch.float32) -> bool:
    """Single source of truth for the kernel's applicability:
    ``method='inv'`` block-Thomas factors stored f32 or bf16, a block size
    of 64 or 128, and an f32 right-hand side.  Any nb and any number of
    columns: the forward results go through device memory, not shared
    memory."""
    if not (isinstance(fact, BlockTriFactor) and fact.method == "inv"):
        return False
    return (fact.F.dtype in _ENTRY and b in _BLOCK_SIZES
            and rhs_dtype == torch.float32)


def kernel_config(b: int, dtype=torch.float32) -> dict:
    """The built kernel's launch shape for block size ``b`` and factors of
    ``dtype``: blocks per cluster, columns per block, consumer warps a block
    (beside one producer warp), ring depth in matrices and shared memory
    bytes, from the source's constants.  Builds the kernel (nvcc); makes no
    CUDA call."""
    out = (ctypes.c_int * 5)()
    code = KERNEL.lib().fused_sweep_many_config(
        b, int(dtype == torch.bfloat16), out)
    if code != 0:
        raise ValueError(f"fused_sweep_many_config: no kernel for b={b}")
    return dict(zip(("cluster", "cols", "warps", "depth", "smem_bytes"),
                    out))


def blocktri_solve_fused_many_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                                   impl: str = "auto") -> torch.Tensor:
    """Batched block-Thomas solve for r right-hand sides, both sweeps in one
    kernel launch.

    fact: ``inv`` factor with leading partition dim K; rhs
    ``[K, nb, b, r]``.  Returns x ``[K, nb, b, r]`` in f32.  A CPU tensor
    takes the plain version (``blocktri_solve``, x in the f32-or-wider sweep
    precision); a CUDA tensor launches the kernel and raises on input it
    does not take; ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not rhs.is_cuda:
        return blocktri_solve(fact, rhs)
    K, nb, b, _ = fact.F.shape
    if not fused_sweep_many_feasible(fact, b, rhs.dtype):
        raise ValueError(
            f"fused multi-RHS sweep kernel does not take "
            f"method={fact.method!r}, factors {fact.F.dtype}, b={b}, "
            f"rhs {rhs.dtype}")
    mats = (fact.F, fact.Sinv, fact.U)
    if any(m.shape != (K, nb, b, b) or m.dtype != fact.F.dtype
           or m.device != rhs.device or not m.is_contiguous() for m in mats):
        raise ValueError("fused multi-RHS sweep kernel needs contiguous F, "
                         f"Sinv, U of one dtype, shape {(K, nb, b, b)}, on "
                         f"{rhs.device}")
    if rhs.dim() != 4 or rhs.shape[:3] != (K, nb, b) or rhs.shape[3] < 1:
        raise ValueError(f"rhs shape {tuple(rhs.shape)} is not "
                         f"{(K, nb, b)} + (r,) with r >= 1")
    # the TMA reads the matrices from 16-byte aligned addresses
    mats = tuple(m.clone() if m.data_ptr() % 16 else m for m in mats)
    # a cluster takes 32 columns: other r take zero columns up to a
    # multiple of 32, sliced off the result
    r = rhs.shape[3]
    rp = -(-r // CLUSTER_COLS) * CLUSTER_COLS
    if rp != r:
        rhs = torch.nn.functional.pad(rhs, (0, rp - r))
    rhs = rhs.contiguous()
    if rhs.data_ptr() % 16:
        rhs = rhs.clone()
    x = torch.empty((K, nb, b, rp), dtype=torch.float32, device=rhs.device)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    KERNEL.launch(_ENTRY[fact.F.dtype], *(m.data_ptr() for m in mats),
                  rhs.data_ptr(), x.data_ptr(), K, nb, b, rp, stream)
    return x if rp == r else x[..., :r].contiguous()

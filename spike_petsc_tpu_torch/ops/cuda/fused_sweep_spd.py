"""Fused block-Thomas solve for symmetric (``method='spd'``) factors
through the hand-written CUDA kernel ``csrc/fused_sweep_spd.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/fused_sweep.py``
(``blocktri_solve_fused_pallas`` on ``method='spd'`` factors, the Pallas
kernel ``_fused_kernel_spd``).  The plain version is
``ops.blocktri.blocktri_solve`` batched over the partition axis.
"""

from __future__ import annotations

import ctypes

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("fused_sweep_spd", {
    "fused_sweep_spd_f32": [P, P, P, P, I, I, I, P],
    "fused_sweep_spd_bf16": [P, P, P, P, I, I, I, P],
    "fused_sweep_spd_config": [I, I, P],
})

_ENTRY = {torch.float32: "fused_sweep_spd_f32",
          torch.bfloat16: "fused_sweep_spd_bf16"}
_BLOCK_SIZES = (64, 128)


def fused_sweep_spd_feasible(fact, b: int, rhs_dtype=torch.float32) -> bool:
    """Single source of truth for the kernel's applicability:
    ``method='spd'`` block-Thomas factors stored f32 or bf16, a block size
    of 64 or 128, and an f32 right-hand side.  Any nb: the forward results
    go through the output in device memory, not shared memory."""
    if not (isinstance(fact, BlockTriFactor) and fact.method == "spd"):
        return False
    return (fact.F.dtype in _ENTRY and b in _BLOCK_SIZES
            and rhs_dtype == torch.float32)


def require_spd_feasible(fact, b: int, rhs_dtype, what: str) -> None:
    """Raise, naming the rule, unless ``fused_sweep_spd_feasible`` admits
    the input."""
    if not fused_sweep_spd_feasible(fact, b, rhs_dtype):
        raise ValueError(
            f"{what} does not take method={fact.method!r}, factors "
            f"{fact.F.dtype}, b={b}, rhs {rhs_dtype}: fused_sweep_spd_feasible "
            f"takes method='spd' factors stored f32 or bf16, block sizes "
            f"{' or '.join(map(str, _BLOCK_SIZES))} and an f32 right-hand "
            f"side; impl='plain' runs the plain sweep")


def spd_block_for(k: int) -> int:
    """The smallest block size the spd sweep kernels take that covers a
    coupling tip of k rows."""
    for b in _BLOCK_SIZES:
        if b >= k:
            return b
    raise ValueError(f"the spd fused sweep kernels take block sizes "
                     f"{_BLOCK_SIZES}, none of which covers a tip of {k} "
                     f"rows")


def check_spd_factor(fact: BlockTriFactor, device, what: str) -> tuple:
    """Raise unless F and Sinv are contiguous ``[K, nb, b, b]`` of one
    dtype on ``device``, 16-byte aligned (the kernels copy them in 16-byte
    pieces).  Returns ``(K, nb, b)``."""
    K, nb, b, _ = fact.F.shape
    mats = (fact.F, fact.Sinv)
    if any(m.shape != (K, nb, b, b) or m.dtype != fact.F.dtype
           or m.device != device or not m.is_contiguous()
           or m.data_ptr() % 16 for m in mats):
        raise ValueError(f"{what} needs contiguous, 16-byte aligned F and "
                         f"Sinv of one dtype, shape {(K, nb, b, b)}, on "
                         f"{device}")
    return K, nb, b


def kernel_config(b: int, dtype=torch.float32) -> dict:
    """The built kernel's launch shape for block size ``b`` and factors of
    ``dtype``: blocks per cluster, compute and copy warps per block, ring
    slots and steps per slot, the source's constants.  Builds the kernel
    (nvcc); makes no CUDA call."""
    out = (ctypes.c_int * 5)()
    code = KERNEL.lib().fused_sweep_spd_config(
        b, int(dtype == torch.bfloat16), out)
    if code != 0:
        raise ValueError(f"fused_sweep_spd_config: no kernel for b={b}")
    return dict(zip(("cluster", "compute_warps", "copy_warps", "depth",
                     "steps_per_slot"), out))


def blocktri_solve_fused_spd_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                                  impl: str = "auto") -> torch.Tensor:
    """Batched symmetric block-Thomas solve, both sweeps in one kernel
    launch.

    fact: ``spd`` factor with leading partition dim K; rhs ``[K, nb, b]``.
    Returns x ``[K, nb, b]`` in f32.  A CPU tensor takes the plain version
    (``blocktri_solve``, x in the f32-or-wider sweep precision); a CUDA
    tensor launches the kernel and raises on input it does not take;
    ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not rhs.is_cuda:
        return blocktri_solve(fact, rhs)
    require_spd_feasible(fact, fact.F.shape[-1], rhs.dtype,
                         "spd fused sweep kernel")
    K, nb, b = check_spd_factor(fact, rhs.device, "spd fused sweep kernel")
    if rhs.shape != (K, nb, b):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} != {(K, nb, b)}")
    rhs = rhs.contiguous()
    if rhs.data_ptr() % 16:         # the kernel copies 16-byte pieces
        rhs = rhs.clone()
    x = torch.empty((K, nb, b), dtype=torch.float32, device=rhs.device)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    KERNEL.launch(_ENTRY[fact.F.dtype], fact.F.data_ptr(),
                  fact.Sinv.data_ptr(), rhs.data_ptr(), x.data_ptr(), K, nb,
                  b, stream)
    return x

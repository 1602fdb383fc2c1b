"""Multi-RHS fused block-Thomas solve for symmetric (``method='spd'``)
factors through the hand-written CUDA kernel
``csrc/fused_sweep_many_spd.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/fused_sweep.py``
(``blocktri_solve_fused_many_pallas`` on ``method='spd'`` factors, the
Pallas kernel ``_fused_kernel_many_spd``).  The plain version is
``ops.blocktri.blocktri_solve`` on ``[K, nb, b, r]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P
from .fused_sweep_spd import (check_spd_factor, fused_sweep_spd_feasible,
                              require_spd_feasible)

KERNEL = CudaKernel("fused_sweep_many_spd", {
    "fused_sweep_many_spd_f32": [P, P, P, P, I, I, I, I, P],
    "fused_sweep_many_spd_bf16": [P, P, P, P, I, I, I, I, P],
    "fused_sweep_many_spd_config": [I, I, P],
})

_ENTRY = {torch.float32: "fused_sweep_many_spd_f32",
          torch.bfloat16: "fused_sweep_many_spd_bf16"}


def fused_sweep_many_spd_feasible(fact, b: int,
                                  rhs_dtype=torch.float32) -> bool:
    """Single source of truth for the kernel's applicability: the same as
    the single-RHS spd kernel's (``method='spd'`` factors stored f32 or
    bf16, b of 64 or 128, an f32 right-hand side), any nb and any number of
    columns."""
    return fused_sweep_spd_feasible(fact, b, rhs_dtype)


def kernel_config(b: int, dtype=torch.float32) -> dict:
    """The built kernel's launch shape for block size ``b`` and factors of
    ``dtype``: blocks per cluster, columns per cluster and ring depth, the
    source's constants.  Builds the kernel (nvcc); makes no CUDA call."""
    out = (ctypes.c_int * 3)()
    code = KERNEL.lib().fused_sweep_many_spd_config(
        b, int(dtype == torch.bfloat16), out)
    if code != 0:
        raise ValueError(f"fused_sweep_many_spd_config: no kernel for b={b}")
    return dict(zip(("cluster", "cols", "depth"), out))


def blocktri_solve_fused_many_spd_cuda(fact: BlockTriFactor,
                                       rhs: torch.Tensor,
                                       impl: str = "auto") -> torch.Tensor:
    """Batched symmetric block-Thomas solve for r right-hand sides, both
    sweeps in one kernel launch.

    fact: ``spd`` factor with leading partition dim K; rhs
    ``[K, nb, b, r]``.  Returns x ``[K, nb, b, r]`` in f32.  A CPU tensor
    takes the plain version (``blocktri_solve``, x in the f32-or-wider
    sweep precision); a CUDA tensor launches the kernel and raises on input
    it does not take; ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not rhs.is_cuda:
        return blocktri_solve(fact, rhs)
    require_spd_feasible(fact, fact.F.shape[-1], rhs.dtype,
                         "spd fused multi-RHS sweep kernel")
    K, nb, b = check_spd_factor(fact, rhs.device,
                                "spd fused multi-RHS sweep kernel")
    if rhs.dim() != 4 or rhs.shape[:3] != (K, nb, b) or rhs.shape[3] < 1:
        raise ValueError(f"rhs shape {tuple(rhs.shape)} is not "
                         f"{(K, nb, b)} + (r,) with r >= 1")
    r = rhs.shape[3]
    # the kernel copies 16-byte rows of 4 columns: other r take zero
    # columns up to a multiple of 4, sliced off the result
    rp = -(-r // 4) * 4
    if rp != r:
        rhs = torch.nn.functional.pad(rhs, (0, rp - r))
    rhs = rhs.contiguous()
    if rhs.data_ptr() % 16:
        rhs = rhs.clone()
    x = torch.empty((K, nb, b, rp), dtype=torch.float32, device=rhs.device)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    KERNEL.launch(_ENTRY[fact.F.dtype], fact.F.data_ptr(),
                  fact.Sinv.data_ptr(), rhs.data_ptr(), x.data_ptr(), K, nb,
                  b, rp, stream)
    return x if rp == r else x[..., :r].contiguous()

"""Block-tridiagonal matvec over chunks of ``kt`` block rows through the
hand-written CUDA kernel ``csrc/blocktri_matvec_grid.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/matvec.py``'s
``blocktri_matvec_pallas(T, x, kt)`` (the Pallas kernel ``_kernel``), with
its name and signature: x and y are ``[nb, b]``.  The TPU wrapper pads the
blocks and x to a multiple of ``kt`` block rows; this kernel reads x as zero
outside ``[0, nb)`` and walks a short last chunk, so nothing is padded.  The
plain version is ``ops.blocktri.blocktri_matvec``.
"""

from __future__ import annotations

import torch

from ..blocktri import BlockTridiagonal, blocktri_matvec
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("blocktri_matvec_grid", {
    "blocktri_matvec_grid_f32": [P, P, P, P, P, I, I, I, P],
    "blocktri_matvec_grid_bf16": [P, P, P, P, P, I, I, I, P],
})

_ENTRY = {torch.float32: "blocktri_matvec_grid_f32",
          torch.bfloat16: "blocktri_matvec_grid_bf16"}
_BLOCK_SIZES = (64, 128)
_MAX_KT = 32         # the chunk's x window must fit beside the ring


def blocktri_matvec_grid_feasible(dtype: torch.dtype, b: int,
                                  kt: int = 8) -> bool:
    """True when the CUDA kernel takes ``[nb, b, b]`` blocks stored in
    ``dtype``: f32 or bf16, b 64 or 128, 1 <= kt <= 32.  ``x`` must be f32
    (checked at the call)."""
    return dtype in _ENTRY and b in _BLOCK_SIZES and 1 <= kt <= _MAX_KT


def blocktri_matvec_pallas(T: BlockTridiagonal, x: torch.Tensor, kt: int = 8,
                           impl: str = "auto") -> torch.Tensor:
    """y = T @ x for a BlockTridiagonal T (``[nb, b, b]`` blocks) and x
    ``[nb, b]``, ``kt`` block rows per thread block.

    A CPU tensor takes the plain version (``blocktri_matvec``, in the
    f32-or-wider sweep precision).  A CUDA tensor launches the kernel (f32
    ``x``, f32 or bf16 blocks) and raises on anything it does not take;
    ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not x.is_cuda:
        return blocktri_matvec(T, x)
    nb, b = T.nb, T.b
    if not blocktri_matvec_grid_feasible(T.dtype, b, kt):
        raise ValueError(f"grid blocktri matvec kernel does not take blocks "
                         f"{T.dtype} of shape {tuple(T.D.shape)} with "
                         f"kt={kt}: blocktri_matvec_grid_feasible takes f32 "
                         f"or bf16, b 64 or 128, 1 <= kt <= {_MAX_KT}")
    if any(m.shape != (nb, b, b) or m.dtype != T.dtype or m.device != x.device
           or not m.is_contiguous() or m.data_ptr() % 16
           for m in (T.D, T.L, T.U)):
        raise ValueError("grid blocktri matvec kernel needs contiguous, "
                         "16-byte aligned D, L, U of one dtype, shape "
                         f"{(nb, b, b)}, on {x.device}")
    if x.shape != (nb, b) or x.dtype != torch.float32:
        raise ValueError(f"grid blocktri matvec kernel needs x f32 of shape "
                         f"{(nb, b)}, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    y = torch.empty((nb, b), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(_ENTRY[T.dtype], T.D.data_ptr(), T.L.data_ptr(),
                  T.U.data_ptr(), x.data_ptr(), y.data_ptr(), nb, b, kt,
                  stream)
    return y

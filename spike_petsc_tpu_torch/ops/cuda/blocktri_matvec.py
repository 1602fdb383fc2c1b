"""Block-tridiagonal matvec through the hand-written CUDA kernel
``csrc/blocktri_matvec.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/matvec.py``
(``blocktri_matvec_dma``).  The TPU version pads the blocks once to its
kernel's chunk grid (``mv_padded_nb``); this kernel computes its own offsets
on the unpadded ``[nb, b, b]`` blocks and reads x as zero beyond its length,
so neither the blocks nor x are padded.  ``blocktri_matvec_plain`` is the
same function in plain PyTorch: the CPU path and the reference the kernel is
held against.  ``blocktri_matvec_chunked_cuda`` is the JAX
``blocktri_matvec_dma_chunked``: a rank's ``[ppd, nb, b, b]`` partitions
through the same kernel as one sequence of ``ppd * nb`` blocks, read in
place.
"""

from __future__ import annotations

import torch

from ..blocktri import BlockTridiagonal, blocktri_matvec
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("blocktri_matvec", {
    "blocktri_matvec_f32": [P, P, P, P, P, I, I, I, P],
    "blocktri_matvec_bf16": [P, P, P, P, P, I, I, I, P],
})

_ENTRY = {torch.float32: "blocktri_matvec_f32",
          torch.bfloat16: "blocktri_matvec_bf16"}
_BLOCK_SIZES = (64, 128)


def blocktri_matvec_feasible(dtype: torch.dtype, b: int) -> bool:
    """True when the CUDA kernel takes ``[nb, b, b]`` blocks stored in
    ``dtype`` with block size ``b``: f32 or bf16, b 64 or 128.  ``x`` must
    be f32 (checked at the call)."""
    return dtype in _ENTRY and b in _BLOCK_SIZES


def blocktri_matvec_plain(t: BlockTridiagonal,
                          x: torch.Tensor) -> torch.Tensor:
    """y = T x for x of length n <= nb * b (zero beyond n), the first n rows:
    ``blocktri_matvec`` on the zero-padded vector, in the f32-or-wider sweep
    precision."""
    n, nb, b = x.shape[0], t.nb, t.b
    xp = torch.nn.functional.pad(x, (0, nb * b - n))
    return blocktri_matvec(t, xp.reshape(nb, b)).reshape(-1)[:n]


def blocktri_matvec_cuda(t: BlockTridiagonal, x: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """y = T x for a ``[nb, b, b]`` BlockTridiagonal and x of length n with
    ``(nb - 1) * b < n <= nb * b`` (x read as zero beyond n; y has n rows).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    (f32 ``x``, f32 or bf16 blocks) and raises on anything it does not take;
    ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not x.is_cuda:
        return blocktri_matvec_plain(t, x)
    nb, b = t.nb, t.b
    if not blocktri_matvec_feasible(t.dtype, b):
        raise ValueError(f"blocktri matvec kernel does not take blocks "
                         f"{t.dtype} of shape {tuple(t.D.shape)}")
    if any(m.shape != (nb, b, b) or m.dtype != t.dtype or m.device != x.device
           or not m.is_contiguous() for m in (t.D, t.L, t.U)):
        raise ValueError("blocktri matvec kernel needs contiguous D, L, U of "
                         f"one dtype, shape {(nb, b, b)}, on {x.device}")
    n = x.shape[0]
    if x.dim() != 1 or x.dtype != torch.float32 \
            or not (nb - 1) * b < n <= nb * b:
        raise ValueError(f"blocktri matvec kernel needs x f32 of length in "
                         f"({(nb - 1) * b}, {nb * b}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(_ENTRY[t.dtype], t.D.data_ptr(), t.L.data_ptr(),
                  t.U.data_ptr(), x.data_ptr(), y.data_ptr(), nb, b, n,
                  stream)
    return y


def blocktri_matvec_chunked_cuda(t: BlockTridiagonal, x: torch.Tensor,
                                 impl: str = "auto") -> torch.Tensor:
    """y = T x for ``ppd`` partitions at once: ``[ppd, nb, b, b]`` blocks
    and x ``[ppd, nb, b]`` -> y ``[ppd, nb, b]`` (the JAX
    ``blocktri_matvec_dma_chunked``, ``ops/pallas/matvec.py:236``).

    The partitions are flattened into one block sequence of ``ppd * nb``
    rows and go through :func:`blocktri_matvec_cuda` as one global system:
    the chunk boundaries couple through L and U, which the SPIKE partition
    blocks hold zero there (``L[:, 0]``, ``U[:, -1]``), so the product is
    each partition's own.  The flattened blocks are views of the stored
    ones, never copies (raises otherwise), so the kernel reads the
    ``[ppd, nb, b, b]`` blocks in place.  A CPU tensor takes the plain
    version on the same flattened sequence."""
    ppd, nb, b = t.D.shape[0], t.D.shape[1], t.D.shape[2]
    flat = BlockTridiagonal(D=t.D.reshape(ppd * nb, b, b),
                            L=t.L.reshape(ppd * nb, b, b),
                            U=t.U.reshape(ppd * nb, b, b))
    if x.is_cuda and impl != "plain" and any(
            f.data_ptr() != m.data_ptr() or not m.is_contiguous()
            for f, m in ((flat.L, t.L), (flat.D, t.D), (flat.U, t.U))):
        raise ValueError("the chunked blocktri matvec reads the "
                         "[ppd, nb, b, b] blocks in place: they must be "
                         "contiguous")
    y = blocktri_matvec_cuda(flat, x.reshape(-1), impl=impl)
    return y.reshape(x.shape)

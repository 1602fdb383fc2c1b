"""f64 banded matvec through the hand-written CUDA kernel
``csrc/band_matvec_f64.cu``: the residual operator of f64-grade refinement.

The counterpart of ``spike_petsc_tpu/ops/pallas/band_matvec.py``'s
``prepare_banded_mv_f64`` / ``banded_matvec_prepared_f64`` (the Pallas
kernel ``_kernel_df64``).  The TPU kernel emulates f64 with hi/lo f32 pairs
because the TPU has no f64 unit; the card computes in FP64, so the layout
here is the f64 band itself in the diagonal-major layout of the f32 kernel
(``PreparedBandMV`` with an f64 ``d3``, the same 8 bytes per entry as the
pair).  The plain version is ``banded_matvec_prepared_plain`` on that layout
(f64 shifted axpys).
"""

from __future__ import annotations

import torch

from ..band import BandedMatrix
from ._build import LL, CudaKernel, I, P
from .band_matvec import (PreparedBandMV, banded_matvec_prepared_plain,
                          prepare_banded_mv)

KERNEL = CudaKernel("band_matvec_f64", {
    "band_matvec_f64": [P, P, P, I, LL, I, I, P],
})

_MAX_WIDTH = 4096    # the f64 x window of one tile must fit shared memory


def banded_mv_f64_feasible(bm: BandedMatrix) -> bool:
    """True when the f64 CUDA kernel takes this band: f64 storage and a
    width whose x window fits one block's shared memory."""
    return bm.dtype == torch.float64 and bm.width <= _MAX_WIDTH


def prepare_banded_mv_f64(bm: BandedMatrix) -> PreparedBandMV:
    """The f64 band in the kernel's diagonal-major layout (one pass over the
    band; hold the result for the lifetime of the operator)."""
    if not banded_mv_f64_feasible(bm):
        raise ValueError(
            f"f64 band matvec kernel does not take {bm.dtype} bands of width "
            f"{bm.width}: banded_mv_f64_feasible takes f64 storage and "
            f"w <= {_MAX_WIDTH}")
    return prepare_banded_mv(bm)


def banded_matvec_prepared_f64(prep: PreparedBandMV, x: torch.Tensor,
                               impl: str = "auto") -> torch.Tensor:
    """y = A @ x in f64 from the prepared f64 layout; x is taken in f64, as
    the JAX function takes it.

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    and raises on a layout it does not take; ``impl="plain"`` runs the plain
    version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    x = x.to(torch.float64)
    if impl == "plain" or not x.is_cuda:
        return banded_matvec_prepared_plain(prep, x)
    if x.shape != (prep.n,):
        raise ValueError(f"f64 band matvec kernel needs x of shape "
                         f"({prep.n},), got {tuple(x.shape)}")
    if prep.d3.device != x.device or prep.d3.dtype != torch.float64 \
            or not prep.d3.is_contiguous() or prep.w > _MAX_WIDTH:
        raise ValueError("f64 band matvec kernel needs a contiguous f64 "
                         f"layout on {x.device} with w <= {_MAX_WIDTH}")
    x = x.contiguous()
    y = torch.empty(prep.n, dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("band_matvec_f64", prep.d3.data_ptr(), x.data_ptr(),
                  y.data_ptr(), prep.n, prep.d3.shape[1], prep.kl, prep.ku,
                  stream)
    return y

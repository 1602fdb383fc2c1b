"""Multi-RHS banded matvec through the hand-written CUDA kernel
``csrc/band_matvec_many.cu``.

No Pallas kernel is its counterpart: the JAX package applies a band to
``[n, r]`` as a column loop of its band kernel or as batched block
products.  The kernel reads the one-time diagonal-major layout of
``band_matvec.prepare_banded_mv`` once for all r columns, in one launch.
``banded_matvec_many_prepared_plain`` is the same function in plain
PyTorch: the CPU path and the reference the kernel is held against.
``band_many_plan`` picks the diagonals a stage and the ring's depth from
the band's width and storage (the single source of that choice).
"""

from __future__ import annotations

import functools

import torch

from ._build import LL, CudaKernel, I, P
from .band_matvec import _MAX_WIDTH, PreparedBandMV

KERNEL = CudaKernel("band_matvec_many", {
    "band_matvec_many_f32": [P, P, P, I, LL, I, I, I, LL, I, I, P],
    "band_matvec_many_bf16": [P, P, P, I, LL, I, I, I, LL, I, I, P],
})

_ENTRY = {torch.float32: "band_matvec_many_f32",
          torch.bfloat16: "band_matvec_many_bf16"}
TILE = 128                # rows a tile (the kernel's kTile)
COLS = 32                 # columns a tile (kCols)
STAGE_BYTES = 40 * 1024   # room for one stage of the ring


def _round128(b: int) -> int:
    return -(-b // 128) * 128


def stage_bytes(dc: int, itemsize: int) -> int:
    """Bytes of one stage at ``dc`` diagonals: the band slab
    ``[dc, TILE]`` and the X window ``[TILE + dc - 1, COLS]`` f32, each
    rounded up to 128 (the kernel's layout)."""
    return (_round128(dc * TILE * itemsize)
            + _round128((TILE + dc - 1) * COLS * 4))


@functools.lru_cache(maxsize=None)
def band_many_plan(kl: int, ku: int, itemsize: int) -> dict:
    """The diagonals a stage (``dc``) and the ring's depth (``stages``) for
    a band of width ``kl + ku + 1`` stored in ``itemsize`` bytes.  ``dc``:
    the whole width where one stage of it fits ``STAGE_BYTES``, else the
    fewest even chunks that do.  ``stages``: 3 where the whole width fits
    (a narrow band: the apply waits on memory, and a deeper ring keeps
    more of it in flight), else 2 (a wide band: its FMAs weigh, and a
    shallow ring leaves room for more blocks an SM)."""
    w = kl + ku + 1
    chunks = next(k for k in range(1, w + 1)
                  if stage_bytes(-(-w // k), itemsize) <= STAGE_BYTES
                  or k == w)
    dc = -(-w // chunks)
    stages = 3 if dc == w else 2
    return dict(dc=dc, chunks=-(-w // dc), stages=stages,
                stage_bytes=stage_bytes(dc, itemsize))


def banded_matvec_many_prepared_plain(prep: PreparedBandMV,
                                      X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the prepared layout: ``w``
    shifted axpys over zero-padded ``X [n, r]``, accumulated in f32 or
    wider (each column is ``banded_matvec_prepared_plain`` of it)."""
    n, r = prep.n, X.shape[1]
    dtype = torch.promote_types(torch.promote_types(prep.d3.dtype, X.dtype),
                                torch.float32)
    Xp = torch.cat([torch.zeros((prep.kl, r), dtype=dtype, device=X.device),
                    X.to(dtype),
                    torch.zeros((prep.ku, r), dtype=dtype, device=X.device)])
    Y = torch.zeros((n, r), dtype=dtype, device=X.device)
    for d in range(prep.w):
        Y += prep.d3[d, :n, None].to(dtype) * Xp[d:d + n]
    return Y


def banded_matvec_many_prepared(prep: PreparedBandMV, X: torch.Tensor,
                                impl: str = "auto") -> torch.Tensor:
    """Y = A @ X for ``X [n, r]`` from the prepared layout.

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    (f32 ``X`` with unit column stride, else a contiguous copy of it; f32
    or bf16 band; any r) and raises on anything it does not take;
    ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if X.dim() != 2 or X.shape[0] != prep.n:
        raise ValueError(f"band matvec needs X of shape ({prep.n}, r), got "
                         f"{tuple(X.shape)}")
    if impl == "plain" or not X.is_cuda:
        return banded_matvec_many_prepared_plain(prep, X)
    if X.dtype != torch.float32:
        raise ValueError(f"multi-RHS band kernel needs f32 X, got {X.dtype}")
    d3 = prep.d3
    if d3.device != X.device or d3.dtype not in _ENTRY \
            or not d3.is_contiguous() or prep.w > _MAX_WIDTH \
            or d3.data_ptr() % 16:
        raise ValueError("multi-RHS band kernel needs a contiguous, 16-byte "
                         f"aligned f32/bf16 layout on {X.device} with w <= "
                         f"{_MAX_WIDTH}")
    r = X.shape[1]
    Y = torch.empty((prep.n, r), dtype=torch.float32, device=X.device)
    if r == 0:
        return Y
    if X.stride(1) != 1 or X.stride(0) < r:
        X = X.contiguous()
    plan = band_many_plan(prep.kl, prep.ku, d3.element_size())
    stream = torch.cuda.current_stream(X.device).cuda_stream
    KERNEL.launch(_ENTRY[d3.dtype], d3.data_ptr(), X.data_ptr(),
                  Y.data_ptr(), prep.n, d3.shape[1], prep.kl, prep.ku, r,
                  X.stride(0), plan["dc"], plan["stages"], stream)
    return Y

"""Block-Thomas solve in two launches (a forward and a backward sweep)
through the hand-written CUDA kernels of ``csrc/sweeps.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/sweeps.py``
(``blocktri_solve_batched_pallas``, the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``): the path of ``spike_solve(sf, r, impl="pallas")``.  It
computes the function of the fused sweep (``fused_sweep.py``) with y going
through device memory between the sweeps.  The plain version is
``ops.blocktri.blocktri_solve`` batched over the partition axis.
"""

from __future__ import annotations

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P
from .fused_sweep import _BLOCK_SIZES as _FUSED_BLOCK_SIZES

KERNEL = CudaKernel("sweeps", {
    "sweeps_fwd_f32": [P, P, P, I, I, I, P],
    "sweeps_fwd_bf16": [P, P, P, I, I, I, P],
    "sweeps_bwd_f32": [P, P, P, P, I, I, I, P],
    "sweeps_bwd_bf16": [P, P, P, P, I, I, I, P],
})

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BLOCK_SIZES = (64, 128)


def sweeps_feasible(fact, b: int, rhs_dtype=torch.float32) -> bool:
    """Single source of truth for the kernels' applicability:
    ``method='inv'`` block-Thomas factors stored f32 or bf16, a block size
    of 64 or 128, and an f32 right-hand side.  Any nb: y goes through device
    memory, not shared memory."""
    if not (isinstance(fact, BlockTriFactor) and fact.method == "inv"):
        return False
    return (fact.F.dtype in _SUFFIX and b in _BLOCK_SIZES
            and rhs_dtype == torch.float32)


def inv_block_for(k: int) -> int:
    """The smallest block size the ``inv`` sweep kernels take (#1 in
    ``fused_sweep.py`` and the two-pass #9 here share 64 and 128) that
    covers a coupling tip of k rows; the tip size itself where neither does
    (k > 128), which both rules then refuse, so the plain sweep runs."""
    for b in sorted(set(_BLOCK_SIZES) & set(_FUSED_BLOCK_SIZES)):
        if b >= k:
            return b
    return k


def blocktri_solve_batched_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                                impl: str = "auto") -> torch.Tensor:
    """Batched block-Thomas solve, one launch per sweep.

    fact: ``inv`` factor with leading partition dim K; rhs ``[K, nb, b]``.
    Returns x ``[K, nb, b]`` (f32 from the kernels).  Other factor methods
    raise, as the JAX ``blocktri_solve_batched_pallas`` does.  A CPU tensor
    takes the plain version (x in the f32-or-wider sweep precision); a CUDA
    tensor launches the two kernels and raises on input they do not take;
    ``impl="plain"`` runs the plain version on any device.
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if not (isinstance(fact, BlockTriFactor) and fact.method == "inv"):
        raise ValueError("the two-pass sweeps require method='inv' factors")
    if impl == "plain" or not rhs.is_cuda:
        return blocktri_solve(fact, rhs)
    K, nb, b, _ = fact.F.shape
    if not sweeps_feasible(fact, b, rhs.dtype):
        raise ValueError(
            f"the two-pass sweep kernels do not take factors {fact.F.dtype}, "
            f"b={b}, rhs {rhs.dtype}: sweeps_feasible takes method='inv' "
            f"factors stored f32 or bf16, block sizes "
            f"{' or '.join(map(str, _BLOCK_SIZES))} and an f32 right-hand "
            f"side; impl='plain' runs the plain sweep")
    mats = (fact.F, fact.Sinv, fact.U)
    if any(m.shape != (K, nb, b, b) or m.dtype != fact.F.dtype
           or m.device != rhs.device or not m.is_contiguous()
           or m.data_ptr() % 16 for m in mats):
        raise ValueError("the two-pass sweep kernels need contiguous, 16-byte "
                         "aligned F, Sinv, U of one dtype, shape "
                         f"{(K, nb, b, b)}, on {rhs.device}")
    if rhs.shape != (K, nb, b):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} != {(K, nb, b)}")
    rhs = rhs.contiguous()
    y = torch.empty((K, nb, b), dtype=torch.float32, device=rhs.device)
    x = torch.empty_like(y)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    sfx = _SUFFIX[fact.F.dtype]
    KERNEL.launch(f"sweeps_fwd_{sfx}", fact.F.data_ptr(), rhs.data_ptr(),
                  y.data_ptr(), K, nb, b, stream)
    KERNEL.launch(f"sweeps_bwd_{sfx}", fact.Sinv.data_ptr(),
                  fact.U.data_ptr(), y.data_ptr(), x.data_ptr(), K, nb, b,
                  stream)
    return x

"""Fused block-Thomas solve through the hand-written CUDA kernel
``csrc/fused_sweep.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/fused_sweep.py``
(``blocktri_solve_fused_pallas``, ``method='inv'``).  The plain version is
``ops.blocktri.blocktri_solve`` batched over the partition axis.

The kernel takes one thread block cluster of c blocks a partition (1, 2
or 4), each block a c-th of every step's rows, its matrices streamed by a
producer warp through a ring of bulk copies; ``fused_sweep_cluster`` is
the plan that picks c (the single source of that choice).
"""

from __future__ import annotations

import ctypes

import torch

from ..blocktri import BlockTriFactor, blocktri_solve
from ._build import CudaKernel, I, P

KERNEL = CudaKernel("fused_sweep", {
    "fused_sweep_f32": [P, P, P, P, P, I, I, I, I, P],
    "fused_sweep_bf16": [P, P, P, P, P, I, I, I, I, P],
    "fused_sweep_config": [I, I, I, P],
})

_ENTRY = {torch.float32: "fused_sweep_f32", torch.bfloat16: "fused_sweep_bf16"}
_BLOCK_SIZES = (64, 128)
# the first design kept a partition's y, (nb + 2) * b f32, in one block's
# shared memory; the rule still admits those shapes and no others
_RULE_BYTES = 227 * 1024
CLUSTER_SIZES = (1, 2, 4)


def fused_sweep_feasible(fact, b: int, rhs_dtype=torch.float32) -> bool:
    """Single source of truth for the kernel's applicability (the
    counterpart of the JAX ``fused_sweep_feasible``): ``method='inv'``
    block-Thomas factors stored f32 or bf16, a block size of 64 or 128, an
    f32 right-hand side, and ``(nb + 2) * b * 4 <= 227 KB`` (nb <= 452 at
    b = 128, 906 at b = 64).  The kernel keeps y in the output, not in
    shared memory, and takes any nb; the nb limit is the first design's,
    kept so that ``sweep_route`` sends every factor where it did (longer
    partitions to the two-pass sweeps #9)."""
    if not (isinstance(fact, BlockTriFactor) and fact.method == "inv"):
        return False
    if fact.F.dtype not in _ENTRY or b not in _BLOCK_SIZES \
            or rhs_dtype != torch.float32:
        return False
    return (fact.nb + 2) * b * 4 <= _RULE_BYTES


def fused_sweep_cluster(K: int, nb: int, b: int, sms: int) -> int:
    """c, the blocks of the thread block cluster that takes each of K
    partitions (nb block rows of size b) on a card of ``sms`` SMs: the
    single source of the kernel's choice.  The largest of 4 and 2 with
    K c <= sms, so that the grid fills the SMs at most once; else 1 (one
    block a partition, K > sms / 2).  Measured on an H100 (csrc/
    fused_sweep.cu, experiments/torch_lab_fused_sweep.py): 2 at the
    flagship (K = 64: 4 puts two blocks on an SM and was 11% slower, 1 was
    19% slower); 4 at K = 16 (8, with two carry sends a lane, was 8-16%
    slower) and at K = 1 (8 tied), so the kernel has no c = 8; at
    K = 512, 1 and 2 within 2% of each other.  b is checked and does not
    change the choice (b / c rows a block: 16 at the least).  ``nb`` is
    not read: the signature is that of #9's plan (``sweeps_chunks``), and
    no measured shape's best c depended on nb (K = 1, nb = 157 and the
    flagship's nb = 123 both took the rule's c)."""
    if b not in _BLOCK_SIZES:
        raise ValueError(f"no cluster plan for b={b}: the kernel takes "
                         f"{' or '.join(map(str, _BLOCK_SIZES))}")
    for c in reversed(CLUSTER_SIZES[1:]):
        if K * c <= sms:
            return c
    return 1


def kernel_config(b: int, dtype=torch.float32, cluster: int = 1) -> dict:
    """The built kernel's launch shape for block size ``b``, factors of
    ``dtype`` and clusters of ``cluster`` blocks: compute warps a block
    (plus one producer warp), ring slots (one step's slab each) and shared
    memory bytes a block, the source's constants.  Builds the kernel
    (nvcc); makes no CUDA call."""
    out = (ctypes.c_int * 3)()
    code = KERNEL.lib().fused_sweep_config(
        b, int(dtype == torch.bfloat16), cluster, out)
    if code != 0:
        raise ValueError(f"fused_sweep_config: no kernel for b={b}, "
                         f"cluster={cluster}")
    return dict(zip(("compute_warps", "depth", "smem_bytes"), out))


def device_sms(device) -> int:
    """The SM count of a CUDA device: the plans' (#1's clusters, #9's
    chunks) measure of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocktri_solve_fused_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                              impl: str = "auto",
                              cluster: int | None = None) -> torch.Tensor:
    """Batched block-Thomas solve, both sweeps in one kernel launch.

    fact: ``inv`` factor with leading partition dim K; rhs ``[K, nb, b]``.
    Returns x ``[K, nb, b]`` in f32.  A CPU tensor takes the plain version
    (``blocktri_solve``, x in the f32-or-wider sweep precision);
    a CUDA tensor launches the kernel and raises on input it does not take;
    ``impl="plain"`` runs the plain version on any device.  ``cluster``
    overrides the plan ``fused_sweep_cluster`` (1, 2 or 4 blocks a
    partition).
    """
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}: expected auto, cuda, plain")
    if impl == "plain" or not rhs.is_cuda:
        return blocktri_solve(fact, rhs)
    K, nb, b, _ = fact.F.shape
    if not fused_sweep_feasible(fact, b, rhs.dtype):
        raise ValueError(
            f"fused sweep kernel does not take method={fact.method!r}, "
            f"factors {fact.F.dtype}, b={b}, nb={nb}, rhs {rhs.dtype}")
    mats = (fact.F, fact.Sinv, fact.U)
    if any(m.shape != (K, nb, b, b) or m.dtype != fact.F.dtype
           or m.device != rhs.device or not m.is_contiguous() for m in mats):
        raise ValueError("fused sweep kernel needs contiguous F, Sinv, U of "
                         f"one dtype, shape {(K, nb, b, b)}, on {rhs.device}")
    if rhs.shape != (K, nb, b):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} != {(K, nb, b)}")
    if cluster is None:
        cluster = fused_sweep_cluster(K, nb, b, device_sms(rhs.device))
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}: the kernel takes "
                         f"{', '.join(map(str, CLUSTER_SIZES))}")
    # the bulk copies read the matrices from 16-byte aligned addresses
    mats = tuple(m.clone() if m.data_ptr() % 16 else m for m in mats)
    rhs = rhs.contiguous()
    x = torch.empty((K, nb, b), dtype=torch.float32, device=rhs.device)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    KERNEL.launch(_ENTRY[fact.F.dtype], *(m.data_ptr() for m in mats),
                  rhs.data_ptr(), x.data_ptr(), K, nb, b, cluster, stream)
    return x

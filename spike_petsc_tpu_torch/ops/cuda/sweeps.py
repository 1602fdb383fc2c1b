"""Block-Thomas solve in two launches (a forward and a backward sweep)
through the hand-written CUDA kernels of ``csrc/sweeps.cu``.

The counterpart of ``spike_petsc_tpu/ops/pallas/sweeps.py``
(``blocktri_solve_batched_pallas``, the Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel``): the path of ``spike_solve(sf, r, impl="pallas")``.  It
computes the function of the fused sweep (``fused_sweep.py``) with y going
through device memory between the sweeps.  The plain version is
``ops.blocktri.blocktri_solve`` batched over the partition axis.

Few long partitions take the chunked scan (``sweeps_chunks``, the plan:
each partition cut into C chunks, one thread block each, joined by a
carry pass); ``blocktri_solve_chunked_model`` writes its split in plain
PyTorch for the tests.
"""

from __future__ import annotations

import torch

from ..blocktri import BlockTriFactor, blocktri_solve, sweep_precision
from ._build import CudaKernel, I, P
from .fused_sweep import _BLOCK_SIZES as _FUSED_BLOCK_SIZES
from .fused_sweep import device_sms
from .fused_sweep_spd import spd_block_for

KERNEL = CudaKernel("sweeps", {
    "sweeps_fwd_f32": [P, P, P, I, I, I, P],
    "sweeps_fwd_bf16": [P, P, P, I, I, I, P],
    "sweeps_bwd_f32": [P, P, P, P, I, I, I, P],
    "sweeps_bwd_bf16": [P, P, P, P, I, I, I, P],
    "sweeps_chunked_fwd_f32": [P, P, P, I, I, I, I, P, P, P],
    "sweeps_chunked_fwd_bf16": [P, P, P, I, I, I, I, P, P, P],
    "sweeps_chunked_bwd_f32": [P, P, P, P, I, I, I, I, P, P, P],
    "sweeps_chunked_bwd_bf16": [P, P, P, P, I, I, I, I, P, P, P],
})

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BLOCK_SIZES = (64, 128)

# The chunk plan's cost model, microseconds on an H100 (csrc/sweeps.cu
# describes both designs; the constants are medians measured there with
# experiments/torch_lab_sweeps.py, f32 factors).  One block a partition
# takes _SEQ_US a block row for both sweeps (b = 64: 2.25 ms at nb = 1563;
# b = 128: 0.92 ms at nb = 301).  The chunked scan with L = ceil(nb / C)
# rows a chunk takes L _ROW_US (a row's three b x b x b products of phase 1
# and three matrix-vector steps of phase 3, each with its wait and block
# barrier), 2 (C - 2) _CHAIN_US (phase 2's chained steps, forward and
# backward) and four grid barriers.  The plan takes the C of least time:
# C > 1 where that beats one block a partition, which needs few partitions
# (K C <= the SM count) and long ones, since phase 1 costs ~6x a row of the
# sequential sweep.
_SEQ_US = {64: 1.44, 128: 3.0}
_ROW_US = {64: 8.7, 128: 28.9}
_CHAIN_US = {64: 0.35, 128: 0.68}
_BARRIER_US = 1.5
_MIN_CHUNK_ROWS = 4          # at fewer, phase 2's chain is the sweep again


def _chunked_us(nb: int, b: int, C: int) -> float:
    return (-(-nb // C) * _ROW_US[b] + 2 * (C - 2) * _CHAIN_US[b]
            + 4 * _BARRIER_US)


def sweeps_chunks(K: int, nb: int, b: int, sms: int) -> int:
    """C, the chunks of each partition the two-pass sweep kernels cut a
    solve of K partitions of nb block rows of size b into, on a card of
    ``sms`` SMs: the single source of the kernels' choice.  1 runs one
    thread block a partition; C > 1 the chunked scan of K C blocks, at most
    one an SM (the launch is cooperative), each chunk of at least
    _MIN_CHUNK_ROWS rows.  Among those the C of least modelled time."""
    if b not in _SEQ_US:
        raise ValueError(f"no chunk plan for b={b}: the kernels take "
                         f"{' or '.join(map(str, _BLOCK_SIZES))}")
    best, best_us = 1, nb * _SEQ_US[b]
    for C in range(2, min(nb // _MIN_CHUNK_ROWS, sms // K) + 1):
        us = _chunked_us(nb, b, C)
        if us < best_us:
            best, best_us = C, us
    return best


def sweeps_chunk_bounds(nb: int, chunks: int) -> list:
    """Chunk c covers block rows ``[bounds[c], bounds[c + 1])`` (the
    kernels' ``chunk_start``); none is empty when chunks <= nb."""
    return [c * nb // chunks for c in range(chunks + 1)]


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


def default_block(block, k: int, method: str, on_cuda: bool):
    """The block of a factor of tip size ``k``: ``block`` where the caller
    names one; else on the CPU None (the tip size, as in JAX), and on the
    card the smallest block the sweep kernels of ``method`` take that covers
    the tip (``spd_block_for``, ``inv_block_for``: 64 or 128).  Partition
    rows round up to a multiple of the block, so on the card the partition
    boundaries of a K > 1 factor are not those of the CPU."""
    if block is not None or not on_cuda:
        return block
    return spd_block_for(k) if method == "spd" else inv_block_for(k)


def blocktri_solve_batched_cuda(fact: BlockTriFactor, rhs: torch.Tensor,
                                impl: str = "auto",
                                chunks: int | None = None) -> torch.Tensor:
    """Batched block-Thomas solve, one launch per sweep.

    fact: ``inv`` factor with leading partition dim K; rhs ``[K, nb, b]``.
    Returns x ``[K, nb, b]`` (f32 from the kernels).  Other factor methods
    raise, as the JAX ``blocktri_solve_batched_pallas`` does.  A CPU tensor
    takes the plain version (x in the f32-or-wider sweep precision); a CUDA
    tensor launches the two kernels and raises on input they do not take;
    ``impl="plain"`` runs the plain version on any device.  ``chunks``
    overrides the plan ``sweeps_chunks`` (1 <= chunks <= nb, K chunks <= the
    card's SMs where chunks > 1).
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
    sms = device_sms(rhs.device)
    C = sweeps_chunks(K, nb, b, sms) if chunks is None else chunks
    if not 1 <= C <= nb or (C > 1 and K * C > sms):
        raise ValueError(f"chunks={C} for K={K}, nb={nb}: the chunked scan "
                         f"takes 1 <= chunks <= nb and K * chunks <= {sms} "
                         f"(one block an SM)")
    rhs = rhs.contiguous()
    if rhs.data_ptr() % 16:          # the chunked scan copies r by 16 bytes
        rhs = rhs.clone()
    y = torch.empty((K, nb, b), dtype=torch.float32, device=rhs.device)
    x = torch.empty_like(y)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    sfx = _SUFFIX[fact.F.dtype]
    if C == 1:
        KERNEL.launch(f"sweeps_fwd_{sfx}", fact.F.data_ptr(), rhs.data_ptr(),
                      y.data_ptr(), K, nb, b, stream)
        KERNEL.launch(f"sweeps_bwd_{sfx}", fact.Sinv.data_ptr(),
                      fact.U.data_ptr(), y.data_ptr(), x.data_ptr(), K, nb,
                      b, stream)
        return x
    # a chunk's P [b, b], z [b] and carry [b] (``Work`` in csrc/sweeps.cu)
    work = torch.empty(K * C * (b * b + 2 * b), dtype=torch.float32,
                       device=rhs.device)
    bar = torch.zeros(2, dtype=torch.int32, device=rhs.device)
    KERNEL.launch(f"sweeps_chunked_fwd_{sfx}", fact.F.data_ptr(),
                  rhs.data_ptr(), y.data_ptr(), K, nb, b, C, work.data_ptr(),
                  bar.data_ptr(), stream)
    KERNEL.launch(f"sweeps_chunked_bwd_{sfx}", fact.Sinv.data_ptr(),
                  fact.U.data_ptr(), y.data_ptr(), x.data_ptr(), K, nb, b, C,
                  work.data_ptr(), bar.data_ptr() + 4, stream)
    return x


def blocktri_solve_chunked_model(fact: BlockTriFactor, rhs: torch.Tensor,
                                 chunks: int) -> torch.Tensor:
    """The chunked scan's split of the two sweeps in plain PyTorch
    (``torch.matmul``), for the tests: each partition cut into ``chunks``
    chunks by ``sweeps_chunk_bounds``.  Per sweep, phase 1 runs each chunk
    but the starting one (chunk 0 forward, the last backward) from a zero
    carry, keeping its last value z and its propagator P (the product of
    -F_i; of -Sinv_i U_i), and solves the starting chunk outright; phase 2
    chains the carries, carry_next = z + P carry; phase 3 sweeps every other
    chunk again from its carry.  ``chunks=1`` is the sequential sweep.
    fact: ``inv``, ``[K, nb, b, b]``; rhs ``[K, nb, b]``; x in the sweep
    precision."""
    K, nb, b, _ = fact.F.shape
    dt = sweep_precision(fact.F, rhs)
    F, U, S = (m.to(dt) for m in (fact.F, fact.U, fact.Sinv))
    r = rhs.to(dt)
    cut = sweeps_chunk_bounds(nb, chunks)

    def mv(A, v):
        return torch.matmul(A, v[..., None])[..., 0]

    def forward(rows, prev, out):               # y_i = r_i - F_i y_{i-1}
        for i in rows:
            prev = r[:, i] if i == 0 else r[:, i] - mv(F[:, i], prev)
            out[i] = prev
        return prev

    def backward(rows, prev, out):      # x_i = Sinv_i (y_i - U_i x_{i+1})
        for i in rows:
            t = y[i] if i == nb - 1 else y[i] - mv(U[:, i], prev)
            prev = out[i] = mv(S[:, i], t)
        return prev

    y, x = [None] * nb, [None] * nb
    z, P, carry = [None] * chunks, [None] * chunks, [None] * chunks
    for c in range(chunks):                     # forward, phase 1
        s, e = cut[c], cut[c + 1]
        if c == 0:
            z[c] = forward(range(s, e), None, y)
            continue
        z[c], P[c] = r[:, s], -F[:, s]
        for i in range(s + 1, e):
            z[c] = r[:, i] - mv(F[:, i], z[c])
            P[c] = -torch.matmul(F[:, i], P[c])
    for c in range(1, chunks):                  # phase 2
        carry[c] = z[0] if c == 1 else z[c - 1] + mv(P[c - 1], carry[c - 1])
    for c in range(1, chunks):                  # phase 3
        forward(range(cut[c], cut[c + 1]), carry[c], y)

    last = chunks - 1
    for c in range(chunks):                     # backward, phase 1
        s, e = cut[c], cut[c + 1]
        if c == last:
            z[c] = backward(range(e - 1, s - 1, -1), None, x)
            continue
        z[c], P[c] = mv(S[:, e - 1], y[e - 1]), -torch.matmul(S[:, e - 1],
                                                              U[:, e - 1])
        for i in range(e - 2, s - 1, -1):
            z[c] = mv(S[:, i], y[i] - mv(U[:, i], z[c]))
            P[c] = -torch.matmul(S[:, i], torch.matmul(U[:, i], P[c]))
    for c in range(last - 1, -1, -1):           # phase 2
        carry[c] = (z[last] if c == last - 1
                    else z[c + 1] + mv(P[c + 1], carry[c + 1]))
    for c in range(last):                       # phase 3
        backward(range(cut[c + 1] - 1, cut[c] - 1, -1), carry[c], x)
    return torch.stack(x, dim=1)

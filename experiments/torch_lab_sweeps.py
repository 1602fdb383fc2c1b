#!/usr/bin/env python3
"""Check and time the two-pass sweep kernels (#9, ``csrc/sweeps.cu``) on
one CUDA card at a range of chunk counts C, or trace the phases of their
chunked scan.

    python3 experiments/torch_lab_sweeps.py [C ...]
    python3 experiments/torch_lab_sweeps.py --trace [C ...]

At BASELINE config 1's factor (the tridiagonal Laplacian at n = 1e5 with
the ``lu`` PC's card block 64: K = 1, nb = 1563), f32 and bf16-stored, and
at K = 1, b = 128, nb = 301; K = 2 and 4, b = 64, nb = 400 (dominant random
bands), each C given (default 1 2 3 8 16 33 66 100 132, those that fit:
C <= nb, K C <= the SM count) and the plan's (``sweeps_chunks``) runs the
kernels on a random right-hand side against the plain sweep (relative
max-abs error, within 1e-5) and is timed with CUDA events (median and
spread of the two launches, ms).  One JSON line a run, after the card's
name and power limit and the compiler's register report.

``--trace`` builds a copy of the source under ``build/lab/`` with timers
added (the global timer at each phase's end, clock64 around the parts of
a step, by thread 0 of each block) and runs config 1's factor (f32 and
bf16) at each C given (default the plan's) once: per sweep, the
microseconds to the end of phase 1 (the slowest block), of the chain, and
of phase 3, and the cycles of a step's parts in block 1 (a propagating
chunk) and in the chain's block.  The timers slow the traced build (on
an H100 at config 1, C = 131: 100 + 139 us for the two sweeps, where
chip_smoke.py times the untraced pair at ~0.205 ms), so read its parts
as shares.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import KERNEL_TOL, kernel_err, time_ms  # noqa: E402

LAB_DIR = ROOT / "build" / "lab"

DEFAULT_CHUNKS = (1, 2, 3, 8, 16, 33, 66, 100, 132)


def factors(device):
    """(label, factor) for each shape of the lab."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.convert import banded_from_numpy
    from spike_petsc_tpu_torch.ops.blocktri import cast_factor
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import random_band
    n = 100_000
    lap = spike_factor(banded_from_numpy(
        np.tile(np.float32([-1, 2, -1]), (n, 1)), 1, 1, device=device),
        K=1, block_b=64).fact
    yield "config1 f32", lap
    yield "config1 bf16", cast_factor(lap, torch.bfloat16)
    for K, nb, b, k in ((1, 301, 128, 60), (2, 400, 64, 20),
                        (4, 400, 64, 20)):
        band = banded_from_numpy(random_band(K * nb * b, k, k, seed=nb + K,
                                             dtype=np.float32), k, k,
                                 device=device)
        yield f"K={K} nb={nb} b={b}", spike_factor(band, K=K,
                                                   block_b=b).fact


def traced_source() -> str:
    """csrc/sweeps.cu with timers: g_trace[kernel][block][6] holds the
    global timer at the kernel's start, around both grid barriers and at
    its end; g_cyc[kernel][block][8] sums clock64 spans of a phase-1 step
    (0 the product, 1 the rest), of a copy-ring wait (2) and of a bulk-ring
    step (3 the mbarrier wait, 4 the block barrier, 5 the next copy's
    issue, 6 the step, 7 the count)."""
    s = (ROOT / "spike_petsc_tpu_torch/csrc/sweeps.cu").read_text()

    def rep(old, new):
        nonlocal s
        if old not in s:
            raise RuntimeError(f"the source changed; no {old[:60]!r}")
        s = s.replace(old, new, 1)
    rep("namespace chunked {\n", """namespace chunked {
__device__ long long g_trace[2][132][6];
__device__ long long g_cyc[2][132][8];
__device__ int g_kind[132];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define TR(k, i) if (threadIdx.x == 0 && blockIdx.x < 132) \\
  g_trace[k][blockIdx.x][i] = gtime();
#define CY(i, t) if (threadIdx.x == 0 && blockIdx.x < 132) \\
  g_cyc[g_kind[blockIdx.x]][blockIdx.x][i] += t;
""")
    rep("""  matmul<B, PACK>(slot, M, acc);
  float o[B / 64];
  matvec<B, PACK, R::kLd>(slot, z, o);
  __syncthreads();                           // every thread has read M
  store_tiles<B>(M, acc, sm);""", """  long long c0_ = clock64();
  matmul<B, PACK>(slot, M, acc);
  long long c1_ = clock64();
  float o[B / 64];
  matvec<B, PACK, R::kLd>(slot, z, o);
  __syncthreads();                           // every thread has read M
  store_tiles<B>(M, acc, sm);
  CY(0, c1_ - c0_) CY(1, clock64() - c1_)""")
    rep("""      mbar_wait(smem_u32(ring.bars + k), (phases >> k) & 1u);
      phases ^= 1u << k;
      __syncthreads();
      if (threadIdx.x == 0 && jn < n) ring.issue(item(jn), jn);
    } else {""", """      long long w0_ = clock64();
      mbar_wait(smem_u32(ring.bars + k), (phases >> k) & 1u);
      long long w1_ = clock64();
      phases ^= 1u << k;
      __syncthreads();
      long long w2_ = clock64();
      if (threadIdx.x == 0 && jn < n) ring.issue(item(jn), jn);
      long long w3_ = clock64();
      step(j, static_cast<const uint32_t*>(ring.slot(j)));
      CY(3, w1_ - w0_) CY(4, w2_ - w1_) CY(5, w3_ - w2_)
      CY(6, clock64() - w3_) CY(7, 1)
      continue;
    } else {""")
    rep("""      cp_async_wait<D - 2>();
      __syncthreads();
      ring.issue(jn < n ? item(jn) : none, jn);""",
        """      long long w0_ = clock64();
      cp_async_wait<D - 2>();
      __syncthreads();
      CY(2, clock64() - w0_)
      ring.issue(jn < n ? item(jn) : none, jn);""")
    for k, kern in ((0, "chunked_fwd_kernel"), (1, "chunked_bwd_kernel")):
        start = s.index("{\n", s.index(kern + "(")) + 2
        s = (s[:start] + f"  TR({k}, 0)\n  if (threadIdx.x == 0 && "
             f"blockIdx.x < 132) g_kind[blockIdx.x] = {k};\n" + s[start:])
        for i, call in ((1, "grid_barrier(bar, gridDim.x);"),
                        (3, "grid_barrier(bar, 2 * gridDim.x);")):
            at = s.index(call, start)
            s = (s[:at] + f"TR({k}, {i}) {call} TR({k}, {i + 1})"
                 + s[at + len(call):])
        end = s.index("\n}\n", at)
        s = s[:end] + f"\n  __syncthreads(); TR({k}, 5)" + s[end:]
    rep("const char* sweeps_error_string",
        """int sweeps_trace(void* t, void* c) {
  cudaMemcpyFromSymbol(c, chunked::g_cyc, sizeof(chunked::g_cyc));
  return static_cast<int>(
      cudaMemcpyFromSymbol(t, chunked::g_trace, sizeof(chunked::g_trace)));
}

int sweeps_trace_reset() {
  static long long zero[2 * 132 * 8] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(chunked::g_cyc, zero, sizeof(zero)));
}

const char* sweeps_error_string""")
    return s


def trace(argv, device) -> int:
    import ctypes
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.cuda._build import NVCC_FLAGS, _nvcc
    LAB_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = LAB_DIR / "sweeps_trace.cu", LAB_DIR / "sweeps_trace.so"
    src.write_text(traced_source())
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in csw.KERNEL.functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.sweeps_error_string.argtypes = [ctypes.c_int]
    lib.sweeps_error_string.restype = ctypes.c_char_p
    lib.sweeps_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    csw.KERNEL._lib = lib                    # the traced build takes over
    sms = csw.device_sms(device)
    for label, fact in factors(device):
        if not label.startswith("config1"):
            continue
        K, nb, b, _ = fact.F.shape
        r = torch.randn((K, nb, b), device=device)
        for C in [int(a) for a in argv] or [csw.sweeps_chunks(K, nb, b,
                                                              sms)]:
            for _ in range(3):
                csw.blocktri_solve_batched_cuda(fact, r, chunks=C)
            torch.cuda.synchronize()
            lib.sweeps_trace_reset()
            csw.blocktri_solve_batched_cuda(fact, r, chunks=C)
            torch.cuda.synchronize()
            t = np.zeros((2, 132, 6), dtype=np.int64)
            cyc = np.zeros((2, 132, 8), dtype=np.int64)
            lib.sweeps_trace(t.ctypes.data, cyc.ctypes.data)
            for k, name in ((0, "forward"), (1, "backward")):
                us = (t[k, :C] - t[k, :C, 0].min()) / 1e3
                chain = 0 if k == 0 else C - 1
                steps = (-(-nb // C)) * (1 + k)

                def parts(c):
                    n = max(int(c[7]), 1)
                    return {"mbar_wait": c[3] / n, "block_barrier": c[4] / n,
                            "issue": c[5] / n, "step": c[6] / n}
                print(json.dumps({
                    "shape": label, "C": C, "sweep": name,
                    "phase1_end_us": float(us[:, 1].max()),
                    "chain_end_us": float(us[chain, 3]),
                    "end_us": float(us[:, 5].max()),
                    "block1_product_cycles": float(cyc[k, 1, 0] / (steps - 1)),
                    "block1_rest_cycles": float(cyc[k, 1, 1] / (steps - 1)),
                    "block1_copy_wait_cycles": float(cyc[k, 1, 2] / steps),
                    "block1_phase3_step_cycles": parts(cyc[k, 1]),
                    "chain_step_cycles": parts(cyc[k, chain])}))
    return 0


def main(argv) -> int:
    import torch
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.cuda._build import build_all
    if not torch.cuda.is_available():
        print("torch_lab_sweeps: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if argv[:1] == ["--trace"]:
        return trace(argv[1:], device)
    _, logs = build_all([csw.KERNEL])
    for line in logs.get("sweeps", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    wanted = [int(a) for a in argv] or list(DEFAULT_CHUNKS)
    sms = csw.device_sms(device)
    gen = torch.Generator(device=device).manual_seed(7)
    ok = True
    for label, fact in factors(device):
        K, nb, b, _ = fact.F.shape
        plan = csw.sweeps_chunks(K, nb, b, sms)
        r = torch.randn((K, nb, b), generator=gen, device=device)
        plain = csw.blocktri_solve_batched_cuda(fact, r, impl="plain")
        for C in sorted({plan, *wanted}):
            if C > nb or (C > 1 and K * C > sms):
                continue
            diff, err = kernel_err(
                csw.blocktri_solve_batched_cuda(fact, r, chunks=C), plain)
            torch.cuda.synchronize()
            ms = time_ms(lambda: csw.blocktri_solve_batched_cuda(
                fact, r, chunks=C), iters=10)
            ok &= err <= KERNEL_TOL
            print(json.dumps({
                "shape": label, "K": K, "nb": nb, "b": b, "C": C,
                "plan": C == plan, "ms": ms[0], "spread_ms": ms[1],
                "max_abs_err": diff, "rel_err": err,
                "within_tol": err <= KERNEL_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time versions of the multi-RHS sweep kernel (``inv`` factors) on one
CUDA card.

    python3 experiments/torch_lab_many.py LABEL=SOURCE[:NAME=VALUE,...] ...

Each argument names a CUDA source with the C interface of
``spike_petsc_tpu_torch/csrc/fused_sweep_many.cu`` (the entry points
``fused_sweep_many_f32`` and ``_bf16``), optionally with constants to
change: each NAME=VALUE rewrites the source's one ``constexpr int NAME =
...;`` line (for instance ``kRingBytes=192*1024``) in a copy under
``build/lab/``.  Every version is built there with the port's nvcc flags,
all builds started together.
Then, at the flagship (n = 1e6, w = 201, K = 64, b = 128, nb = 123,
r = 32; the factor the ``spike`` PC builds), each version in the order
given (a bare LABEL repeats an earlier one, to run versions in turns, e.g.
``old=... new=... new old``) is held against the plain sweep
(``blocktri_solve``) at 1e-5 of max|plain| and timed with CUDA events, f32
and bf16 factors.  One JSON line per run: median and spread in ms,
microseconds per serial step (time / (3 nb - 2)), the error and whether it
is within the tolerance (a version that is not is still timed).  The
card's name and power limit come first; each version that has the
``fused_sweep_many_config`` entry also prints its launch shape.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "experiments"))

from chip_smoke import (BLOCK, HALF_BW, K, KERNEL_TOL, N,  # noqa: E402
                        NRHS, flagship_band, kernel_err, sweep_bound,
                        time_ms)
from torch_lab_many_spd import parse, start_nvcc, variant  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
CONFIG_KEYS = ("cluster", "cols", "warps", "depth", "smem_bytes")


def build(versions):
    """{label: ctypes library}, one nvcc per distinct label."""
    procs = {}
    for label, src, consts in versions:
        if label not in procs:
            procs[label] = start_nvcc(label, variant(label, src, consts))
    libs = {}
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {label}: exit {proc.returncode}; " + " | ".join(regs))
        if proc.returncode != 0:      # reported, and left out of the runs
            print("\n".join(log.splitlines()[-12:]))
            continue
        lib = ctypes.CDLL(str(out))
        for fn in ("fused_sweep_many_f32", "fused_sweep_many_bf16"):
            getattr(lib, fn).argtypes = [P, P, P, P, P, I, I, I, I, P]
            getattr(lib, fn).restype = I
        if hasattr(lib, "fused_sweep_many_config"):   # not the parent's
            lib.fused_sweep_many_config.argtypes = [I, I, P]
            for b, bf16 in ((128, 0), (128, 1)):
                cfg = (ctypes.c_int * 16)()      # room for older layouts
                lib.fused_sweep_many_config(b, bf16, cfg)
                print(f"  {label} b={b} {'bf16' if bf16 else 'f32'}: "
                      + ", ".join(f"{k} {v}" for k, v in
                                  zip(CONFIG_KEYS, cfg)))
        libs[label] = lib
    return libs


def main() -> int:
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve, cast_factor
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    versions = parse(sys.argv[1:])
    libs = build(versions)
    device = torch.device("cuda", 0)
    band, _ = flagship_band(N, HALF_BW, device)
    sf = spike_factor(band, K=K, block_b=BLOCK, store_spikes=True,
                      spike_dtype=torch.bfloat16, inverter="newton_fixed")
    del band
    gen = torch.Generator(device=device).manual_seed(7)
    rm = torch.randn((K, sf.nb, BLOCK, NRHS), generator=gen, device=device)
    facts = {"f32": sf.fact, "bf16": cast_factor(sf.fact, torch.bfloat16)}
    refs = {k: blocktri_solve(f, rm).float() for k, f in facts.items()}
    bound_ms, bound_by = sweep_bound(sf.fact, NRHS)
    print(json.dumps({"shape": [K, sf.nb, BLOCK, NRHS],
                      "bound_ms": bound_ms, "bound_by": bound_by}))
    stream = torch.cuda.current_stream(device).cuda_stream
    steps = 3 * sf.nb - 2
    for label, _, consts in versions:
        if label not in libs:
            continue
        lib = libs[label]
        for dt, fact in facts.items():
            fn = getattr(lib, f"fused_sweep_many_{dt}")
            x = torch.empty_like(rm)

            def run():
                code = fn(fact.F.data_ptr(), fact.Sinv.data_ptr(),
                          fact.U.data_ptr(), rm.data_ptr(), x.data_ptr(), K,
                          sf.nb, BLOCK, NRHS, stream)
                if code != 0:
                    raise RuntimeError(f"{label} {dt}: CUDA error {code}")
            run()
            torch.cuda.synchronize()
            diff, err = kernel_err(x, refs[dt])
            ms, spread = time_ms(run, reps=7, iters=5)
            print(json.dumps({
                "label": label, "consts": consts, "dtype": dt, "ms": ms,
                "spread_ms": spread, "us_per_step": ms * 1e3 / steps,
                "max_abs_err": diff, "rel_err": err,
                "ok": err <= KERNEL_TOL}))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())

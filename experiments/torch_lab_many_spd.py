#!/usr/bin/env python3
"""Time versions of the multi-RHS spd sweep kernel on one CUDA card.

    python3 experiments/torch_lab_many_spd.py LABEL=SOURCE[:NAME=VALUE,...] ...

Each argument names a CUDA source with the C interface of
``spike_petsc_tpu_torch/csrc/fused_sweep_many_spd.cu`` (the entry points
``fused_sweep_many_spd_f32`` and ``_bf16``), optionally with constants to
change: each NAME=VALUE rewrites the source's one ``constexpr int NAME =
...;`` line (for instance ``kCluster=4,kCols=16``) in a copy under
``build/lab/``.  Every version is built there with the port's nvcc flags,
all builds started together.
Then, at BASELINE config 2 (n = 1e6, bandwidth 33, K = 16, b = 64,
nb = 977, r = 32; the factor the ``cholesky`` PC builds), each version in
the order given (a bare LABEL repeats an earlier one, to run versions in
turns, e.g. ``old=... new=... new old``) is held against the plain sweep
(``blocktri_solve``) at 1e-5 of max|plain| and timed with CUDA events, f32
and bf16 factors.  One JSON line per run: median and spread in ms,
microseconds per serial step (time / (2 nb - 1)), the error and whether it
is within the tolerance (a version that is not, such as one with a phase
taken out to time the rest, is still timed).  The card's name and power
limit come first; each version that has the
``fused_sweep_many_spd_config`` entry also prints its cluster shape and
ring depth.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (KERNEL_TOL, NRHS, SPD_BLOCK, SPD_HALF_BW,  # noqa: E402
                        SPD_K, SPD_N, kernel_err, spd_band, spd_factor,
                        sweep_bound, time_ms)
from spike_petsc_tpu_torch.ops.cuda._build import nvcc_command  # noqa: E402

LAB_DIR = ROOT / "build" / "lab"
P, I = ctypes.c_void_p, ctypes.c_int


def parse(args):
    """[(label, source, {name: value})]; a bare LABEL repeats an earlier
    one."""
    known, out = {}, []
    for arg in args:
        label, _, spec = arg.partition("=")
        if spec:
            src, _, consts = spec.partition(":")
            known[label] = (label, Path(src), dict(
                c.split("=", 1) for c in consts.split(",") if c))
        out.append(known[label])
    return out


def variant(label, src, consts, edits=()) -> Path:
    """A copy of `src` under build/lab/ with each constant set and each
    (OLD, NEW) pair of `edits` made (every OLD text replaced by NEW)."""
    text = src.read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{label}: {n} lines define {name} in {src}")
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{label}: no {old!r} in {src}")
        text = text.replace(old, new)
    LAB_DIR.mkdir(parents=True, exist_ok=True)
    out = LAB_DIR / f"{label}.cu"
    out.write_text(text)
    return out


def start_nvcc(label, source):
    """Start nvcc on `source` into build/lab/<label>.so with the port's
    flags; returns (library path, process)."""
    out = LAB_DIR / f"{label}.so"
    return out, subprocess.Popen(nvcc_command(source, out),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_nvcc(label, out, proc, functions):
    """Wait for a build from `start_nvcc`, print its register report and
    load the library, each of `functions` ({name: argtypes}) returning an
    int; raises if nvcc failed."""
    log, _ = proc.communicate()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build {label}: exit {proc.returncode}; " + " | ".join(regs))
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


def build(versions):
    """{label: ctypes library}, one nvcc per distinct label."""
    procs = {}
    for label, src, consts in versions:
        if label not in procs:
            procs[label] = start_nvcc(label, variant(label, src, consts))
    libs = {}
    for label, (out, proc) in procs.items():
        lib = finish_nvcc(label, out, proc, {
            fn: [P, P, P, P, I, I, I, I, P]
            for fn in ("fused_sweep_many_spd_f32",
                       "fused_sweep_many_spd_bf16")})
        if hasattr(lib, "fused_sweep_many_spd_config"):   # not the parent's
            lib.fused_sweep_many_spd_config.argtypes = [I, I, P]
            for b, bf16 in ((64, 0), (64, 1)):
                out = (ctypes.c_int * 3)()
                lib.fused_sweep_many_spd_config(b, bf16, out)
                print(f"  {label} b={b} {'bf16' if bf16 else 'f32'}: "
                      f"cluster {out[0]}, cols {out[1]}, depth {out[2]}")
        libs[label] = lib
    return libs


def main() -> int:
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve, cast_factor
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
    band, _ = spd_band(SPD_N, SPD_HALF_BW, device)
    sf = spd_factor(band)
    del band
    gen = torch.Generator(device=device).manual_seed(7)
    rm = torch.randn((SPD_K, sf.nb, SPD_BLOCK, NRHS), generator=gen,
                     device=device)
    facts = {"f32": sf.fact, "bf16": cast_factor(sf.fact, torch.bfloat16)}
    refs = {k: blocktri_solve(f, rm).float() for k, f in facts.items()}
    bound_ms, bound_by = sweep_bound(sf.fact, NRHS)
    print(json.dumps({"shape": [SPD_K, sf.nb, SPD_BLOCK, NRHS],
                      "bound_ms": bound_ms, "bound_by": bound_by}))
    stream = torch.cuda.current_stream(device).cuda_stream
    for label, _, consts in versions:
        lib = libs[label]
        for dt, fact in facts.items():
            fn = getattr(lib, f"fused_sweep_many_spd_{dt}")
            x = torch.empty_like(rm)

            def run():
                code = fn(fact.F.data_ptr(), fact.Sinv.data_ptr(),
                          rm.data_ptr(), x.data_ptr(), SPD_K, sf.nb,
                          SPD_BLOCK, NRHS, stream)
                if code != 0:
                    raise RuntimeError(f"{label} {dt}: CUDA error {code}")
            run()
            torch.cuda.synchronize()
            diff, err = kernel_err(x, refs[dt])
            ms, spread = time_ms(run, reps=7, iters=5)
            print(json.dumps({
                "label": label, "consts": consts, "dtype": dt, "ms": ms,
                "spread_ms": spread,
                "us_per_step": ms * 1e3 / (2 * sf.nb - 1),
                "max_abs_err": diff, "rel_err": err,
                "ok": err <= KERNEL_TOL}))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())

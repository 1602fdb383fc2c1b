#!/usr/bin/env python3
"""Check and time the fused sweep kernel (#1, ``csrc/fused_sweep.cu``) on
one CUDA card at every cluster size, beside an earlier source of it,
variants of its constants and the two-pass sweeps (#9); or (``--orders``)
hold its accuracy on the zero-diagonal factor against other orders of
summation.

    python3 experiments/torch_lab_fused_sweep.py [--parent SRC]
        [--variant NAME[@C]:OLD=>NEW[;;OLD=>NEW...] ...] [--shapes a,b,...]
        [--clusters 1,2,4] [--no-check]
    python3 experiments/torch_lab_fused_sweep.py --orders [--parent SRC]

At each shape (``SHAPES``: the flagship factor K = 64, nb = 123, b = 128;
the zero-diagonal scenario's K = 64, nb = 245, b = 64; config 4's inner
factor K = 16, nb = 49, b = 128; K = 512, nb = 16, b = 128; K = 1,
nb = 157, b = 64, and that shape's factor of config 1's Laplacian at
n = 1e4), f32 and bf16-stored, on random factors made on the card from a
seed (``chip_smoke.random_inv_factor``: the kernel's work does not depend
on the values), it holds #1 against its plain version at each cluster
size (relative max-abs error within chip_smoke.KERNEL_TOL) and times it
with CUDA events (median and spread, ms, of 20 calls through the C entry
point) and by its device time a launch (torch.profiler over 20 launches:
the events time the host's launch rate where a launch is shorter than its
host work), beside the plan's choice (``fused_sweep_cluster``) and the
bound (``chip_smoke.sweep_bound``).  ``--parent`` builds another source of
#1 with the first design's C interface (no cluster argument) and times it
in the same call; ``--variant`` builds a copy of the source with each OLD
text replaced by NEW (say ``ring192:96 * 1024=>192 * 1024``) and times it
at the plan's cluster size, or at C where the name ends in ``@C``;
"wrapper" is the plan's launch through ``blocktri_solve_fused_cuda``; #9
is timed on the flagship factor.  Every time is of a factor that the L2
cache cannot hold, except K = 1, nb = 157 (7.7 MB in f32), whose repeated
launches read it warm.  One JSON line a shape and dtype, after the card's
name and power limit and the compiler's register report.

``--orders`` builds the zero-diagonal scenario's shifted spike factor as
chip_smoke.py's ``phase_zerodiag`` does (n = 1e6, K = 64, nb = 245,
b = 64, f32) and solves it for the scenario's right-hand side and three
seeded random ones with #1 at c = 1, 2 and 4, with copies of #1 that sum
each row in another order (``ORDERS``), with the parent source where
given, and with the plain f32 sweep; each against the plain sweep in f64,
max|x - f64| / max|f64| as chip_smoke.py's zero-diagonal check measures
it.  One JSON line a solver: its errors, and its largest difference from
#1 at c = 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "experiments"))

from chip_smoke import (KERNEL_TOL, device_profile,  # noqa: E402
                        kernel_err, laplacian_factor, pc_factor, phase_card,
                        random_inv_factor, run_testbed, sweep_bound,
                        time_ms, zerodiag_argv)
from torch_lab_many_spd import finish_nvcc, start_nvcc, variant  # noqa: E402

SHAPES = {"flagship": (64, 123, 128), "zerodiag": (64, 245, 64),
          "config4": (16, 49, 128), "k512": (512, 16, 128),
          "k1": (1, 157, 64), "lap157": (1, 157, 64)}

# other orders of a row's sum, as edits of the source.  The kernel's own:
# each of a row's 4 lanes keeps 4 partial sums over its chunks (taken in an
# order rotated by the row), added pairwise, then a 2-level shuffle.
# "serial" and "reverse" sum the row in one accumulator over columns
# 0 .. b - 1 (b - 1 .. 0), reading the slab after the carry arrives, so the
# slot is released after the sum; "unrotated" takes every row's chunks in
# column order
_RELEASE = ("    __syncwarp();                   // this warp is done with "
            "the slot\n    if (lane == 0) mbar_arrive(empty + k);\n")
_SHUFFLE = "      acc += __shfl_xor_sync(0xffffffffu, acc, o);\n"


def _serial(index):
    return [(_RELEASE, ""), (_SHUFFLE, _SHUFFLE + (
        "    {\n"
        "      float s_ = 0.0f;\n"
        "      for (int k_ = 0; k_ < B; ++k_) {\n"
        f"        const int kk = {index};\n"
        "        float w_[4];\n"
        "        row4<B, PACK>(slab, row, kk & ~3, w_);\n"
        "        s_ = fmaf(w_[kk & 3], cur[kk], s_);\n"
        "      }\n"
        "      acc = s_;\n"
        "    }\n"
        "    __syncwarp();\n"
        "    if (lane == 0) mbar_arrive(empty + k);\n"))]


ORDERS = {
    "serial": _serial("k_"),
    "reverse": _serial("B - 1 - k_"),
    "unrotated": [(
        "  auto col = [&](int m) { return 4 * (q + Q * ((m + jj) & "
        "(NCH - 1))); };",
        "  auto col = [&](int m) { return 4 * (q + Q * m); };")],
}


def build_versions(src, parent, variants, functions):
    """{name: library}: every variant of ``src`` ({name: edits}) and the
    parent source (the first design's interface), one nvcc each, all
    started together."""
    sources = {name: (src, edits) for name, edits in variants.items()}
    if parent:
        sources["parent"] = (Path(parent), [])
    started = {}
    for name, (path, edits) in sources.items():
        lab = f"fused_sweep_{name.replace('@', '_')}"
        started[name] = start_nvcc(lab, variant(lab, path, {}, edits))
    return {name: finish_nvcc(name, out, proc, (
        {fn: args[:-2] + args[-1:] for fn, args in functions.items()
         if fn != "fused_sweep_config"} if name == "parent" else functions))
        for name, (out, proc) in started.items()}


def orders(args) -> int:
    """The zero-diagonal factor's error against the f64 sweep, for #1 at
    each cluster size and each other order of summation."""
    import dataclasses
    import torch
    import torch.nn.functional as tnf
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    device = torch.device("cuda")
    libs = build_versions(cfs.KERNEL.source, args.parent, ORDERS,
                          cfs.KERNEL.functions)
    rec = {}
    rc, _ = run_testbed(zerodiag_argv("spike", True), rec)
    if rc != 0:
        raise SystemExit(f"the zero-diagonal testbed run exited {rc}")
    sf = pc_factor(rec["pc"])
    fact = sf.fact
    K, nb, b = sf.K, sf.nb, sf.b
    gen = torch.Generator(device=device).manual_seed(11)
    rhs = [tnf.pad(rec["b"], (0, K * sf.m - sf.n)).reshape(K, nb, b)]
    rhs += [torch.randn((K, nb, b), generator=gen, device=device)
            for _ in range(3)]
    del rec
    f64 = dataclasses.replace(fact, F=fact.F.double(), U=fact.U.double(),
                              Sinv=fact.Sinv.double())
    refs = [blocktri_solve(f64, r.double()) for r in rhs]
    del f64
    stream = torch.cuda.current_stream(device).cuda_stream
    plan = cfs.fused_sweep_cluster(K, nb, b, cfs.device_sms(device))

    def direct(lib, r, *cluster):
        x = torch.empty_like(r)
        code = lib.fused_sweep_f32(fact.F.data_ptr(), fact.Sinv.data_ptr(),
                                   fact.U.data_ptr(), r.data_ptr(),
                                   x.data_ptr(), K, nb, b, *cluster, stream)
        assert code == 0, code
        return x
    solvers = {f"c={c}": (lambda r, c=c: cfs.blocktri_solve_fused_cuda(
        fact, r, cluster=c)) for c in cfs.CLUSTER_SIZES}
    solvers.update({name: (lambda r, lib=lib: direct(lib, r)) if
                    name == "parent" else
                    (lambda r, lib=lib: direct(lib, r, plan))
                    for name, lib in libs.items()})
    solvers["plain f32"] = lambda r: cfs.blocktri_solve_fused_cuda(
        fact, r, impl="plain")
    first = [solvers["c=1"](r) for r in rhs]
    print(json.dumps({"factor": [K, nb, b], "plan": plan,
                      "rhs": ["scenario", "randn 1", "randn 2", "randn 3"]}))
    for name, solve in solvers.items():
        xs = [solve(r) for r in rhs]
        torch.cuda.synchronize()
        print(json.dumps({
            "solver": name,
            "err_vs_f64": [kernel_err(x, ref)[1] for x, ref in zip(xs, refs)],
            "max_abs_diff_vs_c1": max(float((x - x1).abs().max())
                                      for x, x1 in zip(xs, first))}),
              flush=True)
    return 0


def main(argv=None) -> int:
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import cast_factor
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.cuda._build import build_all
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--clusters", default="1,2,4")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--orders", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    phase_card()
    _, logs = build_all([cfs.KERNEL])
    for line in logs.get("fused_sweep", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  fused_sweep: {line.strip()}")
    if args.orders:
        return orders(args)
    variants = {}
    for spec in args.variant:
        name, edits = spec.split(":", 1)
        variants[name] = [tuple(edit.split("=>")) for edit in
                          edits.split(";;")]
    libs = build_versions(cfs.KERNEL.source, args.parent, variants,
                          cfs.KERNEL.functions)
    sms = cfs.device_sms(device)
    clusters = [int(c) for c in args.clusters.split(",")]
    failed = []
    for shape in args.shapes.split(","):
        K, nb, b = SHAPES[shape]
        base = (laplacian_factor(10_000, device).fact if shape == "lap157"
                else random_inv_factor(K, nb, b, torch.float32, device,
                                       seed=K + nb))
        r = torch.randn((K, nb, b), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(nb))
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            fact = base if dtype == torch.float32 else cast_factor(base, dtype)
            plan = cfs.fused_sweep_cluster(K, nb, b, sms)
            rec = {"shape": shape, "K": K, "nb": nb, "b": b, "dtype": dname,
                   "plan": plan, "bound_ms": sweep_bound(fact)[0],
                   "steps": 3 * nb - 2, "ms": {}, "err": {}}
            ref = (None if args.no_check else
                   cfs.blocktri_solve_fused_cuda(fact, r, impl="plain"))
            x = torch.empty_like(r)
            stream = torch.cuda.current_stream(device).cuda_stream
            entry = "fused_sweep_" + dname
            mats = [m.data_ptr() for m in (fact.F, fact.Sinv, fact.U)]

            def direct(lib, *cluster):
                def call():
                    code = getattr(lib, entry)(*mats, r.data_ptr(),
                                               x.data_ptr(), K, nb, b,
                                               *cluster, stream)
                    assert code == 0, code
                return call
            # every kernel is timed through its C entry point, the same
            # host work a launch
            runs = [(c, direct(cfs.KERNEL.lib(), c)) for c in clusters]
            runs += [(name, direct(lib) if name == "parent" else direct(
                lib, int(name.split("@")[1]) if "@" in name else plan))
                for name, lib in libs.items()]

            def wrapper():
                cfs.blocktri_solve_fused_cuda(fact, r)
            runs.append(("wrapper", wrapper))
            for name, call in runs:
                if isinstance(name, int):
                    got = cfs.blocktri_solve_fused_cuda(fact, r,
                                                        cluster=name)
                    rec.setdefault("config", {})[name] = cfs.kernel_config(
                        b, dtype, name)
                elif name == "wrapper":
                    got = cfs.blocktri_solve_fused_cuda(fact, r)
                else:
                    call()
                    got = x
                torch.cuda.synchronize()
                if ref is not None:
                    err = kernel_err(got, ref)[1]
                    rec["err"][name] = err
                    if not err <= KERNEL_TOL:
                        failed.append(f"{shape} {dname} {name}: {err}")
                rec["ms"][name] = time_ms(call, iters=20)
                rec.setdefault("dev_ms", {})[name] = device_profile(
                    lambda: [call() for _ in range(20)])[0] / 20
            if shape == "flagship":
                def sweeps():
                    csw.blocktri_solve_batched_cuda(fact, r)
                rec["ms"]["sweeps"] = time_ms(sweeps, iters=20)
                rec["dev_ms"]["sweeps"] = device_profile(
                    lambda: [sweeps() for _ in range(20)])[0] / 20
            # the profiler drops records at times (a device time of 0):
            # those are left out
            best = min((v for k, v in rec["dev_ms"].items()
                        if isinstance(k, int) and v > 0), default=None)
            rec["bound_over_best"] = best and rec["bound_ms"] / best
            print(json.dumps(rec), flush=True)
            del fact, ref
        del base, r
        torch.cuda.empty_cache()
    if failed:
        print("FAILED: " + "; ".join(failed))
        return 1
    print("all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

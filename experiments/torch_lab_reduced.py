#!/usr/bin/env python3
"""Check and time the reduced-system kernel (``csrc/reduced_thomas.cu``)
on one CUDA card.

    python3 experiments/torch_lab_reduced.py [--plans C:RC[:D],...]
        [--variant LABEL:OLD=>NEW ...] [--quick] [--calibrate] [--flagship]

On a random ``inv`` factor at the flagship's reduced shape (nb = 63,
B = 200; and nb = 2) each launch shape ``C:RC`` (blocks a cluster, columns
a cluster; the plan's own first) is held against the plain loop
(``blocktri_solve``) at r = 32, 1 and 5 and timed with CUDA events: the
device's time a launch (launches queued back to back) and the wrapper's
call, beside the plain loop's call and the bound by ``sweep_bytes``.
``--plans`` adds shapes (``D``: ring slots); ``--variant`` builds a copy of
the source under ``build/lab/`` with each text OLD replaced by NEW and
times the ``--plans`` shapes with it too; ``--quick`` keeps nb = 63 at
r = 32 and 1 and the plan's shape and ``--plans``.  ``--calibrate`` times
#1 (``fused_sweep.cu``: the same chain and carry exchange) on one partition
of 63 block rows.  ``--flagship`` builds the flagship cell's factor
(n = 1e6, kl = ku = 100, K = 64, b = 128, bf16 spikes) and times
``_reduced_solve`` by the kernel route and the plain one on the interfaces
of a real sweep.  One JSON line a reading; the card's name and power limit
first; exit 1 if a reading misses 2e-6 of max|plain|.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import random_inv_factor, sweep_bound, time_ms  # noqa: E402

TOL = 2e-6
ITERS = 20
PLANS = {32: [(8, 4), (4, 4), (8, 2), (16, 4), (16, 2), (12, 2)],
         1: [(8, 1), (4, 1), (16, 1), (16, 2)],
         5: [(8, 4), (8, 2)]}


def rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def main() -> int:
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTriFactor,
                                                    blocktri_solve)
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    from spike_petsc_tpu_torch.ops.cuda._build import build_all

    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", default="",
                    help="C:RC,... launch shapes to try at every r")
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:OLD=>NEW[|||OLD=>NEW...], a copy of the "
                    "source to time")
    ap.add_argument("--calibrate", action="store_true",
                    help="time the single-RHS sweep #1 on one partition of "
                    "63 block rows (b = 64, 128) at each cluster size")
    ap.add_argument("--quick", action="store_true",
                    help="only nb = 63 at r = 32 and 1, the plan's shape "
                    "and --plans")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    seconds, logs = build_all([crt.KERNEL])
    regs = [ln.strip() for ln in logs.get("reduced_thomas", "").splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps({"build_s": round(seconds, 2), "ptxas": regs}))
    dev = torch.device("cuda")
    extra = [tuple(int(v) for v in p.split(":"))
             for p in args.plans.split(",") if p]
    variants = {"": crt.KERNEL}
    for spec in args.variant:
        label, change = spec.split(":", 1)
        kern = variant_kernel(label, crt.KERNEL, [
            c.split("=>") for c in change.split("|||")])
        try:
            build_all([kern])
        except RuntimeError as exc:
            print(json.dumps({"variant": label, "build": str(exc)[-800:]}))
            continue
        variants[label] = kern
    bad = 0
    for nb in (63,) if args.quick else (63, 2):
        f4 = random_inv_factor(1, nb, 200, torch.float32, dev, seed=nb)
        fact = BlockTriFactor(F=f4.F[0], U=f4.U[0], Sinv=f4.Sinv[0])
        for r in (32, 1) if args.quick else (32, 1, 5):
            gen = torch.Generator(device=dev).manual_seed(r)
            shape = (nb, 200, r) if r > 1 else (nb, 200)
            rhs = torch.randn(shape, generator=gen, device=dev)
            ref = blocktri_solve(fact, rhs)
            plan = crt.reduced_thomas_plan(200, r)
            shapes = [(plan["cluster"], plan["cols"])] + [
                p for p in ([] if args.quick else PLANS[r]) + extra
                if p != (plan["cluster"], plan["cols"])]
            row = {"nb": nb, "r": r, "plan": crt.kernel_config(200, r)}
            if nb == 63:
                # the plain loop's call: host-paced, as in the PC apply
                row["plain_ms"] = time_ms(lambda: blocktri_solve(fact, rhs))
                row["bound_ms"] = sweep_bound(f4, r)
            runs = [("", shape) for shape in shapes] + [
                (label, shape) for label in variants if label
                for shape in extra]
            for label, shape in runs:
                key = label + ":".join(map(str, shape))
                crt.KERNEL = variants[label]
                over = dict(zip(("cluster", "cols", "depth"), shape))

                def run(over=over):
                    return crt.blocktri_solve_reduced_cuda(fact, rhs, **over)
                try:
                    err = rel(run(), ref)
                    plan = crt.reduced_thomas_plan(200, r, **over)
                    x = torch.empty_like(rhs)

                    def launch(plan=plan, x=x):
                        crt._launch(fact, rhs, x, r, plan)
                    # ITERS launches queued back to back: the device's time
                    # a launch, the host's (~10 us) hidden behind it
                    device = time_ms(launch, reps=7, iters=ITERS)
                except (RuntimeError, ValueError) as exc:
                    row[key] = str(exc)[:120]
                    continue
                finally:
                    crt.KERNEL = variants[""]
                bad += err > TOL
                if nb == 63:
                    crt.KERNEL = variants[label]
                    row[key] = dict(err=err, device_ms=device,
                                    call_ms=time_ms(run, reps=9))
                    crt.KERNEL = variants[""]
                else:
                    row[key] = dict(err=err)
            print(json.dumps(row))
    if args.calibrate:
        calibrate(dev)
    if args.flagship:
        bad += flagship(dev)
    print("all checks passed" if not bad else f"{bad} checks missed {TOL}")
    return 1 if bad else 0


def variant_kernel(label, kernel, changes):
    """A copy of ``kernel``'s source under build/lab/ with each ``(old,
    new)`` of ``changes`` made, as a kernel of the same entry points."""
    from spike_petsc_tpu_torch.ops.cuda._build import CudaKernel
    text = kernel.source.read_text()
    for old, new in changes:
        if old not in text:
            raise SystemExit(f"variant {label}: {old!r} is not in the source")
        text = text.replace(old, new)
    path = ROOT / "build/lab" / f"reduced_thomas_{label}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)

    class Variant(CudaKernel):
        @property
        def source(self):
            return path
    return Variant(kernel.name, kernel.functions)


def calibrate(dev):
    """#1 (csrc/fused_sweep.cu), the same chain of 3 nb - 2 steps with the
    same carry exchange, on K = 1, nb = 63: its device time a launch."""
    import torch
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    for b in (64, 128):
        fact = random_inv_factor(1, 63, b, torch.float32, dev, seed=b)
        r = torch.randn((1, 63, b), device=dev)
        row = {"calibrate": "fused_sweep K=1 nb=63", "b": b}
        for c in cfs.CLUSTER_SIZES:
            row[f"c={c}"] = time_ms(
                lambda c=c: cfs.blocktri_solve_fused_cuda(fact, r, cluster=c),
                reps=7, iters=ITERS)
        print(json.dumps(row))


def flagship(dev) -> int:
    """``_reduced_solve`` on the flagship cell's factor and a real sweep's
    interfaces, by both routes."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops import spike
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve
    from benchmark.problems import flagship_band
    cfg = json.loads((ROOT / "benchmark/configs/flagship-w201.json")
                     .read_text())
    band = BandedMatrix(data=flagship_band.make(cfg, 2147483647, dev),
                        kl=cfg["kl"], ku=cfg["ku"])
    sf = spike.spike_factor(band, K=64, block_b=128, store_spikes=True,
                            spike_dtype=torch.bfloat16,
                            inverter="newton_fixed")
    K, nb, b, k = sf.K, sf.nb, sf.b, sf.k
    rhs = torch.randn((sf.n, 32), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    rp = torch.zeros((K * sf.m, 32), device=dev)
    rp[:sf.n] = rhs
    g = spike.blocktri_solve_fused_many_cuda(sf.fact, rp.reshape(K, nb, b, 32))
    bot, top = g[:, nb - 1, b - k:, :], g[:, 0, :k, :]

    def plain():        # _reduced_solve's plain route, on the card
        z = blocktri_solve(sf.red_fact, torch.cat([bot[:-1], top[1:]], 1))
        zk = torch.zeros_like(z[:1, :k])
        return torch.cat([zk, z[:, :k]]), torch.cat([z[:, k:], zk])

    def kernel():
        return spike._reduced_solve(sf, bot, top)
    ref, got = plain(), kernel()
    err = max(rel(a, b_) for a, b_ in zip(got, ref))
    row = {"flagship_reduced": tuple(sf.red_fact.F.shape), "err": err,
           "kernel_ms": time_ms(kernel, reps=9),
           "plain_ms": time_ms(plain, reps=9)}
    print(json.dumps(row))
    return int(err > TOL)


if __name__ == "__main__":
    sys.exit(main())

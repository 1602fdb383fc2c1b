#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py          # from the repository root

In order, it:
  1. prints the card (nvidia-smi name and power limit, torch's device name);
  2. builds the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. factors the flagship band (n = 1e6, bandwidth 201, K = 64, b = 128,
     stored bf16 spikes, newton_fixed) and holds each kernel against its
     plain PyTorch version on the same inputs: the banded matvec at the
     flagship and a ragged shape; the fused sweep with f32 and bf16 factors
     at the flagship factor shape and at nb = 1; the multi-RHS fused sweep
     at the same shapes for r = 32, 1 and 100; the block-tridiagonal matvec
     on the flagship conversion (f32 and bf16 blocks) and a ragged band;
  4. checks that the multi-RHS f32 solve carries f32 (against an f64 solve
     of the same factor);
  5. runs each path through the library entry point, with every kernel's
     launch count set to 0 just before and read just after, and checks the
     answer:
       * ``solve(A, b, ksp_type="gmres", pc_type="spike", options=...)``
         (against x = 1, and against the plain CPU path in f64 on a small
         band), and the same with ``-mat_matvec_impl blocktri``;
       * serving, ``solve_many(A, B, ksp_type="bcgs", pc_type="spike", ...)``
         on 32 right-hand sides at rtol 1e-8 and at rtol 1e-4 (the
         half-step exit), and against the plain CPU path in f64;
  6. times the factor, the solves, the GMRES and serving solves, the
     operators and each kernel beside its plain version with CUDA events
     (median and spread of the repetitions), the serving stage's device
     busy time (torch.profiler), and the card's device-to-device copy rate;
  7. prints a ``{"kernels": [...]}`` line and, last, the line
     ``{"ok": true, "device": {...}}``.

Any failed check raises: the exit code is then non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

N, HALF_BW, K, BLOCK = 1_000_000, 100, 64, 128
PC_OPTIONS = {"pc_spike_partitions": K, "pc_spike_block": BLOCK,
              "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
              "pc_spike_inverter": "newton_fixed"}
SEED = 0
REPS = 5
KERNEL_TOL = 1e-5          # max|kernel - plain| / max|plain|
SPIKE_RELRES_MAX = 2.5e-4  # f32 relative residual of one bf16-spike solve
GMRES_ITS_MAX = 3
NRHS = 32                  # serving batch (BASELINE config 2's batched mode)
SERVE_ITS_MAX = 2          # bcgs at rtol 1e-8; the TPU yardstick is 1
SERVE_RELRES_MAX = 1e-4    # per-column true f32 relative residual
CARRY_REL_MAX = 1e-5       # f32 multi-RHS solve against its f64 solve
REPLACES = {
    "band_matvec": "spike_petsc_tpu/ops/pallas/band_matvec.py:66",
    "fused_sweep": "spike_petsc_tpu/ops/pallas/fused_sweep.py:109",
    "fused_sweep_many": "spike_petsc_tpu/ops/pallas/fused_sweep.py:378",
    "blocktri_matvec": "spike_petsc_tpu/ops/pallas/matvec.py:89",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def flagship_band(n, half_bw, device, seed=SEED):
    """Diagonally dominant random band, built on the device as bench.py
    builds its flagship band: uniform(-1, 1) entries, the diagonal set to
    the row's absolute sum + 1 (edge rows keep nonzero out-of-range slots).
    Right-hand side b = A @ 1, so the solution is all ones."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((n, 2 * half_bw + 1), generator=gen, device=device,
                      dtype=torch.float32) * 2 - 1
    data[:, half_bw] = data.abs().sum(dim=1) + 1
    band = BandedMatrix(data=data, kl=half_bw, ku=half_bw)
    return band, banded_matvec(band, torch.ones(n, device=device))


def time_ms(fn, reps=REPS, iters=1):
    """Median and spread (max - min) in ms per call of ``fn`` over ``reps``
    repetitions of ``iters`` calls, with CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times), max(times) - min(times)


def kernel_err(got, ref):
    """(max|got - ref|, that over max|ref|)."""
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must run in full FP32 (TF32 is on)")
    return smi


def phase_build():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    from spike_petsc_tpu_torch.ops.cuda._build import build_all
    seconds, logs = build_all(KERNELS)
    print(f"build: {seconds:.2f} s for {len(KERNELS)} kernels")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernels(band, rhs, sf, device):
    """Each kernel against its plain version on the same inputs."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    errs = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ragged = BandedMatrix(
        data=torch.rand((100_003, 231), generator=gen, device=device) - 0.5,
        kl=150, ku=80)
    for label, bm in (("flagship n=1e6 w=201", band),
                      ("ragged n=100003 kl=150 ku=80", ragged)):
        prep = cbm.prepare_banded_mv(bm)
        x = torch.randn(bm.n, generator=gen, device=device)
        diff, err = kernel_err(
            cbm.banded_matvec_prepared(prep, x),
            cbm.banded_matvec_prepared(prep, x, impl="plain"))
        torch.cuda.synchronize()
        print(f"band_matvec {label}: max abs err {diff:.3e}, "
              f"relative {err:.3e}")
        check(err <= KERNEL_TOL, f"band_matvec {label} err {err}")
        errs.setdefault("band_matvec", diff)

    # nb = 1 needs partitions of one block, so a band of half width 50
    small_band, _ = flagship_band(K * BLOCK, 50, device, seed=SEED + 2)
    small = spike_factor(small_band, K=K, block_b=BLOCK, inverter="lapack")
    check(small.nb == 1, "small factor must have nb = 1")
    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    cases = [("flagship f32", sf.fact, rblk),
             ("flagship bf16", cast_factor(sf.fact, torch.bfloat16), rblk),
             ("nb=1 f32", small.fact,
              torch.randn((K, 1, BLOCK), generator=gen, device=device))]
    for label, fact, r in cases:
        diff, err = kernel_err(
            cfs.blocktri_solve_fused_cuda(fact, r),
            cfs.blocktri_solve_fused_cuda(fact, r, impl="plain"))
        torch.cuda.synchronize()
        print(f"fused_sweep {label} {tuple(fact.F.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"fused_sweep {label} err {err}")
        errs.setdefault("fused_sweep", diff)

    # the multi-RHS sweep: one column chunk (r = 32), one column, and
    # several chunks (r = 100), f32 and bf16 factors, and nb = 1
    for label, fact, nb, r in (
            ("flagship f32 r=32", sf.fact, sf.nb, NRHS),
            ("flagship bf16 r=32", cast_factor(sf.fact, torch.bfloat16),
             sf.nb, NRHS),
            ("flagship f32 r=1", sf.fact, sf.nb, 1),
            ("flagship bf16 r=100", cast_factor(sf.fact, torch.bfloat16),
             sf.nb, 100),
            ("flagship f32 r=100", sf.fact, sf.nb, 100),
            ("nb=1 f32 r=32", small.fact, 1, NRHS)):
        rm = torch.randn((K, nb, BLOCK, r), generator=gen, device=device)
        diff, err = kernel_err(
            cfm.blocktri_solve_fused_many_cuda(fact, rm),
            cfm.blocktri_solve_fused_many_cuda(fact, rm, impl="plain"))
        torch.cuda.synchronize()
        print(f"fused_sweep_many {label} {tuple(fact.F.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"fused_sweep_many {label} err {err}")
        errs.setdefault("fused_sweep_many", diff)

    # the block-tridiagonal matvec: the flagship conversion, and a ragged
    # band (n not a multiple of 128, max(kl, ku) <= 128)
    ragged_bt = BandedMatrix(
        data=torch.rand((100_003, 198), generator=gen, device=device) - 0.5,
        kl=120, ku=77)
    T = band_to_blocktri(band, BLOCK)
    for label, t, n in (
            ("flagship f32", T, N),
            ("flagship bf16", BlockTridiagonal(
                D=T.D.bfloat16(), L=T.L.bfloat16(), U=T.U.bfloat16()), N),
            ("ragged n=100003 kl=120 ku=77 f32",
             band_to_blocktri(ragged_bt, BLOCK), ragged_bt.n)):
        x = torch.randn(n, generator=gen, device=device)
        diff, err = kernel_err(cbt.blocktri_matvec_cuda(t, x),
                               cbt.blocktri_matvec_cuda(t, x, impl="plain"))
        torch.cuda.synchronize()
        print(f"blocktri_matvec {label} {tuple(t.D.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"blocktri_matvec {label} err {err}")
        errs.setdefault("blocktri_matvec", diff)
    return errs


def phase_accuracy(band, rhs, sf):
    """One spike_solve's f32 residual, and Newton's max|S X - I| on a sample
    of the flagship's Schur blocks, rebuilt from the band and the factor."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec, pad_banded
    from spike_petsc_tpu_torch.ops.blocktri import (_skew_block_rows,
                                                    newton_inv_fixed)
    from spike_petsc_tpu_torch.ops.spike import spike_solve
    x = spike_solve(sf, rhs)
    relres = float(torch.linalg.norm(banded_matvec(band, x) - rhs)
                   / torch.linalg.norm(rhs))
    print(f"spike_solve f32 relative residual: {relres:.3e} "
          f"(TPU v5e yardstick 8.29e-5)")
    check(relres <= SPIKE_RELRES_MAX, f"spike_solve relres {relres}")
    nb, w = sf.nb, band.width
    local = pad_banded(band, K * sf.m).data.reshape(K, nb, BLOCK, w)
    worst = 0.0
    for i in (0, 1, nb - 1):
        _, d, _ = _skew_block_rows(local[:, i], BLOCK, band.kl, band.ku)
        S = d if i == 0 else d - sf.fact.F[:, i] @ sf.fact.U[:, i - 1]
        X = newton_inv_fixed(S)
        eye = torch.eye(BLOCK, dtype=torch.float64, device=S.device)
        worst = max(worst, float((S.double() @ X.double() - eye).abs().max()))
    print(f"newton_inv_fixed max|S X - I| over block rows 0, 1, nb-1 of "
          f"{K} partitions: {worst:.3e} (TPU v5e docstring 2.4e-7)")
    check(worst <= 1e-4, f"newton max|SX-I| {worst}")
    return relres, worst


def phase_main_path(band, rhs, device):
    """The main path through ``solve``, launch counts read around it."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    for kern in KERNELS:
        kern.launches = 0
    res = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(PC_OPTIONS)), rtol=1e-8, restart=30,
                maxit=30)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    bnorm = float(torch.linalg.norm(rhs))
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / bnorm)
    xerr = float((res.x - 1).abs().max())
    print(f"gmres+spike: {res.its} its, {reason_str(res.reason)}, "
          f"preconditioned rnorm/||b|| {res.rnorm / bnorm:.3e}, "
          f"true relres (f32) {true_rel:.3e}, max|x - 1| {xerr:.3e} "
          f"(TPU v5e yardstick: 2 its to 3.96e-11)")
    print(f"launches on the main path: {launches}")
    check(res.reason == CONVERGED_RTOL and res.its <= GMRES_ITS_MAX,
          f"gmres: {res.its} its, reason {res.reason}")
    check(res.x.shape == (N,) and bool(torch.isfinite(res.x).all()),
          "solution shape / finiteness")
    check(xerr <= 1e-3 and true_rel <= 1e-4, "solution accuracy")
    check(launches["band_matvec"] > 0 and launches["fused_sweep"] > 0,
          f"a kernel did not run on the main path: {launches}")
    return res, launches


def phase_reference(device):
    """The same solve on a small band, on the card (kernels, f32) and on the
    CPU (plain versions, f64): the solutions must agree."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    band, rhs = flagship_band(20_000, 20, device, seed=SEED + 3)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    got = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(opts)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    ref = solve(cpu, rhs.double().cpu(), ksp_type="gmres", pc_type="spike",
                options=Options(dict(opts)), rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max())
    print(f"small band n=20000 w=41: card {got.its} its vs CPU f64 "
          f"{ref.its} its, max|x_card - x_cpu| {err:.3e}")
    check(err <= 1e-5 and got.reason == ref.reason == 2,
          "card and CPU reference disagree")


def reset_launches():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    for kern in KERNELS:
        kern.launches = 0


def read_launches():
    import torch
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    torch.cuda.synchronize()
    return {kern.name: kern.launches for kern in KERNELS}


def phase_carry(sf, device):
    """The multi-RHS precision trap: the f32 solve through the kernel must
    match an f64 solve of the same factor (factors and bf16 spikes promoted
    exactly; the plain path, since the kernel takes no f64) to f32 level.
    A carry rounded to bf16 would miss by ~1e-3."""
    import dataclasses
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    from spike_petsc_tpu_torch.ops.spike import spike_solve_many

    def f64(f):
        return BlockTriFactor(F=f.F.double(), U=f.U.double(),
                              Sinv=f.Sinv.double())
    sf64 = dataclasses.replace(
        sf, fact=f64(sf.fact), red_fact=f64(sf.red_fact),
        Btip=sf.Btip.double(), Ctip=sf.Ctip.double(), V=sf.V.double(),
        W=sf.W.double())
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    R = torch.randn((N, NRHS), generator=gen, device=device)
    before = cfm.KERNEL.launches
    x32 = spike_solve_many(sf, R)
    launched = cfm.KERNEL.launches - before
    x64 = spike_solve_many(sf64, R.double())
    rel = float(torch.linalg.norm(x32.double() - x64)
                / torch.linalg.norm(x64))
    print(f"spike_solve_many f32 (factors f32, spikes bf16, kernel) against "
          f"its f64 solve: relative error {rel:.3e} (limit {CARRY_REL_MAX})")
    check(launched == 1 and x32.dtype == torch.float32,
          "the f32 multi-RHS solve did not run the kernel")
    check(rel <= CARRY_REL_MAX, f"multi-RHS f32 carry: relative error {rel}")
    return rel


def phase_blocktri_route(band, rhs, band_its):
    """The GMRES main path with ``-mat_matvec_impl blocktri``: the
    block-tridiagonal kernel as the operator, the same iteration count."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    reset_launches()
    res = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(PC_OPTIONS, mat_matvec_impl="blocktri")),
                rtol=1e-8, restart=30, maxit=30)
    launches = read_launches()
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / torch.linalg.norm(rhs))
    print(f"gmres+spike, blocktri operator: {res.its} its, "
          f"{reason_str(res.reason)}, true relres (f32) {true_rel:.3e}; "
          f"launches {launches}")
    check(res.reason == CONVERGED_RTOL and res.its == band_its,
          f"blocktri route: {res.its} its (band route {band_its}), "
          f"reason {res.reason}")
    check(true_rel <= 1e-4, "blocktri route accuracy")
    check(launches["blocktri_matvec"] > 0,
          f"blocktri kernel did not run on the blocktri route: {launches}")
    return launches


def phase_serving(band, device):
    """Serving through ``solve_many``: 32 seeded right-hand sides B = A X,
    bcgs + spike PC at rtol 1e-8, then at rtol 1e-4, where every column
    exits at the half step (one iteration, one launch of the multi-RHS
    sweep)."""
    import torch
    from spike_petsc_tpu_torch import Options, solve_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    route = as_matvec_many(band)[0]._route
    print(f"solve_many operator route (-mat_matvec_impl auto): {route}")
    check(route == "blocktri_many", f"serving operator route {route}")
    main_launches = None
    for rtol in (1e-8, 1e-4):
        reset_launches()
        res = solve_many(band, B, ksp_type="bcgs", pc_type="spike",
                         options=Options(dict(PC_OPTIONS)), rtol=rtol,
                         maxit=20)
        launches = read_launches()
        relres = (torch.linalg.norm(banded_matvec(band, res.x) - B, dim=0)
                  / torch.linalg.norm(B, dim=0))
        xerr = float((res.x - X).abs().max())
        its = res.its.tolist()
        print(f"bcgs+spike serving r={NRHS} rtol={rtol:g}: its "
              f"min {min(its)} max {max(its)}, reasons "
              f"{sorted(set(res.reason.tolist()))}, per-column true relres "
              f"(f32) max {float(relres.max()):.3e}, max|x - X| {xerr:.3e}; "
              f"launches {launches} (TPU v5e yardstick at rtol 1e-8: 1 it)")
        check(res.x.shape == (N, NRHS) and bool(torch.isfinite(res.x).all()),
              "serving solution shape / finiteness")
        check(bool((res.reason == CONVERGED_RTOL).all()),
              f"serving reasons {res.reason.tolist()}")
        if rtol == 1e-8:
            check(max(its) <= SERVE_ITS_MAX, f"serving its {its}")
            check(float(relres.max()) <= SERVE_RELRES_MAX,
                  f"serving relres {float(relres.max())}")
            check(launches["fused_sweep_many"] > 0,
                  f"multi-RHS sweep did not run on the serving path: "
                  f"{launches}")
            main_launches = launches
        else:
            check(its == [1] * NRHS and launches["fused_sweep_many"] == 1,
                  f"half-step exit: its {its}, launches {launches}")
    return main_launches


def phase_reference_many(device):
    """``solve_many`` on a small band on the card (f32, kernels) and on the
    CPU (plain versions, f64): the solutions must agree."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve_many
    band, _ = flagship_band(20_000, 20, device, seed=SEED + 7)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    B = torch.randn((20_000, 4), generator=gen, device=device)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    got = solve_many(band, B, ksp_type="bcgs", pc_type="spike",
                     options=Options(dict(opts)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    ref = solve_many(cpu, B.double().cpu(), ksp_type="bcgs",
                     pc_type="spike", options=Options(dict(opts)), rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max()
                / ref.x.abs().max())
    print(f"solve_many small band n=20000 w=41 r=4: card its "
          f"{got.its.tolist()} vs CPU f64 its {ref.its.tolist()}, "
          f"max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= 1e-5 and bool((got.reason == 2).all())
          and bool((ref.reason == 2).all()),
          "solve_many: card and CPU reference disagree")


def device_profile(fn, top=6):
    """(device busy ms of one call of ``fn``, its largest device items):
    the sum of the CUDA activity torch.profiler records (every launch,
    the port's own kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    items.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in items) / 1e3
    return busy, [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                  for e in items[:top]]


def phase_timing(band, rhs, sf, device):
    import torch
    from spike_petsc_tpu_torch import Options, make_solver, make_solver_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    from spike_petsc_tpu_torch.ops.spike import (spike_factor, spike_solve,
                                                 spike_solve_many)
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    t = {}

    def show(name, ms, gbytes=None):
        t[name] = ms
        rate = f" ({gbytes * 1e3 / ms[0]:.1f} GB/s)" if gbytes else ""
        print(f"time {name}: {ms[0]:.4f} ms median, spread {ms[1]:.4f} ms"
              f"{rate}")

    nbytes = 1 << 30
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    show("d2d_copy_1GiB", time_ms(lambda: dst.copy_(src), iters=5),
         2 * nbytes / 1e9)
    del src, dst
    show("factor", time_ms(lambda: spike_factor(
        band, K=K, block_b=BLOCK, store_spikes=True,
        spike_dtype=torch.bfloat16, inverter="newton_fixed"), reps=3))
    show("spike_solve", time_ms(lambda: spike_solve(sf, rhs), iters=5))
    solver = make_solver(band, ksp_type="gmres", pc_type="spike",
                         options=Options(dict(PC_OPTIONS)), rtol=1e-8,
                         restart=30, maxit=30)
    show("gmres_solve", time_ms(lambda: solver(rhs)))

    prep = cbm.prepare_banded_mv(band)
    x = torch.randn(N, device=device)
    mv_gb = (band.n * band.width * 4 + 2 * N * 4) / 1e9
    show("band_matvec_cuda", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x), iters=20), mv_gb)
    show("band_matvec_plain", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x, impl="plain"), iters=5),
        mv_gb)
    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    for label, fact in (("f32", sf.fact),
                        ("bf16", cast_factor(sf.fact, torch.bfloat16))):
        gb = 3 * fact.F.numel() * fact.F.element_size() / 1e9
        show(f"fused_sweep_cuda_{label}", time_ms(
            lambda: cfs.blocktri_solve_fused_cuda(fact, rblk), iters=10), gb)
        show(f"fused_sweep_plain_{label}", time_ms(
            lambda: cfs.blocktri_solve_fused_cuda(fact, rblk, impl="plain"),
            iters=3), gb)

    # serving: the multi-RHS sweep, the solve and the bcgs solve at r = 32
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    rm = torch.nn.functional.pad(B, (0, 0, 0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK, NRHS)
    for label, fact in (("f32", sf.fact),
                        ("bf16", cast_factor(sf.fact, torch.bfloat16))):
        gb = 3 * fact.F.numel() * fact.F.element_size() / 1e9
        show(f"fused_sweep_many_cuda_{label}", time_ms(
            lambda: cfm.blocktri_solve_fused_many_cuda(fact, rm), iters=5),
            gb)
        show(f"fused_sweep_many_plain_{label}", time_ms(
            lambda: cfm.blocktri_solve_fused_many_cuda(fact, rm,
                                                       impl="plain"),
            iters=2), gb)
    show("spike_solve_many_r32", time_ms(lambda: spike_solve_many(sf, B),
                                         iters=3))
    print(f"  spike_solve_many per RHS: "
          f"{t['spike_solve_many_r32'][0] / NRHS:.4f} ms "
          f"(spike_solve alone {t['spike_solve'][0]:.4f} ms)")
    for rtol in (1e-8, 1e-4):
        server = make_solver_many(band, ksp_type="bcgs", pc_type="spike",
                                  options=Options(dict(PC_OPTIONS)),
                                  rtol=rtol, maxit=20)
        name = f"serve_bcgs_rtol{rtol:g}"
        show(name, time_ms(lambda: server(B), reps=3))
        print(f"  {name} per RHS: {t[name][0] / NRHS:.4f} ms")
        busy, items = device_profile(lambda: server(B))
        print(f"  {name} device busy {busy:.3f} ms of {t[name][0]:.3f} ms "
              f"wall: idle share {1 - busy / t[name][0]:.3f}")
        for key, count, ms in items:
            print(f"    {ms:8.3f} ms  {count:5d} x  {key}")

    # the operators: the blocktri kernel, its plain version, the band
    # kernel, and the multi-RHS blocktri_many product at r = 32
    T = band_to_blocktri(band, BLOCK)
    bt_gb = (3 * T.D.numel() * 4 + 2 * N * 4) / 1e9
    show("blocktri_matvec_cuda", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T, x), iters=20), bt_gb)
    show("blocktri_matvec_plain", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T, x, impl="plain"), iters=5),
        bt_gb)
    T16 = BlockTridiagonal(D=T.D.bfloat16(), L=T.L.bfloat16(),
                           U=T.U.bfloat16())
    show("blocktri_matvec_cuda_bf16", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T16, x), iters=20), bt_gb / 2)
    del T16
    mv_many = as_matvec_many(band)[0]
    show("blocktri_many_r32", time_ms(lambda: mv_many(X), iters=5),
         (3 * T.D.numel() * 4 + 2 * N * NRHS * 4) / 1e9)
    return t


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    device = torch.device("cuda", 0)

    smi = phase_card()
    phase_build()
    band, rhs = flagship_band(N, HALF_BW, device)
    sf = spike_factor(band, K=K, block_b=BLOCK, store_spikes=True,
                      spike_dtype=torch.bfloat16, inverter="newton_fixed")
    errs = phase_kernels(band, rhs, sf, device)
    phase_accuracy(band, rhs, sf)
    phase_carry(sf, device)
    res, launches = phase_main_path(band, rhs, device)
    bt_launches = phase_blocktri_route(band, rhs, res.its)
    serve_launches = phase_serving(band, device)
    phase_reference(device)
    phase_reference_many(device)
    t = phase_timing(band, rhs, sf, device)

    # each kernel's launches from the run of the path it carries
    kernels = []
    for name, path_launches, (ms, plain) in (
            ("band_matvec", launches,
             ("band_matvec_cuda", "band_matvec_plain")),
            ("fused_sweep", launches,
             ("fused_sweep_cuda_f32", "fused_sweep_plain_f32")),
            ("fused_sweep_many", serve_launches,
             ("fused_sweep_many_cuda_f32", "fused_sweep_many_plain_f32")),
            ("blocktri_matvec", bt_launches,
             ("blocktri_matvec_cuda", "blocktri_matvec_plain"))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spike_petsc_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": t[ms][0],
            "plain_ms": t[plain][0]})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The hot-path spans of the PyTorch port (``utils.profiling.span``): the
operator (``MatMult``), the PC apply (``PCApply``), the SPIKE sweep, reduced
solve and correction (``SPIKESweep``, ``SPIKEReduced``, ``SPIKECorrect``)
and the Krylov loops' host reads (``KSPHostSync``).

On the CPU at tiny sizes, with the PC options of the benchmark's two
configurations: the flagship's spike PC (inv factors, bf16 stored spikes)
under the batched bcgs engine, the SPD band's cholesky PC (spd factors,
truncated reduced system, stored spikes) under the single-RHS cg engine.
A span costs nothing but a check while no profiler records, and its counts
under a profiler are the engine's own calls and reads.
"""

import dataclasses
from collections import Counter

import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.solvers import ksp
from spike_petsc_tpu_torch.solvers.pc import make_pc
from spike_petsc_tpu_torch.utils import profiling
from spike_petsc_tpu_torch.utils.options import Options

from torch_parity import CPU, random_band, spd_band

SPANS = ("MatMult", "PCApply", "SPIKESweep", "SPIKEReduced", "SPIKECorrect",
         "KSPHostSync")
N = 6000

# (entry, ksp type, PC type, PC options, band): the benchmark's cells'
# settings at its tiny sizes (flagship K = 8, b = 16, kl = ku = 8; SPD
# K = 4, b = 16, kl = ku = 4)
CASES = {
    "bcgs_many_spike": ("many", "bcgs", "spike", {
        "pc_spike_partitions": 8, "pc_spike_block": 16,
        "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
        "pc_spike_inverter": "newton_fixed", "mat_matvec_impl": "auto"},
        lambda: banded_from_numpy(random_band(N, 8, 8, seed=3,
                                              dtype="float32"), 8, 8,
                                  device=CPU)),
    "cg_one_cholesky": ("one", "cg", "cholesky", {
        "pc_cholesky_partitions": 4, "pc_cholesky_block": 16,
        "pc_cholesky_truncated": 1, "pc_cholesky_store_spikes": 1,
        "mat_matvec_impl": "auto"},
        lambda: banded_from_numpy(spd_band(N, 4, seed=4, dtype="float32"),
                                  4, 4, device=CPU)),
}


# the engine's matvecs and host reads in a call from a zero x0, less its PC
# applies: bcgs_many applies the PC once a trip and a second time a full
# step, each time followed by a matvec, then takes the true residual's
# matvec; it reads ||B||, ||R0||, each trip's s-norm, each full step's norm
# and the true residual.  cg applies the PC to r0 and once an iteration,
# each iteration's matvec before, and the true residual's after; it reads
# ||b||, ||r0||, one norm an iteration and the true residual.
PER_APPLY = {"bcgs_many_spike": dict(matvec=1, host=3),
             "cg_one_cholesky": dict(matvec=0, host=2)}


def counted(fn, calls, key):
    def call(v):
        calls[key] += 1
        return fn(v)
    return call


def compose(case, monkeypatch=None, calls=None):
    """(solver, right-hand side) of a case; with ``calls``, the operator's
    and the PC's calls counted there."""
    entry, ksp_type, pc_type, opts, make_band = CASES[case]
    band = make_band()
    pc = make_pc(pc_type, band, Options(dict(opts)))
    if calls is not None:
        pc = dataclasses.replace(
            pc, apply=counted(pc.apply, calls, "psolve"),
            apply_many=counted(pc.apply_many, calls, "psolve"))
        name = "as_matvec_many" if entry == "many" else "as_matvec"
        build = getattr(ksp, name)

        def as_counted(*a, **kw):
            mv, n, dt = build(*a, **kw)
            return counted(mv, calls, "matvec"), n, dt
        monkeypatch.setattr(ksp, name, as_counted)
    make = ksp.make_solver_many if entry == "many" else ksp.make_solver
    solver = make(band, options=Options(dict(opts)), ksp_type=ksp_type,
                  pc=pc, rtol=1e-8, maxit=50)
    gen = torch.Generator().manual_seed(5)
    shape = (N, 4) if entry == "many" else (N,)
    return solver, torch.randn(shape, generator=gen)


def test_span_is_one_null_context_while_no_profiler_records(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span reached the profiler")
    solvers = [compose(case) for case in CASES]
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("MatMult") is profiling.span("PCApply")
    for solver, b in solvers:
        assert bool((torch.as_tensor(solver(b).reason) > 0).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_count_the_engine_calls_and_reads(monkeypatch, case):
    calls = Counter()
    solver, b = compose(case, monkeypatch, calls)
    plain = solver(b)
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = solver(b)
    got = Counter(e.name for e in prof.events() if e.name in SPANS)
    assert set(got) == set(SPANS)
    psolves, more = calls["psolve"], PER_APPLY[case]
    assert got["MatMult"] == calls["matvec"] == psolves + more["matvec"]
    assert got["PCApply"] == psolves
    # stored spikes: one sweep, one reduced solve and one correction an
    # apply
    for name in ("SPIKESweep", "SPIKEReduced", "SPIKECorrect"):
        assert got[name] == psolves, name
    assert got["KSPHostSync"] == psolves + more["host"]
    # the answers do not depend on the profiler
    assert torch.equal(traced.x, plain.x)
    assert torch.equal(torch.as_tensor(traced.its),
                       torch.as_tensor(plain.its))
    assert torch.equal(torch.as_tensor(traced.rnorm),
                       torch.as_tensor(plain.rnorm))


def stage_count(name):
    for line in profiling.stage_report().splitlines()[1:]:
        stage, count = line.split()[:2]
        if stage == name:
            return int(count)
    return 0


@pytest.mark.parametrize("make", ["make_pc", "make_solver", "make_solver_many",
                                  "nested"])
def test_pc_setup_is_one_stage_in_every_entry(make):
    opts = CASES["cg_one_cholesky"][3]
    band = CASES["cg_one_cholesky"][4]()
    profiling.clear()
    if make == "make_pc":
        make_pc("cholesky", band, Options(dict(opts)))
    elif make == "nested":
        # PCBANDED builds its inner PC with make_pc: one stage
        a = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(64, 64),
                     format="csr")
        make_pc("banded", a, Options({"banded_pc_type": "lu"}), device=CPU,
                dtype=torch.float64)
    else:
        getattr(ksp, make)(band, options=Options(dict(opts)), ksp_type="cg",
                           pc_type="cholesky")
    assert stage_count("PCSetUp") == 1

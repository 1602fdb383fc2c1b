"""Whole runs of the harness on the CPU at tiny sizes: what it prints, the
check that decides ``correct`` against faults planted under the timed path
and against the control, and a cell added by files alone.  The cells are
those ``BENCHMARK.json`` names, each at its configuration's ``tiny``
size."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness, trace
from benchmark.reference import banded
from benchmark.tests.conftest import CELLS, E2E, ROOT, copy_benchmark

SEED = 2_147_483_999          # above 32 signed bits


def cpu_run(root, cell, trace=False, seconds=0.3):
    return harness.run_cell(root, cell, SEED, seconds, trace, "cpu", 0.0)


def command(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_and_prints_no_result():
    proc = command(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_directory_without_the_program_fails(tmp_path):
    proc = command(copy_benchmark(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_is_correct(tiny_root, cell):
    out = cpu_run(tiny_root, cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {
        m["name"] for m in harness.cell_spec(tiny_root, cell)["end_to_end"]}
    assert list(out)[-1] == "check"
    assert out["check"]["xerr"]["value"] < out["check"]["xerr"]["limit"]


def test_traced_run_reads_the_counters(tiny_root):
    out = cpu_run(tiny_root, "spd-cg-r32", trace=True)
    assert out["correct"]
    # the CPU has no device trace: only the counters, the program's host
    # spans and the host clock
    assert set(out["metrics"]) == {"its_per_rhs", "pc_setup_s",
                                   "host_syncs_per_it"}
    out = cpu_run(tiny_root, "spd-cg-1rhs", trace=True)
    assert set(out["metrics"]) == {"its_per_rhs", "pc_setup_s",
                                   "host_syncs_per_it"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # cg reads ||b|| and ||r0||, one norm an iteration and the final
    # residual: 3 + its reads a call of its iterations
    its = out["metrics"]["its_per_rhs"]["value"]
    assert out["metrics"]["host_syncs_per_it"]["value"] == pytest.approx(
        (3 + its) / its)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_cell_reads_what_the_cpu_can_give(tiny_root, cell):
    """On the CPU a traced run is correct and reads every per-layer
    metric of the cell that does not come from the device's trace, and
    none that does."""
    out = cpu_run(tiny_root, cell, trace=True)
    assert out["correct"], out["check"]
    per_layer = harness.cell_spec(tiny_root, cell)["per_layer"]
    assert set(out["metrics"]) == {m["name"] for m in per_layer
                                   if m["source"] != "device_trace"}


def test_the_run_keeps_the_programs_set_up_records(tiny_root, monkeypatch):
    """A reader finds on the run the set-up stages and events that the
    program recorded while this run built the cell, and what the PC
    reports of itself; two runs in one process each see their own."""
    runs = []
    window = harness.window

    def spied(*args, **kw):
        runs.append(args[6])
        return window(*args, **kw)
    monkeypatch.setattr(harness, "window", spied)
    for _ in range(2):
        cpu_run(tiny_root, "spd-cg-1rhs")
    for run in runs:
        assert set(run.stages) == {"PCSetUp"}
        # the synchronized stage lies inside the timed make_pc call
        assert 0 < run.stages["PCSetUp"] <= run.pc_setup_s
        assert run.events == []
        assert run.pc_info["partitions"] == 4 and run.pc_info["block"] == 16


def broken(fault):
    """A solver factory whose answers carry ``fault``."""
    compose = harness.compose

    def make(*args):
        solve = compose(*args)

        def solver(b):
            res = solve(b)
            x = res.x.clone()
            if fault == "unchanged":          # the initial guess returned
                x.zero_()
            elif fault == "half":             # half the batch left out
                x[:, x.shape[1] // 2:] = 0
            elif fault == "altered":          # one answer altered
                x.view(-1)[0] += 1e-3 * x.abs().max()
            return dataclasses.replace(res, x=x)
        return solver
    return make


# the faults each cell can have: a single-RHS cell has no batch to halve,
# and no cell has an exchange between chips to leave out
FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half", "altered")
          if not (f == "half" and harness.cell_spec(
              ROOT, c)["traffic"]["columns"] == 1)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, monkeypatch,
                                                      cell, fault):
    monkeypatch.setattr(harness, "compose", broken(fault))
    out = cpu_run(tiny_root, cell)
    assert not out["correct"]
    assert out["failed"] > 0
    assert out["check"]["xerr"]["value"] > out["check"]["xerr"]["limit"]


def test_a_run_that_is_not_correct_exits_0_with_its_result(
        tiny_root, monkeypatch, capsys):
    """A run that measured prints its result and exits 0 whatever
    ``correct`` reads: the reader of the result line judges it.  Only a run
    that cannot measure exits non-zero, with no result."""
    from benchmark import run as command_line
    measure = harness.run_cell
    monkeypatch.setattr(harness, "compose", broken("altered"))
    monkeypatch.setattr(
        harness, "run_cell",
        lambda root, cell, seed, seconds, trace, device, started: measure(
            root, cell, seed, 0.3, trace, "cpu", started))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(command_line, "ROOT", tiny_root)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(key, "")
    rc = command_line.main(["--workload", "spd-cg-r32", "--seed", str(SEED),
                            "--seconds", "1", "--trace", "0"])
    printed = capsys.readouterr()
    assert rc == 0
    result = json.loads(printed.out.strip().splitlines()[-1])
    assert result["correct"] is False and result["failed"] > 0
    assert set(result["metrics"]) == E2E
    last = printed.err.strip().splitlines()[-2:]
    assert last[0].startswith("check xerr ") and " limit " in last[0]
    assert last[1] == "check unconverged 0 limit 0"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_holds(tiny_root, cell):
    limit = harness.cell_spec(ROOT, cell)["limits"]["xerr"]
    got = control.readings(tiny_root, cell, SEED, "cpu")
    assert got["program"] < limit < got["control"]
    assert got["f32"] < limit


@pytest.mark.parametrize("cell", ["flagship-bcgs-r32", "spd-cg-1rhs"])
def test_the_band_configurations_read_as_before_through_the_seam(tiny_root,
                                                                 cell):
    """The pool, the reference's answers and the control's, and the
    program's operator, made through the configuration's generator and
    reference, are those the harness made when it called ``band_matvec``
    and ``solve_band`` and built the ``BandedMatrix`` itself."""
    spec = harness.cell_spec(tiny_root, cell)
    cfg, traffic = spec["cfg"], spec["traffic"]
    n, kl, ku, r = cfg["n"], cfg["kl"], cfg["ku"], traffic["columns"]
    data = harness.make_matrix(tiny_root, cfg, SEED, "cpu")
    pool = harness.make_pool(tiny_root, cfg, traffic, data, SEED, "cpu")
    gen = torch.Generator(device=data.device).manual_seed(SEED + 1)
    for p in range(traffic["pool"]):
        X = torch.randn((n, r), generator=gen, dtype=data.dtype)
        B = banded.band_matvec(data, kl, ku, X).to(data.dtype)
        assert torch.equal(pool[p], B[:, 0] if traffic["entry"] == "one"
                           else B)
    B = torch.cat([pool[p].reshape(n, -1) for p in sorted(pool)], dim=1)
    solve = harness.load_module(tiny_root, "reference",
                                cfg["reference"]).solve
    assert torch.equal(solve(cfg, data, B), banded.solve_band(data, kl, ku,
                                                              B))
    assert torch.equal(
        solve(cfg, data, B, dtype=torch.float32, tf32_products=True),
        banded.solve_band(data, kl, ku, B, dtype=torch.float32,
                          tf32_products=True))
    A, place = harness.load_module(tiny_root, "problems", cfg["generator"]) \
        .program_operator(harness.import_port(), cfg, data, "cpu")
    assert place == {} and (A.kl, A.ku) == (kl, ku) and A.data is data


def test_a_cell_and_a_metric_added_by_files_alone(tiny_root):
    bench = tiny_root / "benchmark"
    cfg = json.loads((bench / "configs" / "spd-w33.json").read_text())
    cfg.update(name="spd-small", n=3000)
    (bench / "configs" / "spd-small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "cg-r4.json").write_text(json.dumps(
        {"entry": "many", "ksp_type": "cg", "columns": 4,
         "params": {"rtol": 1e-8, "maxit": 50}, "pool": 2,
         "sample_calls": 2}))
    (bench / "workloads" / "spd-small-cg-r4.json").write_text(
        json.dumps({"limits": {"xerr": 1e-5}}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.call_s) / run.window_s\n")
    path = tiny_root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["configs"].append(
        {"name": "spd-small", "source": "https://example.org/spd",
         "file": "benchmark/configs/spd-small.json", "reduced": ["n"],
         "why": "a throwaway configuration"})
    manifest["workloads"].append(
        {"name": "spd-small-cg-r4", "config": "spd-small",
         "traffic": "cg-r4", "chips": 1, "why": "a throwaway cell"})
    manifest["end_to_end"].append(
        {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["spd-small-cg-r4"]})
    path.write_text(json.dumps(manifest))
    out = cpu_run(tiny_root, "spd-small-cg-r4")
    assert out["correct"] and out["attempted"] % 4 == 0
    assert set(out["metrics"]) == {"setup_s", "calls_per_s"}
    # the cells that were there do not report the new metric
    assert "calls_per_s" not in cpu_run(tiny_root, "spd-cg-r32")["metrics"]
    assert torch.get_default_dtype() == torch.float32


# a throwaway configuration whose operator is not a band: a 5-point matrix
# on a 40 x 50 grid, rows dominant by 0.5, its couplings -1 + uniform(-0.2,
# 0.2) from the seed, held as a host SciPy CSR; PCBANDED keeps the band of
# half-width 4 (the couplings at +-40 fall outside) under a spike PC
GRID_GENERATOR = """
import numpy as np
import scipy.sparse as sp
import torch


def make(cfg, seed, device):
    nx, ny = cfg["nx"], cfg["ny"]
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny).reshape(ny, nx)
    pairs = [(idx[:, :-1], idx[:, 1:]), (idx[:-1], idx[1:])]
    rows = np.concatenate([np.r_[a.ravel(), b.ravel()] for a, b in pairs])
    cols = np.concatenate([np.r_[b.ravel(), a.ravel()] for a, b in pairs])
    vals = -1 + rng.uniform(-0.2, 0.2, rows.size)
    off = sp.csr_matrix((vals, (rows, cols)), shape=(nx * ny, nx * ny))
    diag = np.asarray(abs(off).sum(axis=1)).ravel() + 0.5
    return (off + sp.diags(diag)).tocsr().astype(np.float32)


def program_operator(port, cfg, matrix, device):
    return matrix, {"device": device, "dtype": torch.float32}
"""

# its control rounds the float32 matrix and right-hand sides to TF32's 10
# mantissa bits (to nearest) before the float32 solve
DENSE_REFERENCE = """
import torch


def _dense(matrix, dtype, device):
    return torch.as_tensor(matrix.toarray()).to(device=device, dtype=dtype)


def _tf32(t):
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matvec(cfg, matrix, X):
    return _dense(matrix, torch.float64, X.device) @ X.to(torch.float64)


def solve(cfg, matrix, B, *, dtype=torch.float64, tf32_products=False):
    A, B = _dense(matrix, dtype, B.device), B.to(dtype)
    if tf32_products:
        A, B = _tf32(A), _tf32(B)
    return torch.linalg.solve(A, B)
"""

GRID = {"name": "grid5", "generator": "grid5", "reference": "dense",
        "nx": 40, "ny": 50, "n": 2000, "dtype": "float32", "tf32": False,
        "pc_type": "banded", "band_k": 4,
        "options": {"pc_banded_kmax": 4, "banded_pc_type": "spike",
                    "banded_pc_spike_partitions": 4,
                    "banded_pc_spike_block": 8}}


def summary_with_pc_device_time(summarize):
    """``trace.summarize`` that gives each PC span 1 ms of device time:
    the CPU has no device trace to give it."""
    def summary(prof, window_s, program_spans=()):
        out = summarize(prof, window_s, program_spans)
        out.span_device_s[trace.PC_SPAN] = 1e-3 * out.span_count.get(
            trace.PC_SPAN, 0)
        return out
    return summary


def test_a_sparse_cell_added_by_files_alone(tiny_root, monkeypatch):
    bench = tiny_root / "benchmark"
    (bench / "problems" / "grid5.py").write_text(GRID_GENERATOR)
    (bench / "reference" / "dense.py").write_text(DENSE_REFERENCE)
    (bench / "configs" / "grid5.json").write_text(json.dumps(GRID))
    (bench / "traffic" / "gmres-1rhs-grid.json").write_text(json.dumps(
        {"entry": "one", "ksp_type": "gmres", "columns": 1,
         "params": {"restart": 30, "rtol": 1e-8, "maxit": 300}, "pool": 2,
         "sample_calls": 2}))
    (bench / "workloads" / "grid5-gmres.json").write_text(
        json.dumps({"limits": {"xerr": 1e-5}}))
    path = tiny_root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["configs"].append(
        {"name": "grid5", "source": "https://example.org/grid5",
         "file": "benchmark/configs/grid5.json", "reduced": [],
         "why": "a throwaway sparse configuration"})
    manifest["workloads"].append(
        {"name": "grid5-gmres", "config": "grid5",
         "traffic": "gmres-1rhs-grid", "chips": 1,
         "why": "a throwaway sparse cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("grid5-gmres")
    path.write_text(json.dumps(manifest))

    cfg = harness.cell_spec(tiny_root, "grid5-gmres")["cfg"]
    pc, _, _ = harness.build(tiny_root, harness.import_port(), cfg,
                             {"entry": "one", "ksp_type": "gmres",
                              "params": {}},
                             harness.make_matrix(tiny_root, cfg, SEED, "cpu"),
                             "cpu")
    assert pc.name == "banded" and pc.info["k"] == cfg["band_k"]
    out = cpu_run(tiny_root, "grid5-gmres")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == E2E
    monkeypatch.setattr(harness.tracing, "summarize",
                        summary_with_pc_device_time(trace.summarize))
    out = cpu_run(tiny_root, "grid5-gmres", trace=True)
    assert out["correct"], out["check"]
    assert out["metrics"]["its_per_rhs"]["value"] > 2
    roofline = out["metrics"]["pc_apply_roofline"]["value"]
    assert isinstance(roofline, float) and 0 < roofline < 100

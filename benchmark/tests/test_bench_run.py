"""Whole runs of the harness on the CPU at tiny sizes: what it prints, the
check that decides ``correct`` against faults planted under the timed path
and against the control, and a cell added by files alone."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness
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
    assert set(out["metrics"]) == E2E
    assert list(out)[-1] == "check"
    assert out["check"]["xerr"]["value"] < out["check"]["xerr"]["limit"]


def test_traced_run_reads_the_counters(tiny_root):
    out = cpu_run(tiny_root, "spd-cg-r32", trace=True)
    assert out["correct"]
    # the CPU has no device trace: only the counters and the host clock
    assert set(out["metrics"]) == {"its_per_rhs", "pc_setup_s"}
    out = cpu_run(tiny_root, "spd-cg-1rhs", trace=True)
    assert set(out["metrics"]) == {"its_per_rhs", "pc_setup_s"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


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


# the faults each cell can have: the single-RHS cell has no batch to halve,
# and no cell has an exchange between chips to leave out
FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half", "altered")
          if not (f == "half" and c == "spd-cg-1rhs")]


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


@pytest.mark.parametrize("cell", ["flagship-bcgs-r32", "spd-cg-1rhs"])
def test_the_control_fails_and_the_program_holds(tiny_root, cell):
    limit = harness.cell_spec(ROOT, cell)["limits"]["xerr"]
    got = control.readings(tiny_root, cell, SEED, "cpu")
    assert got["program"] < limit < got["control"]
    assert got["f32"] < limit


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

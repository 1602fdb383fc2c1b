"""BENCHMARK.json and the files it names: present, well formed, and each
cell's metrics listed."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, E2E, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PER_LAYER = ("its_per_rhs", "krylov_ms_per_it", "pc_apply_ms",
             "pc_apply_roofline", "device_idle_pct", "launches_per_rhs")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "-m", "benchmark.run"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert [w["name"] for w in manifest["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in manifest["workloads"])
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in manifest["end_to_end"]}[
        "setup_s"] == 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        # each cell that reads the metric reports the metric it moves
        assert set(m["workloads"]) <= e2e[m["moves"]] <= cells
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts(manifest):
    entries = (manifest["configs"] + manifest["workloads"]
               + manifest["end_to_end"] + manifest["per_layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reads_its_files_and_metrics(cell):
    spec = harness.cell_spec(ROOT, cell)
    assert {m["name"] for m in spec["end_to_end"]} == E2E
    assert [m["name"] for m in spec["per_layer"]] == list(PER_LAYER) + [
        "pc_setup_s"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e for m in spec["per_layer"])
    cfg, traffic = spec["cfg"], spec["traffic"]
    assert cfg["name"] == spec["cell"]["config"] and cfg["reduced"] == []
    assert (ROOT / "benchmark" / "problems"
            / f"{cfg['generator']}.py").is_file()
    assert traffic["entry"] in ("one", "many")
    assert traffic["columns"] == (1 if traffic["entry"] == "one" else 32)
    assert traffic["params"]["rtol"] == 1e-8
    assert 0 < spec["limits"]["xerr"] < 1e-4
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(harness.load_module(ROOT, "metrics", m["name"]),
                       "read")


@pytest.mark.parametrize("name,n,kl", [("flagship-w201", 1_000_000, 100),
                                       ("spd-w33", 1_000_000, 16)])
def test_configurations_are_uncut(manifest, name, n, kl):
    entry = {c["name"]: c for c in manifest["configs"]}[name]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert (cfg["n"], cfg["kl"], cfg["ku"]) == (n, kl, kl)
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False

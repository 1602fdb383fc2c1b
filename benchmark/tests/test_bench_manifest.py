"""BENCHMARK.json and the files it names: present, well formed, and each
cell's metrics listed.  Every cell is held to what its own files state;
the cells of ``PINNED`` also to what they were built with."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, E2E, MANIFEST, PINNED, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "-m", "benchmark.run"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [w["name"] for w in manifest["workloads"]]
    assert len(names) == len(set(names)) and set(PINNED) <= set(names)
    # the harness runs one process on one card
    assert all(w["chips"] == 1 for w in manifest["workloads"])
    configs = {c["name"] for c in manifest["configs"]}
    assert configs == {w["config"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in manifest["end_to_end"]}[
        "setup_s"] == 0.25
    cells = set(names)
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        # each cell that reads the metric reports the metric it moves
        assert set(m["workloads"]) <= e2e[m["moves"]] <= cells
        assert m["source"] in SOURCES
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
    e2e = [m["name"] for m in spec["end_to_end"]]
    per_layer = [m["name"] for m in spec["per_layer"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert all(m["moves"] in e2e for m in spec["per_layer"])
    cfg, traffic = spec["cfg"], spec["traffic"]
    assert cfg["name"] == spec["cell"]["config"] and "tiny" in cfg
    for kind in ("problems", "reference"):
        key = "generator" if kind == "problems" else "reference"
        assert (ROOT / "benchmark" / kind / f"{cfg[key]}.py").is_file()
    assert traffic["entry"] in ("one", "many")
    assert (traffic["columns"] == 1) == (traffic["entry"] == "one")
    assert 0 < traffic["params"]["rtol"] < 1
    # the limit lies between the readings it was set from
    limits = json.loads((ROOT / "benchmark" / "workloads"
                         / f"{cell}.json").read_text())
    xerr, got = limits["limits"]["xerr"], limits["set_from"]
    assert got["program_max"] < xerr < got["control_tf32_min"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        reader = harness.load_module(ROOT, "metrics", m["name"])
        assert hasattr(reader, "read")
        spans = getattr(reader, "SPANS", ())
        assert isinstance(spans, tuple)
        assert all(isinstance(s, str) and s for s in spans)
    if cell in PINNED:
        pin = PINNED[cell]
        assert set(e2e) == E2E and per_layer == pin["per_layer"]
        assert traffic["columns"] == pin["columns"]
        assert traffic["params"]["rtol"] == pin["rtol"]
        assert 0 < xerr < 1e-4


UNCUT = {"flagship-w201": (1_000_000, 100, dict(
             n=6000, kl=8, ku=8, options=dict(pc_spike_partitions=8,
                                              pc_spike_block=16))),
         "spd-w33": (1_000_000, 16, dict(
             n=6000, kl=4, ku=4, options=dict(pc_cholesky_partitions=4,
                                              pc_cholesky_block=16)))}


@pytest.mark.parametrize("name", [c["name"] for c in MANIFEST["configs"]])
def test_configurations_are_uncut(manifest, name):
    entry = {c["name"]: c for c in manifest["configs"]}[name]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    # a cut names keys the configuration has
    assert all(key in cfg for key in entry["reduced"])
    if name in UNCUT:
        n, kl, tiny = UNCUT[name]
        assert (cfg["n"], cfg["kl"], cfg["ku"]) == (n, kl, kl)
        assert entry["reduced"] == [] and cfg["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
        # their tiny runs are the ones the tests always ran
        assert cfg["tiny"] == tiny

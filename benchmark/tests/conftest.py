"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

The cells and configurations the tests run are those ``BENCHMARK.json``
names, so a cell added by files and manifest entries alone is tested with
the others.  Each configuration's file holds a ``tiny`` object: the keys
(and, merged, the options) that cut it to a size the CPU runs in about a
second.

Tests that need the card carry the ``cuda`` marker and take the ``card``
fixture, which skips where no CUDA device is found; the look is made when
the test runs, never at import.
"""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in MANIFEST["workloads"])
# the end-to-end metrics every cell of PINNED reports
E2E = {"rhs_per_s", "solve_p95_ms", "setup_s"}
_PER_LAYER = ["its_per_rhs", "krylov_ms_per_it", "pc_apply_ms",
              "pc_apply_roofline", "device_idle_pct", "launches_per_rhs",
              "pc_setup_s", "operator_ms", "sweep_ms", "reduced_solve_ms"]
# the first four cells, held to what they were built with: rtol, columns a
# call, and their exact per-layer metrics, in the manifest's order
PINNED = {
    "flagship-bcgs-r32": dict(rtol=1e-8, columns=32,
                              per_layer=_PER_LAYER + ["host_syncs_per_it"]),
    "spd-cg-1rhs": dict(rtol=1e-8, columns=1,
                        per_layer=_PER_LAYER + ["host_syncs_per_it"]),
    "spd-cg-r32": dict(rtol=1e-8, columns=32,
                       per_layer=_PER_LAYER + ["host_syncs_per_it"]),
    # gmres reads its scalars outside ``_host``: no ``KSPHostSync``
    "flagship-gmres-1rhs": dict(rtol=1e-8, columns=1, per_layer=_PER_LAYER),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card")
    return torch.device("cuda:0")


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's files (not its tests) under
    ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return dest


def shrink(root: Path, file: str) -> None:
    """Cut the configuration in ``root / file`` by its ``tiny`` object: a
    key set anew, a group of keys (the options) merged."""
    path = root / file
    cfg = json.loads(path.read_text())
    for key, value in cfg["tiny"].items():
        if isinstance(value, dict):
            cfg[key] = {**cfg[key], **value}
        else:
            cfg[key] = value
    path.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with every configuration cut to its
    ``tiny`` size."""
    root = copy_benchmark(tmp_path)
    for entry in MANIFEST["configs"]:
        shrink(root, entry["file"])
    return root

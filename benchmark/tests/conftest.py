"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need the card carry the ``cuda`` marker and take the ``card``
fixture, which skips where no CUDA device is found; the look is made when
the test runs, never at import.
"""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("flagship-bcgs-r32", "spd-cg-1rhs", "spd-cg-r32",
         "flagship-gmres-1rhs")
# the end-to-end metrics every cell reports
E2E = {"rhs_per_s", "solve_p95_ms", "setup_s"}
# each configuration at a size the CPU runs in a second: the same
# generator, PC type and options, fewer rows, a narrower band, fewer and
# smaller partitions
TINY = {"flagship-w201": dict(n=6000, kl=8, ku=8, K=8, b=16),
        "spd-w33": dict(n=6000, kl=4, ku=4, K=4, b=16)}


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


def shrink(root: Path, name: str, n, kl, ku, K, b) -> None:
    path = root / "benchmark" / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    pc = cfg["pc_type"]
    cfg.update(n=n, kl=kl, ku=ku)
    cfg["options"][f"pc_{pc}_partitions"] = K
    cfg["options"][f"pc_{pc}_block"] = b
    path.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with every configuration cut to ``TINY``."""
    root = copy_benchmark(tmp_path)
    for name, size in TINY.items():
        shrink(root, name, **size)
    return root

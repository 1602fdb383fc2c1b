"""The benchmark on the card (marked ``cuda``; skipped without one)."""

import json
import subprocess
import sys

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import CELLS, ROOT

pytestmark = pytest.mark.cuda


def test_a_short_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "spd-cg-1rhs",
         "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert proc.stderr.splitlines()[-1].startswith("check unconverged")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    limit = harness.cell_spec(ROOT, cell)["limits"]["xerr"]
    for seed in (4000000011, 4000000012, 4000000013):
        got = control.readings(ROOT, cell, seed, card)
        assert got["program"] < limit < got["control"], got

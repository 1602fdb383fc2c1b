"""PyTorch port, the PETSc residual-history parity harness
(``tools/petsc_parity.py``) against the JAX package's, on the CPU in f64.

``CASES`` equal JAX's by name, parameters and fixture; the port's
``run_ours`` equals JAX's through ``compare``, with iteration counts equal
and histories within 1e-10 (relative to the first residual).  The golden
and live modes (PETSc histories) skip as JAX's do: no golden file is
recorded and no petsc4py is installed here.
"""

import json
import os

import numpy as np
import pytest

from spike_petsc_tpu.tools import petsc_parity as jpp
from spike_petsc_tpu_torch.tools import petsc_parity as pp

from torch_parity import CPU

HIST_TOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "petsc_histories.json")


def _case_ids():
    return [c[0] for c in pp.CASES]


def test_cases_and_constants_match_jax():
    assert [c[0] for c in pp.CASES] == [c[0] for c in jpp.CASES]
    for mine, ref in zip(pp.CASES, jpp.CASES):
        assert mine[2:] == ref[2:]
        a, b = mine[1](), ref[1]()
        assert a.shape == b.shape and (a != b).nnz == 0
    assert (pp.HIST_RTOL, pp.HIST_FLOOR) == (jpp.HIST_RTOL, jpp.HIST_FLOOR)
    a = jpp.CASES[0][1]()
    assert np.array_equal(pp._rhs_for(a), jpp._rhs_for(a))


@pytest.mark.parametrize("case", pp.CASES, ids=_case_ids())
def test_run_ours_matches_jax(case):
    name, fix, ksp, pc, rtol, maxit, restart = case
    a = fix()
    ours = pp.run_ours(a, ksp, pc, rtol, maxit, restart, device=CPU)
    ref = jpp.run_ours(a, ksp, pc, rtol, maxit, restart)
    assert ours["its"] == ref["its"], name
    assert pp.compare(ours, ref, ksp) == [] == jpp.compare(ours, ref, ksp)
    h, hr = np.array(ours["history"]), np.array(ref["history"])
    assert h.shape == hr.shape
    assert np.abs(h - hr).max() <= HIST_TOL * hr[0], name
    # the standing guarantee of JAX's harness test: converged in bounds
    assert 0 < ours["its"] < maxit and h[-1] <= 10 * rtol * h[0]


def test_compare_flags_mismatches():
    ref = {"its": 10, "history": [1.0, 0.1, 0.01]}
    for cmp in (pp.compare, jpp.compare):
        assert cmp({"its": 10, "history": [1.0, 0.1, 0.01]}, ref,
                   "gmres") == []
        assert cmp({"its": 12, "history": [1.0, 0.1, 0.01]}, ref, "gmres")
        assert cmp({"its": 10, "history": [1.0, 0.2, 0.01]}, ref, "gmres")
        assert cmp({"its": 11, "history": [9.0]}, ref, "bcgs") == []


def test_main_prints_usage_without_record(capsys):
    assert pp.main([]) == 1
    assert "petsc_parity record" in capsys.readouterr().out


@pytest.mark.parametrize("case", pp.CASES, ids=_case_ids())
def test_live_parity(case):
    pytest.importorskip("petsc4py",
                        reason="no PETSc build in this environment")
    name, fix, ksp, pc, rtol, maxit, restart = case
    a = fix()
    ours = pp.run_ours(a, ksp, pc, rtol, maxit, restart, device=CPU)
    ref = pp.run_petsc(a, ksp, pc, rtol, maxit, restart)
    assert not pp.compare(ours, ref, ksp), name


@pytest.mark.parametrize("case", pp.CASES, ids=_case_ids())
def test_golden_parity(case):
    if not os.path.exists(GOLDEN):
        pytest.skip("golden histories not recorded (needs a PETSc "
                    "environment; see tools/petsc_parity.py)")
    name, fix, ksp, pc, rtol, maxit, restart = case
    with open(GOLDEN) as f:
        rec = json.load(f)[name]
    assert (rec["ksp"], rec["pc"], rec["rtol"], rec["maxit"],
            rec["restart"]) == (ksp, pc, rtol, maxit, restart)
    ours = pp.run_ours(fix(), ksp, pc, rtol, maxit, restart, device=CPU)
    assert not pp.compare(ours, rec, ksp), name

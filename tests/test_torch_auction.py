"""PyTorch port, the single-device auction matching
(``parallel/matching_dev.py``) against the JAX package's, on the CPU, on
the cases of tests/test_matching_dev.py, and ``tools.wbm -matching
auction`` against the JAX tool.

Tolerances: the matching and the round count equal; prices and both
scalings within 1e-12 (relative, the same f64 arithmetic in the same
order); the tool's output line for line.
"""

import contextlib
import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spike_petsc_tpu.models import problems
from spike_petsc_tpu.parallel import matching_dev as jmd
from spike_petsc_tpu.tools import wbm as jwbm
from spike_petsc_tpu_torch import sparse as hsp
from spike_petsc_tpu_torch.ordering import mc64
from spike_petsc_tpu_torch.parallel import matching_dev as tmd
from spike_petsc_tpu_torch.tools import wbm as twbm

from torch_parity import CPU

REL_TOL = 1e-12


def _near_optimal_case(seed, n=60):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.15, random_state=rng,
                  data_rvs=lambda k: rng.uniform(0.1, 10, k))
    a = a + sp.csr_matrix((rng.uniform(0.5, 5, n),
                           (np.arange(n), rng.permutation(n))), shape=(n, n))
    return a.tocsr(), dict(eps=1e-6 / n)


CASES = {
    "doc_example": lambda: (problems.mc64_doc_example(), {}),
    "near_optimal_0": lambda: _near_optimal_case(0),
    "near_optimal_1": lambda: _near_optimal_case(1),
    "near_optimal_2": lambda: _near_optimal_case(2),
    "scaling_invariant": lambda: (problems.illscaled_nonsym(80, 3, 3, seed=4),
                                  dict(eps=1e-7)),
    "improves_diagonal": lambda: (
        problems.illscaled_nonsym(150, 4, 4, seed=6), {}),
    "round_budget": lambda: (problems.illscaled_nonsym(150, 4, 4, seed=6),
                             dict(max_rounds=40)),
}


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.all(np.abs(got - ref) <= REL_TOL * np.maximum(np.abs(ref), 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_auction_match_matches_jax(case):
    a, kw = CASES[case]()
    jres = jmd.auction_match(a, **kw)
    tres = tmd.auction_match(a, device=CPU, **kw)
    assert np.array_equal(tres.rperm, jres.rperm)
    assert np.array_equal(tres.cperm, jres.cperm)
    assert tres.info == jres.info
    assert _close(tres.row_scale, jres.row_scale)
    assert _close(tres.col_scale, jres.col_scale)
    assert np.array_equal(np.sort(tres.rperm), np.arange(a.shape[0]))


@pytest.mark.parametrize("case", ["near_optimal_0", "scaling_invariant",
                                  "improves_diagonal"])
@pytest.mark.parametrize("check_every", [1, 7, 10_000])
def test_auction_rounds_prices_match_jax(case, check_every, monkeypatch):
    """The rounds' raw output: match, row owners and prices against JAX's
    ``_auction_rounds``, whatever the host's check interval
    (``CHECK_EVERY``)."""
    monkeypatch.setattr(tmd, "CHECK_EVERY", check_every)
    a, kw = CASES[case]()
    rows_np, logw_np, n = tmd.csc_to_ell(a)
    eps = kw.get("eps", 1e-3 / n)
    ben = -np.where(np.isfinite(logw_np), logw_np, np.inf)
    jm, jR, jp, jr = jmd._auction_rounds(
        jnp.asarray(rows_np), jnp.asarray(ben), n=n, eps=eps,
        max_rounds=50 * n)
    tm, tR, tp, tr = tmd._auction_rounds(
        torch.as_tensor(rows_np.astype(np.int64)), torch.as_tensor(ben),
        n=n, eps=eps, max_rounds=50 * n)
    assert tr == int(jr)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tR.numpy(), np.asarray(jR))
    assert _close(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("case", sorted(CASES))
def test_csc_to_ell_matches_jax(case):
    a, _ = CASES[case]()
    a = sp.csr_matrix(a)
    a[0, a.shape[1] - 1] = 0.0              # an explicit zero, dropped
    for got, ref in zip(tmd.csc_to_ell(a), jmd.csc_to_ell(a)):
        assert np.array_equal(got, ref)
    assert np.array_equal(tmd.csc_to_ell(sp.csr_matrix((4, 4)))[0],
                          jmd.csc_to_ell(sp.csr_matrix((4, 4)))[0])


def test_auction_near_optimal_against_mc64():
    """JAX's bound: within n * eps of MC64 job 5's log-product."""
    a, kw = _near_optimal_case(1)
    exact = mc64(a, job=5)
    approx = tmd.auction_match(a, device=CPU, **kw)
    lp_exact = np.sum(np.log(np.abs(exact.apply(a).diagonal())))
    lp_approx = np.sum(np.log(np.abs(approx.apply(a).diagonal())))
    assert lp_approx >= lp_exact - 1e-3
    sa = tmd.auction_match(problems.illscaled_nonsym(80, 3, 3, seed=4),
                           eps=1e-7, device=CPU)
    scaled = sa.apply(problems.illscaled_nonsym(80, 3, 3, seed=4),
                      scale=True)
    np.testing.assert_allclose(np.abs(scaled.diagonal()), 1.0, rtol=1e-4)
    assert hsp.diagonal_weight_product(scaled) > 0


def test_auction_match_dist_is_not_yet_ported(tmp_path):
    """``auction_match_dist`` (ported: it raised NotImplementedError
    before) runs on a one-rank gloo mesh (a spawned rank,
    ``torch_dist_worker``) and gives the JAX package's matching, rounds
    and scalings on MC64's documentation example at its defaults
    (tests/test_torch_dist_auction.py holds P = 2 and 4)."""
    from spike_petsc_tpu.parallel import make_mesh
    from torch_dist_worker import case_result, run_ranks
    got = case_result(run_ranks(1, "torch_dist_ms_cases:auction_doc_program",
                                tmp_path), "doc")
    ref = jmd.auction_match_dist(problems.mc64_doc_example(), make_mesh(1))
    np.testing.assert_array_equal(got["rperm"], ref.rperm)
    assert int(got["rounds"]) == ref.info["rounds"]
    assert int(got["completed"]) == ref.info.get("completed", 0)
    np.testing.assert_allclose(got["row_scale"], ref.row_scale,
                               rtol=REL_TOL)
    np.testing.assert_allclose(got["col_scale"], ref.col_scale,
                               rtol=REL_TOL)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("scale", ["0", "1"])
def test_wbm_tool_auction_matches_jax(tmp_path, scale):
    a = problems.illscaled_nonsym(120, 3, 3, seed=2)
    path = str(tmp_path / "a.npz")
    sp.save_npz(path, sp.csr_matrix(a))
    argv = ["-filename", path, "-matching", "auction", "-scale", scale,
            "-outfilename", str(tmp_path / "p.mtx")]
    jrc, jout = _run(jwbm.main, argv)
    trc, tout = _run(twbm.main, argv + ["-platform", "cpu"])
    assert jrc == trc == 0
    assert tout == jout
    assert "'type': 'auction'" in tout

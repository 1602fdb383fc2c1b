"""The port's ``auction_match_dist`` (columns sharded over a mesh axis)
on P = 2 and P = 4 gloo ranks against the JAX package's on as many
virtual CPU devices (``tests/test_dist_auction.py``'s matrix and eps):
the same ``rperm`` and ``info["rounds"]``, the scalings within 1e-12
(relative, elementwise), the same result on every rank, and the JAX
test's own checks (a permutation, a log-product at least MC64 job 5's
less 1e-3, a scaled diagonal of ones within 1e-3)."""

import numpy as np
import pytest

from spike_petsc_tpu.ordering import mc64
from spike_petsc_tpu.parallel import auction_match_dist, make_mesh

import torch_dist_ms_cases as M
from test_torch_dist import same_on_every_rank
from torch_dist_worker import run_ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {P: run_ranks(P, "torch_dist_ms_cases:auction_program",
                         tmp_path_factory.mktemp(f"auction{P}"))
            for P in (2, 4)}


@pytest.mark.parametrize("P", [2, 4])
def test_dist_auction_matches_jax(worlds, P):
    got = same_on_every_rank(worlds[P], "auction")
    a = M.auction_matrix()
    n = a.shape[0]
    ref = auction_match_dist(a, make_mesh(P, axis="p"), eps=1e-6 / n)
    np.testing.assert_array_equal(got["rperm"], ref.rperm)
    assert int(got["rounds"]) == ref.info["rounds"] > 0
    assert int(got["devices"]) == ref.info["devices"] == P
    assert int(got["completed"]) == ref.info.get("completed", 0)
    np.testing.assert_allclose(got["row_scale"], ref.row_scale, rtol=1e-12)
    np.testing.assert_allclose(got["col_scale"], ref.col_scale, rtol=1e-12)
    assert np.array_equal(np.sort(got["rperm"]), np.arange(n))
    ap = a.tocsr()[got["rperm"]]
    lp = np.sum(np.log(np.abs(ap.diagonal())))
    lp_e = np.sum(np.log(np.abs(mc64(a, job=5).apply(a).diagonal())))
    assert lp >= lp_e - 1e-3, (lp, lp_e)
    sa = (ap.multiply(got["row_scale"][got["rperm"]][:, None])
          .multiply(got["col_scale"][None, :])).tocsr()
    np.testing.assert_allclose(np.abs(sa.diagonal()), 1.0, rtol=1e-3)

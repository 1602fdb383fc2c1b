"""The port's ``resilient_serve`` (``parallel/elastic.py``) on four gloo
ranks against the JAX package's (virtual CPU devices): the four
``resilient_serve`` tests of the JAX package's ``tests/test_elastic.py``
(five runs: its default-policy test runs a transient and a persistent
fault) with its 8-device shapes halved ((2, 2, 1) -> (1, 2, 1) and (2, 2) ->
(1, 2)), f64.  ``attempts``, ``failures`` and ``meshes_used`` equal JAX's,
X within 1e-10 of JAX's and 1e-7 of the true solution (relative to its
largest entry).
"""

import pytest
import jax.numpy as jnp

import spike_petsc_tpu.parallel.elastic as jel
from spike_petsc_tpu.ops.band import BandedMatrix

import torch_dist_ms_cases as M
from test_torch_dist import close, same_on_every_rank
from test_torch_elastic import jit_jax_factors, meshes   # noqa: F401
from torch_dist_worker import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jit_jax_factors):            # noqa: F811
    return run_ranks(4, "torch_dist_ms_cases:elastic_serve_program",
                     tmp_path_factory.mktemp("elastic_serve")), None


@pytest.mark.parametrize("name", list(M.ELASTIC_SERVE))
def test_resilient_serve(ranks, name):
    got = same_on_every_rank(ranks[0], "serve_" + name)
    prob, opts, inj = M.ELASTIC_SERVE[name]
    data, kl, ku, U, B = M.serve_problem(*prob)
    band = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    res = jel.resilient_serve(band, B, fault_injector=M.serve_injector(inj),
                              **M._options(opts))
    assert int(got["attempts"]) == res.attempts
    assert int(got["failures"]) == res.failures
    assert got["meshes"].tolist() == meshes(res)
    close(got["X"], res.X, 1e-10)
    close(got["X"], U, 1e-7)

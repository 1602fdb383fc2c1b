"""The port's 3-D (rhs, slice, p) serving mesh (``make_mesh_3d``,
``make_dist_solver_3d``) on four gloo ranks, shapes (2, 2, 1) and
(2, 1, 2), against the JAX package's on ``make_mesh_3d`` of the same
shapes (virtual CPU devices, ``jax.jit``), f64.

* richardson serving: every column within 1e-10 of JAX's, and equal to
  the single-replica multislice engine on the same (slice, p) shape within
  1e-12 (the replicas take the same trips, the largest residual of all);
* preonly: the same right-hand side on both replicas gives bit-equal
  answers, as in JAX; gmres converges to the true solution on both;
* the trip-count regression (JAX ``tests/test_dist_parity.py:408``):
  replicas of uneven difficulty (half the columns scaled by 1e6), two
  partitions a slice (one a rank on (2, 1, 2), as in JAX's repro),
  richardson and gmres: every replica takes the same
  number of trips, so the run ends inside the ranks' wall limit with no
  collective timeout, within 1e-8 of the solution and 1e-10 of JAX's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                      make_dist_solver_3d, make_mesh_3d)

import torch_dist_cases as C
import torch_dist_ms_cases as M
from test_torch_dist import close
from torch_dist_worker import case_result, run_ranks

SHAPES = {"".join(map(str, s)): s for s in M.D3_SHAPES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "torch_dist_ms_cases:d3_program",
                     tmp_path_factory.mktemp("d3"))


def jsolve(shape, data, kl, ku, B, ppd, store=False, **sopts):
    mesh3 = make_mesh_3d(shape)
    dsf = jax.jit(lambda d: dist_spike_factor_multislice(
        BandedMatrix(data=d, kl=kl, ku=ku), mesh3, block_b=8,
        parts_per_device=ppd, store_spikes=store, safety_net=False))(
            jnp.asarray(data))
    return np.asarray(jax.jit(lambda d, r: make_dist_solver_3d(
        d, mesh3, **sopts)(r))(dsf, jnp.asarray(B)))


def every_rank(ranks, case, key):
    x = case_result(ranks, case)[key]
    for r in range(1, 4):
        np.testing.assert_array_equal(case_result(ranks, case, r)[key], x)
    return x


@pytest.mark.parametrize("tag", list(SHAPES))
def test_3d_richardson_serving(ranks, tag):
    x = every_rank(ranks, "serve_" + tag, "x")
    data, kl, ku, U, B = M.d3_serve_input()
    X = jsolve(SHAPES[tag], data, kl, ku, B, M.D3_SERVE[1], store=True,
               ksp_type="richardson", rtol=1e-9, maxit=40)
    for j in range(U.shape[0]):
        close(x[j], X[j], 1e-10)
        close(case_result(ranks, "serve_" + tag)["x_single"][j], x[j], 1e-12)
    assert np.linalg.norm(x - U) / np.linalg.norm(U) < 1e-6


@pytest.mark.parametrize("tag", list(SHAPES))
def test_3d_preonly_and_gmres(ranks, tag):
    got = case_result(ranks, "preonly_" + tag)
    xp, xk = every_rank(ranks, "preonly_" + tag, "xp"), got["xk"]
    np.testing.assert_array_equal(xp[0], xp[1])
    args, ppd, seed = M.D3_PREONLY
    data, kl, ku = C.band(*args)
    u = C.rhs(data.shape[0], seed)
    b = C.band_matvec_np(data, kl, ku, u)
    B = np.stack([b, b])
    close(xp, jsolve(SHAPES[tag], data, kl, ku, B, ppd,
                     ksp_type="preonly"), 1e-12)
    Xk = jsolve(SHAPES[tag], data, kl, ku, B, ppd, ksp_type="gmres",
                rtol=1e-10, maxit=40)
    for j in range(2):
        close(xk[j], Xk[j], 1e-10)
        close(xk[j], u, 1e-6)


@pytest.mark.parametrize("tag", list(SHAPES))
def test_3d_trip_count_sync(ranks, tag):
    data, kl, ku, U, B = M.d3_trips_input()
    for kt in ("richardson", "gmres"):
        x = every_rank(ranks, "trips_" + tag, kt)
        assert np.linalg.norm(x - U) / np.linalg.norm(U) < 1e-8, kt
        X = jsolve(SHAPES[tag], data, kl, ku, B,
                   M.d3_trips_ppd(SHAPES[tag]), ksp_type=kt, rtol=1e-10,
                   maxit=60)
        for j in range(U.shape[0]):
            close(x[j], X[j], 1e-10)

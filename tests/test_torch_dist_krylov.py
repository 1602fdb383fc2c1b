"""The port's ``make_dist_solver`` on gloo ranks against the JAX package's
(``make_mesh(P)`` on the virtual CPU devices), P = 2 and 4, f64: gmres
(the default and the ``ifneeded`` refinement), bcgs, cg, tfqmr and bicg
with ``dist_spike_transpose``, the null-space CG of ``dryrun_multichip``
stage 4, and the banded matvec route of its stage 2 (f32).

Iteration counts and reasons must equal JAX's exactly; x within 1e-10 and
the residual histories within 1e-8, relative to their largest entry (the
sums run in another order; the singular null-space case holds x to 1e-5,
for the reason its docstring gives).  The banded route (f32) must take JAX's
iteration count, agree with the blocks route and JAX within 1e-5, and the
transpose solve of the bicg case JAX's within 1e-12.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (dist_spike_factor, dist_spike_solve,
                                      dist_spike_transpose, make_dist_solver,
                                      make_mesh)
from spike_petsc_tpu.solvers.nullspace import make_nullspace

import torch_dist_cases as C
from torch_dist_worker import case_result, run_ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    P = request.param
    ranks = run_ranks(P, "torch_dist_cases:krylov_program",
                      tmp_path_factory.mktemp(f"krylov{P}"))
    return P, ranks, make_mesh(P, axis="p")


def jfactor(mesh, data, kl, ku, **opts):
    return jax.jit(lambda d: dist_spike_factor(
        BandedMatrix(data=d, kl=kl, ku=ku), mesh, safety_net=False,
        **opts))(jnp.asarray(data))


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-300), (err, tol)


def check_krylov(got, res, x_tol=1e-10, prefix=""):
    its = int(res.its)
    assert int(got[prefix + "its"]) == its
    assert int(got[prefix + "reason"]) == int(res.reason) > 0
    close(got[prefix + "x"], res.x, x_tol)
    close(got[prefix + "history"][:its + 1],
          np.asarray(res.history)[:its + 1], 1e-8)


@pytest.mark.parametrize("case", list(C.KRYLOV_CASES))
def test_make_dist_solver(world, case):
    P, ranks, mesh = world
    got = case_result(ranks, case)
    for r in range(1, P):
        assert int(case_result(ranks, case, r)["its"]) == int(got["its"])
        np.testing.assert_array_equal(case_result(ranks, case, r)["x"],
                                      got["x"])
    args, fopts, kopts = C.KRYLOV_CASES[case]
    data, kl, ku = C.band(*args)
    dsf = jfactor(mesh, data, kl, ku, **fopts)
    kw = dict(kopts)
    if kw["ksp_type"] == "bicg":
        kw["dsf_transpose"] = dist_spike_transpose(dsf, mesh)
        xt = jax.jit(lambda d, r: dist_spike_solve(d, r, mesh))(
            kw["dsf_transpose"], jnp.asarray(C.rhs(data.shape[0], 105)))
        close(got["xt"], xt, 1e-12)
    b = C.band_matvec_np(data, kl, ku, np.ones(data.shape[0]))
    check_krylov(got, make_dist_solver(dsf, mesh, **kw)(jnp.asarray(b)))


def test_nullspace_cg(world):
    """``dryrun_multichip`` stage 4: the Neumann Laplacian's constant null
    space, an inconsistent right-hand side, a shifted SPIKE PC.

    The operator is singular, and so is the SPIKE reduced system (the shift
    guards the partitions' pivots only): the PC multiplies the rounding
    left in the null direction by ~1/eps before the projection removes it
    (``solvers/nullspace.py``), so the two packages' PC outputs differ at
    O(1e-2) after the first iteration, however the sums are ordered.  The
    iteration count and reason must still equal JAX's, the first residual
    to 1e-12, and x JAX's within 1e-5 and the mean-free solution within
    the stage's own 5e-3."""
    P, ranks, mesh = world
    got = case_result(ranks, "nullspace")
    n, ppd = C.nullspace_geometry(P)
    data, u, b = C.nullspace_input(n)
    ns = make_nullspace(n, constant=True, dtype=jnp.float64)
    dsf = jfactor(mesh, data, 1, 1, block_b=4, parts_per_device=ppd,
                  shift="nonzero", shift_amount=1e-2)
    res = make_dist_solver(dsf, mesh, ksp_type="cg", nullspace=ns,
                           rtol=1e-6, maxit=100)(jnp.asarray(b))
    assert int(got["its"]) == int(res.its)
    assert int(got["reason"]) == int(res.reason) > 0
    close(got["history"][:1], np.asarray(res.history)[:1], 1e-12)
    close(got["x"], res.x, 1e-5)
    assert abs(got["x"].mean()) < 1e-5
    assert np.abs(got["x"] - u).max() < 5e-3


def test_banded_route(world):
    """``dryrun_multichip`` stage 2: the matvec on each rank's stored band
    rows (#2 on the card) against the blocks route and JAX's
    banded_pallas route, f32."""
    P, ranks, mesh = world
    got = case_result(ranks, "banded_route")
    assert str(got["banded_pallas_route"]) == "banded_cuda"
    assert str(got["blocks_route"]) == "blocks"
    data, kl, ku = C.banded_route_input(P)
    data32 = data.astype(np.float32)
    b = C.band_matvec_np(data, kl, ku, np.ones(data.shape[0]))
    dsf = jfactor(mesh, data32, kl, ku, block_b=8, parts_per_device=2,
                  matvec_impl="banded_pallas")
    assert dsf.mv_d3 is not None
    res = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-6,
                           maxit=10)(jnp.asarray(b, jnp.float32))
    assert int(got["banded_pallas_its"]) == int(res.its)
    close(got["banded_pallas_x"], res.x, 1e-5)
    close(got["banded_pallas_x"], got["blocks_x"], 1e-5)
    assert np.abs(got["banded_pallas_x"] - 1.0).max() < 1e-3

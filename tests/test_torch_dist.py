"""The port's distributed SPIKE factor and direct solves on gloo ranks
against the JAX package's ``shard_map`` path (``make_mesh(P)`` on the
virtual CPU devices), P = 2 and 4, f64.

The ranks start once per P (``torch_dist_worker.run_ranks``) and run every
case of ``torch_dist_cases.dist_program``; the JAX side runs here on the
same numpy inputs, its factor and solves under ``jax.jit`` (an eager
``shard_map`` dispatches primitive by primitive, ~20x slower), so the
Newton probe runs on the port only and JAX gives the factor it falls back
to.  Tolerances: factor pieces and direct solves within
1e-12 of JAX (relative to the largest entry; the sums run in another
order); the bf16-stored spikes within 1e-9 of JAX's bf16 result, whose
spikes round to the same bf16 values.  Also: P = 1 (one rank, no send or
recv) against the port's single-device ``spike_solve`` on the same factor
settings, and the Krylov reduction hook on a one-rank group bit-identical
to the same call without an axis.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (dist_spike_factor, dist_spike_solve,
                                      dist_spike_solve_many,
                                      make_dist_solver, make_mesh)

import torch_dist_cases as C
from torch_dist_worker import case_result, run_ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tmp_path_factory):
    P = request.param
    ranks = run_ranks(P, "torch_dist_cases:dist_program",
                      tmp_path_factory.mktemp(f"dist{P}"))
    return P, ranks, make_mesh(P, axis="p")


def jax_options(opts):
    names = {"bf16": jnp.bfloat16}
    return {k: names.get(v, v) if k.endswith("dtype") else v
            for k, v in opts.items()}


def jfactor(mesh, args, **opts):
    """JAX's dist_spike_factor under jit (no probe: it needs the host)."""
    data, kl, ku = C.band(*args)
    return jax.jit(lambda d: dist_spike_factor(
        BandedMatrix(data=d, kl=kl, ku=ku), mesh, safety_net=False,
        **jax_options(opts)))(jnp.asarray(data))


def jsolve(mesh, dsf, b, many=False):
    fn = dist_spike_solve_many if many else dist_spike_solve
    return np.asarray(jax.jit(lambda d, r: fn(d, r, mesh))(
        dsf, jnp.asarray(b)))


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-300), (err, tol)


def same_on_every_rank(ranks, case):
    first = case_result(ranks, case)
    for r in range(1, len(ranks)):
        other = case_result(ranks, case, r)
        for key, v in first.items():
            np.testing.assert_array_equal(other[key], v, err_msg=key)
    return first


def test_factor_pieces(world):
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, "factor_pieces")
    for trunc in (False, True):
        dsf = jfactor(mesh, ("nonsym", 640, 3, 1, 2), block_b=8,
                      parts_per_device=2, truncated=trunc)
        tag = "t_" if trunc else ""
        close(got[tag + "Btip"], dsf.Btip, 1e-12)
        close(got[tag + "Ctip"], dsf.Ctip, 1e-12)
        if trunc:
            close(got["red_Dinv"], dsf.red_Dinv, 1e-12)
        else:
            for f in ("F", "U", "Sinv"):
                close(got["red_" + f], getattr(dsf.red_fact, f), 1e-12)


@pytest.mark.parametrize("case", list(C.SOLVE_CASES))
def test_dist_spike_solve(world, case):
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, "solve_" + case)
    args, opts = C.SOLVE_CASES[case]
    data, kl, ku = C.band(*args)
    b = C.rhs(data.shape[0], 100)
    x = jsolve(mesh, jfactor(mesh, args, **opts), b)
    close(got["x"], x, 1e-9 if "bf16" in case else 1e-12)
    resid = C.band_matvec_np(data, kl, ku, got["x"]) - b
    # a direct solve (truncated: dropped coupling, bf16: stored spikes)
    floor = {"truncated": 1e-3, "stored_bf16": 1e-2}.get(case, 1e-10)
    assert np.linalg.norm(resid) <= floor * np.linalg.norm(b)


@pytest.mark.parametrize("r", [2, 5])
def test_dist_spike_solve_many(world, r):
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, f"solve_many_{r}")
    dsf = jfactor(mesh, ("nonsym", 512, 3, 47, 2), block_b=8,
                  parts_per_device=2, store_spikes=True)
    close(got["x"], jsolve(mesh, dsf, C.rhs(512, 101, r), many=True), 1e-12)


def test_dist_inverter_safety_net(world):
    """The Newton inverter diverges on this band; the probe re-factors
    with the blocked inverter and the direct solve is accurate (JAX
    ``test_dist_inverter_safety_net``), as JAX's blocked factor solves."""
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, "safety_net")
    data, kl, ku = C.band("indefinite", 320, 2, 5)
    b = C.rhs(320, 102)
    a = sp.diags([data[2:, 0], data[1:, 1], data[:, 2], data[:-1, 3],
                  data[:-2, 4]], [-2, -1, 0, 1, 2]).tocsc()
    xs = spla.spsolve(a, b)
    assert np.linalg.norm(got["x"] - xs) / np.linalg.norm(xs) < 1e-6
    dsf = jfactor(mesh, ("indefinite", 320, 2, 5), block_b=4,
                  inverter="blocked")
    close(got["x"], jsolve(mesh, dsf, b), 1e-10)


def test_dist_safety_net_not_triggered_when_healthy(world):
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, "safety_net_healthy")
    assert bool(got["equal"])
    dsf = jfactor(mesh, ("spd", 256, 3, 43), block_b=4, inverter="newton")
    close(got["Sinv"], dsf.fact.Sinv, 1e-12)


def test_complex_distributed_solve(world):
    """JAX ``tests/test_complex.py::test_complex_distributed_solve`` on the
    port: the complex mesh factor, direct solve and mesh GMRES."""
    P, ranks, mesh = world
    got = same_on_every_rank(ranks, "complex")
    dsf = jfactor(mesh, ("complex", 384, 3, 21), block_b=8)
    b = jnp.asarray(C.rhs(384, 103, complex_=True))
    close(got["x"], jsolve(mesh, dsf, b), 1e-12)
    res = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-10,
                           maxit=20)(b)
    assert int(got["k_its"]) == int(res.its)
    assert int(got["k_reason"]) == int(res.reason) > 0
    close(got["k_x"], res.x, 1e-10)


def test_one_rank_mesh(world):
    """P = 1 against the single-device spike_solve, and the reduction hook
    on a one-rank group bit-identical to no axis (gmres, bcgs, cg)."""
    P, ranks, mesh = world
    got = case_result(ranks, "one_rank")
    close(got["x_dist"], got["x_single"], 1e-12)
    for name in ("gmres", "bcgs", "cg"):
        assert bool(got[name + "_bits"]), name
        assert int(got[name + "_reason"]) > 0
        assert int(got[name + "_its"]) >= 3, int(got[name + "_its"])

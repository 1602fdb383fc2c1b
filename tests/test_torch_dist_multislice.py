"""The port's multislice SPIKE (``make_mesh_multislice``,
``dist_spike_factor_multislice``, ``make_dist_solver_multislice``,
``make_dist_solver_multislice_batched``, ``dist_spike_transpose_multislice``)
on a (2, 2) mesh of four gloo ranks against the JAX package's on
``make_mesh_multislice((2, 2))`` of the virtual CPU devices, f64 unless
stated; the JAX factors and solvers run under ``jax.jit``.

Tolerances: factor pieces (the true tips, the PC-masked stored spikes and
each slice's reduced system) within 1e-12 of JAX's, relative to their
largest entry; Krylov iteration counts and reasons equal to JAX's, x
within 1e-10 and the residual histories within 1e-8 (the sums run in
another order); the bf16-stored spikes' solve within 1e-9; the serving
columns within 1e-10; the f32 band route within 1e-5 of JAX's and of the
blocks route.  The singular null-space solve holds x within 1e-6 (the
tolerance of the JAX package's own test) and its iterations to JAX's.
(1, 1) at one rank equals the 1-D mesh of one rank bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                      dist_spike_transpose_multislice,
                                      make_dist_solver_multislice,
                                      make_dist_solver_multislice_batched,
                                      make_mesh_multislice)
from spike_petsc_tpu.solvers.nullspace import make_nullspace

import torch_dist_cases as C
import torch_dist_ms_cases as M
from test_torch_dist import close, jax_options, same_on_every_rank
from test_torch_dist_krylov import check_krylov
from torch_dist_worker import case_result, run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "torch_dist_ms_cases:multislice_program",
                     tmp_path_factory.mktemp("multislice"))


def mesh_of(shape=(2, 2)):
    return make_mesh_multislice(shape)


def jfactor(mesh, data, kl, ku, **opts):
    return jax.jit(lambda d: dist_spike_factor_multislice(
        BandedMatrix(data=d, kl=kl, ku=ku), mesh, safety_net=False,
        **jax_options(opts)))(jnp.asarray(data))


def test_factor_pieces(ranks):
    got = same_on_every_rank(ranks, "factor")
    args, opts = M.MS_FACTOR
    data, kl, ku = C.band(*args)
    dsf = jfactor(mesh_of(), data, kl, ku, **opts)
    for f in ("Btip", "Ctip", "V", "W"):
        close(got[f], getattr(dsf, f), 1e-12)
    # JAX stacks the slices' reduced systems on the leading axis
    for f in ("F", "U", "Sinv"):
        ref = np.asarray(getattr(dsf.red_fact, f))
        close(got["red_" + f], ref.reshape(got["red_" + f].shape), 1e-12)
    assert str(got["red_type"]) == "BlockTriFactor"


@pytest.mark.parametrize("case", list(M.MS_KRYLOV))
def test_multislice_krylov(ranks, case):
    got = same_on_every_rank(ranks, "krylov_" + case)
    args, fopts, kopts, seed = M.MS_KRYLOV[case]
    data, kl, ku = C.band(*args)
    mesh = mesh_of()
    dsf = jfactor(mesh, data, kl, ku, **fopts)
    u = C.rhs(data.shape[0], seed)
    b = C.band_matvec_np(data, kl, ku, u)
    res = jax.jit(lambda d, r: make_dist_solver_multislice(
        d, mesh, **kopts)(r))(dsf, jnp.asarray(b))
    check_krylov(got, res, x_tol=1e-9 if "bf16" in case else 1e-10)
    assert np.abs(got["x"] - u).max() <= 1e-6 * np.abs(u).max()


@pytest.mark.parametrize("case", list(M.MS_BATCHED))
def test_multislice_batched(ranks, case):
    got = same_on_every_rank(ranks, "batched_" + case)
    args, fopts, sopts, r, shape = M.MS_BATCHED[case]
    data, kl, ku, U, B = M.batched_input(case)
    mesh = mesh_of(shape)
    dsf = jfactor(mesh, data, kl, ku, **fopts)
    X = np.asarray(jax.jit(lambda d, rr: make_dist_solver_multislice_batched(
        d, mesh, **sopts)(rr))(dsf, jnp.asarray(B)))
    assert got["x"].shape == X.shape == U.shape
    for j in range(r):
        close(got["x"][:, j], X[:, j], 1e-10)
    err = np.linalg.norm(got["x"] - U) / np.linalg.norm(U)
    if case == "preonly":
        # one PC apply, block-Jacobi across slices: a PC, not a solve
        assert 1e-10 < err < 0.5, err
    else:
        assert err < 1e-6, err


def test_multislice_transpose_and_bicg(ranks):
    got = same_on_every_rank(ranks, "transpose")
    args, fopts, g_seed, u_seed = M.MS_TRANSPOSE
    data, kl, ku = C.band(*args)
    mesh = mesh_of()
    dsf = jfactor(mesh, data, kl, ku, **fopts)
    dsft = jax.jit(lambda d: dist_spike_transpose_multislice(d, mesh))(dsf)
    close(got["Vt"], dsft.V, 1e-12)
    n = data.shape[0]
    g = C.rhs(n, g_seed)
    res = jax.jit(lambda d, r: make_dist_solver_multislice(
        d, mesh, ksp_type="gmres", rtol=1e-11, maxit=30)(r))(
            dsft, jnp.asarray(g))
    check_krylov(got, res, prefix="t_")
    a = np.zeros((n, n))
    for d in range(-kl, ku + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        a[rows, rows + d] = data[rows, d + kl]
    close(got["t_x"], np.linalg.solve(a.T, g), 1e-8)
    u = C.rhs(n, u_seed)
    b = C.band_matvec_np(data, kl, ku, u)
    res_b = jax.jit(lambda d, t, r: make_dist_solver_multislice(
        d, mesh, ksp_type="bicg", dsf_transpose=t, rtol=1e-11,
        maxit=40)(r))(dsf, dsft, jnp.asarray(b))
    check_krylov(got, res_b, prefix="b_")
    close(got["b_x"], u, 1e-8)


def test_multislice_nullspace(ranks):
    """JAX ``tests/test_nullspace.py::test_multislice_nullspace_solve`` at
    n = 512 on (2, 2): the projections sum over the whole plane."""
    got = same_on_every_rank(ranks, "nullspace")
    n, fopts, kopts = M.MS_NULLSPACE
    data = M.neumann_band(n)
    mesh = mesh_of()
    dsf = jfactor(mesh, data, 1, 1, **fopts)
    ns = make_nullspace(n, constant=True, dtype=jnp.float64)
    u = M.nullspace_u(n)
    b = C.band_matvec_np(data, 1, 1, u)
    res = make_dist_solver_multislice(dsf, mesh, nullspace=ns, **kopts)(
        jnp.asarray(b))
    assert int(got["its"]) == int(res.its)
    assert int(got["reason"]) == int(res.reason) > 0
    close(got["x"], res.x, 1e-6)
    assert abs(got["x"].mean()) < 1e-9
    assert np.abs(got["x"] - u).max() < 1e-6 * np.abs(u).max() + 1e-7


def test_multislice_banded_route(ranks):
    """JAX ``tests/test_parallel.py::test_multislice_matvec_banded_pallas_
    route`` (f32): the band rows' matvec with its strips around the plane's
    ring, against the blocks route and JAX's banded_pallas route."""
    got = same_on_every_rank(ranks, "banded")
    assert str(got["banded_pallas_route"]) == "banded_cuda"
    assert str(got["blocks_route"]) == "blocks"
    data, kl, ku = C.band(*M.MS_BANDED)
    b = C.band_matvec_np(data, kl, ku, C.rhs(data.shape[0], 6))
    mesh = mesh_of()
    dsf = jfactor(mesh, data.astype(np.float32), kl, ku, block_b=8,
                  matvec_impl="banded_pallas")
    assert dsf.mv_d3 is not None
    res = make_dist_solver_multislice(dsf, mesh, ksp_type="gmres",
                                      rtol=1e-5)(jnp.asarray(b, jnp.float32))
    assert int(got["banded_pallas_its"]) == int(res.its)
    assert int(got["banded_pallas_reason"]) > 0
    close(got["banded_pallas_x"], res.x, 1e-5)
    close(got["banded_pallas_x"], got["blocks_x"], 1e-5)


def test_one_rank_multislice_is_the_1d_mesh(ranks):
    got = case_result(ranks, "one_rank")
    assert bool(got["factor_bits"])
    assert bool(got["x_bits"])
    assert int(got["its"]) == int(got["its_1d"]) > 0

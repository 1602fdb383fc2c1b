"""PyTorch port, null spaces (``solvers/nullspace.py`` and the projections
of ``make_solver``/``make_solver_many``), against the JAX package.

The cases of ``tests/test_nullspace.py``: an orthonormal basis from the
constant and a user vector; the singular 1-D Neumann Laplacian (null space
span{1}) solved by cg + jacobi to the zero-mean representative through
``solve``, ``make_solver``, ``-ksp_nullspace_constant`` and
``solve_many``; an inconsistent right-hand side projected to the
consistent answer; a nonsymmetric singular dense matrix with distinct
right and left null spaces (gmres); and the testbed's
``-problem neumann -ksp_nullspace_constant 1`` line by line.

Inputs: numpy-seeded vectors handed to both packages, f64, the CPU.
Tolerances: the iteration counts and reasons equal; histories within rtol
1e-8 with a floor of 1e-12 of the first entry; solutions within 1e-8 of
JAX's and within the JAX test's bounds of the truth.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.solvers import nullspace as jns
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.solvers import nullspace as tns

from torch_parity import CPU, compare_testbeds


def _neumann(n):
    data = np.tile([-1.0, 2.0, -1.0], (n, 1))
    data[0, 1] = data[-1, 1] = 1.0
    return data


def _mv(data, x):
    """The Neumann band times x on the host (edge slots multiply zero)."""
    y = data[:, 1] * x
    y[1:] += data[1:, 0] * x[:-1]
    y[:-1] += data[:-1, 2] * x[1:]
    return y


def _bands(n):
    data = _neumann(n)
    return (data, JBand(jnp.asarray(data), 1, 1),
            banded_from_numpy(data, 1, 1, device=CPU))


def _zero_mean(rng, *shape):
    u = rng.standard_normal(shape)
    return u - u.mean(axis=0)


def _history_close(rt, rj):
    its = rt.its
    hj = np.asarray(rj.history)[:its + 1]
    np.testing.assert_allclose(rt.history.numpy()[:its + 1], hj, rtol=1e-8,
                               atol=1e-12 * hj[0])


def test_make_nullspace_orthonormal():
    ns = tns.make_nullspace(50, constant=True, dtype=torch.float64,
                            device=CPU)
    assert ns.dim == 1 and ns.constant
    np.testing.assert_allclose(float(torch.linalg.norm(ns.vecs[:, 0])), 1.0,
                               rtol=1e-12)
    v = np.arange(50, dtype=np.float64)
    ns2 = tns.make_nullspace(50, constant=True, vecs=torch.from_numpy(v))
    Q = ns2.vecs.numpy()
    np.testing.assert_allclose(Q.T @ Q, np.eye(2), atol=1e-12)
    # the same span as JAX's basis
    Qj = np.asarray(jns.make_nullspace(50, constant=True,
                                       vecs=jnp.asarray(v)).vecs)
    np.testing.assert_allclose(Q @ Q.T, Qj @ Qj.T, atol=1e-12)
    x = np.random.default_rng(0).standard_normal((50, 3))
    y = ns2.remove(torch.from_numpy(x))
    np.testing.assert_allclose(Q.T @ y.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(ns2.remove(y).numpy(), y.numpy(), atol=1e-12)
    # a sequence of [n] vectors gives the same basis as the [n, m] matrix
    ns3 = tns.make_nullspace(vecs=[torch.ones(50, dtype=torch.float64),
                                   torch.from_numpy(v)])
    np.testing.assert_allclose(ns3.vecs.numpy() @ ns3.vecs.numpy().T,
                               Q @ Q.T, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(constant=True), dict(n=10),
                                dict(n=10, vecs=torch.ones(5))],
                         ids=["no-n", "empty", "n-mismatch"])
def test_make_nullspace_validation(kw):
    with pytest.raises(ValueError):
        tns.make_nullspace(**kw)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError):
        jns.make_nullspace(**jkw)


@pytest.mark.parametrize("how", ["keyword", "options", "make_solver"])
def test_singular_laplacian_minimal_norm(how):
    """cg + jacobi on the consistent singular system: the zero-mean
    representative, as JAX's."""
    n = 200
    data, jb, tb = _bands(n)
    u = _zero_mean(np.random.default_rng(1), n)
    b = _mv(data, u)
    kw = dict(ksp_type="cg", pc_type="jacobi", rtol=1e-12, maxit=2000)
    if how == "options":
        opts = {"ksp_nullspace_constant": 1}
        rj = jpkg.solve(jb, jnp.asarray(b), options=jpkg.Options(opts), **kw)
        rt = tpkg.solve(tb, torch.from_numpy(b), options=tpkg.Options(opts),
                        **kw)
    else:
        nj = jns.make_nullspace(n, constant=True, dtype=jnp.float64)
        nt = tns.make_nullspace(n, constant=True, dtype=torch.float64,
                                device=CPU)
        if how == "keyword":
            rj = jpkg.solve(jb, jnp.asarray(b), nullspace=nj, **kw)
            rt = tpkg.solve(tb, torch.from_numpy(b), nullspace=nt, **kw)
        else:
            rj = jpkg.make_solver(jb, nullspace=nj, jit=False, **kw)(
                jnp.asarray(b))
            rt = tpkg.make_solver(tb, nullspace=nt, **kw)(torch.from_numpy(b))
    assert rt.its == int(rj.its) > 10 and rt.reason == int(rj.reason) > 0
    _history_close(rt, rj)
    x = rt.x.numpy()
    assert abs(x.mean()) < 1e-10
    np.testing.assert_allclose(x, np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(x, u, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("ksp", ["cg", "minres", "fgmres"])
def test_inconsistent_rhs_projected(ksp):
    """b shifted along the left null space: the same answer as the
    consistent b, as JAX's."""
    n = 128
    data, jb, tb = _bands(n)
    u = _zero_mean(np.random.default_rng(2), n)
    b = _mv(data, u)
    kw = dict(ksp_type=ksp, pc_type="jacobi", rtol=1e-12, maxit=2000,
              restart=200)
    nj = jns.make_nullspace(n, constant=True, dtype=jnp.float64)
    nt = tns.make_nullspace(n, constant=True, dtype=torch.float64,
                            device=CPU)
    solver = tpkg.make_solver(tb, nullspace=nt, **kw)
    xa = solver(torch.from_numpy(b)).x.numpy()
    rt = solver(torch.from_numpy(b + 3.7))
    rj = jpkg.make_solver(jb, nullspace=nj, jit=False, **kw)(
        jnp.asarray(b + 3.7))
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) > 0
    _history_close(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), xa, rtol=1e-9, atol=1e-9)


def test_nullspace_many_columns():
    """``make_solver_many`` projects all r columns (options-driven here,
    keyword for JAX), as JAX's."""
    n, r = 128, 4
    data, jb, tb = _bands(n)
    U = _zero_mean(np.random.default_rng(5), n, r)
    B = np.stack([_mv(data, U[:, j]) for j in range(r)], axis=1)
    kw = dict(ksp_type="cg", pc_type="jacobi", rtol=1e-12, maxit=2000)
    nj = jns.make_nullspace(n, constant=True, dtype=jnp.float64)
    rj = jpkg.make_solver_many(jb, nullspace=nj, jit=False, **kw)(
        jnp.asarray(B))
    rt = tpkg.solve_many(tb, torch.from_numpy(B + 0.25), options=tpkg.Options(
        {"ksp_nullspace_constant": 1}), **kw)
    rt2 = tpkg.make_solver_many(tb, nullspace=tns.make_nullspace(
        n, constant=True, dtype=torch.float64, device=CPU), **kw)(
            torch.from_numpy(B))
    np.testing.assert_array_equal(rt2.its.numpy(), np.asarray(rj.its))
    np.testing.assert_array_equal(rt2.reason.numpy(), np.asarray(rj.reason))
    X = rt2.x.numpy()
    assert np.abs(X.mean(axis=0)).max() < 1e-9
    np.testing.assert_allclose(X, np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(X, U, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rt.x.numpy(), X, atol=1e-8)


def test_nonsymmetric_distinct_left_nullspace():
    """A nonsymmetric singular dense matrix with distinct right and left
    null spaces: b is projected by the left one, x by the right one."""
    n = 80
    rng = np.random.default_rng(6)
    P, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([[0.0], rng.uniform(1.0, 2.0, n - 1)])
    A = (P * d) @ Q.T
    u = Q[:, 1:] @ rng.standard_normal(n - 1)
    b = A @ u
    bad = b + 0.9 * P[:, 0]
    kw = dict(ksp_type="gmres", pc_type="none", rtol=1e-12, maxit=500,
              restart=80)
    rj = jpkg.make_solver(
        jnp.asarray(A), nullspace=jns.make_nullspace(vecs=jnp.asarray(Q[:, 0])),
        transpose_nullspace=jns.make_nullspace(vecs=jnp.asarray(P[:, 0])),
        jit=False, **kw)(jnp.asarray(bad))
    rt = tpkg.make_solver(
        torch.from_numpy(A),
        nullspace=tns.make_nullspace(vecs=torch.from_numpy(Q[:, 0])),
        transpose_nullspace=tns.make_nullspace(vecs=torch.from_numpy(P[:, 0])),
        **kw)(torch.from_numpy(bad))
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) > 0
    _history_close(rt, rj)
    x = rt.x.numpy()
    assert abs(Q[:, 0] @ x) < 1e-8
    np.testing.assert_allclose(A @ x, b, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(x, np.asarray(rj.x), atol=1e-8)


def test_testbed_neumann_constant_nullspace(capsys):
    """The testbed's ``-ksp_nullspace_constant`` (the error compared up to
    the constant) with a random manufactured solution (A 1 = 0), line by
    line against JAX's."""
    rc, out = compare_testbeds(
        jtb.main, ttb.main,
        "-problem neumann:300 -ksp_type cg -pc_type jacobi -ksp_rtol 1e-10 "
        "-ksp_nullspace_constant 1 -random_exact_sol 1 -ksp_monitor".split(),
        capsys)
    assert rc == 0 and "CONVERGED_RTOL" in out


def _neumann_f32_case(n=256, seed=3):
    data = _neumann(n).astype(np.float32)
    z = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return data, z - z.mean()


def _drift_solve(package, K, seed=3, n=256):
    """f32 CG with the spike PC over K partitions and the options
    ``-pc_factor_shift_type nonzero -pc_factor_shift_amount 1e-2``, on
    ``A u + 0.5`` (inconsistent) with the constant null space.  Returns
    ``(x, its, reason, shifted_pivots, u)``."""
    data, u = _neumann_f32_case(n, seed)
    opts = {"pc_spike_partitions": K, "pc_factor_shift_type": "nonzero",
            "pc_factor_shift_amount": 1e-2}
    kw = dict(ksp_type="cg", pc_type="spike", rtol=1e-6, maxit=100)
    if package == "jax":
        jb = JBand(jnp.asarray(data), 1, 1)
        ns = jns.make_nullspace(n, constant=True, dtype=jnp.float32)
        b = np.asarray(jpkg.banded_matvec(jb, jnp.asarray(u)))
        pc = jpkg.make_pc("spike", jb, jpkg.Options(dict(opts)))
        res = jpkg.make_solver(jb, nullspace=ns, jit=False,
                               options=jpkg.Options(dict(opts)), **kw)(
            jnp.asarray(b + 0.5))
        x = np.asarray(res.x)
    else:
        tb = banded_from_numpy(data, 1, 1, device=CPU)
        ns = tns.make_nullspace(n, constant=True, dtype=torch.float32,
                                device=CPU)
        b = tpkg.ops.band.banded_matvec(tb, torch.from_numpy(u)).numpy()
        pc = tpkg.solvers.pc.make_pc("spike", tb, tpkg.Options(dict(opts)))
        res = tpkg.make_solver(tb, nullspace=ns,
                               options=tpkg.Options(dict(opts)), **kw)(
            torch.from_numpy(b + 0.5))
        x = res.x.numpy()
    assert x.dtype == np.float32
    return x, int(res.its), int(res.reason), pc.info["shifted_pivots"], u


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_f32_cg_nullspace_drift_with_shifted_spike(package):
    """f32 CG on the Neumann Laplacian (n = 256) with the spike PC on one
    partition, its factor shifted (``-pc_factor_shift_type nonzero
    -pc_factor_shift_amount 1e-2``, the option names both PCs read; JAX's
    ``tests/test_nullspace.py:105-121`` passes ``pc_spike_shift``, which no
    PC reads), an inconsistent right-hand side: the shift raises the
    singular last pivot (exactly one), and the projections keep the
    null-space component out of x (it drifted to a mean of ~1e8 before
    JAX commit 2459753), in both packages, within the JAX test's 1e-3 of
    u.  (Before the port's projection ran in double precision, its f32
    remnant, amplified by the shifted pivot, left x 1.0e-4 to 3.8e-3 from
    u over seeds 0-9, one of them at maxit; JAX 3.7e-5 to 5.0e-4.)"""
    x, its, reason, shifted, u = _drift_solve(package, K=1)
    assert shifted == 1
    assert reason > 0, reason
    assert abs(x.mean()) < 1e-6
    assert np.abs(x - u).max() < 1e-3


@pytest.fixture(scope="module")
def jax_drift_over_8():
    return {seed: _drift_solve("jax", K=8, seed=seed) for seed in range(8)}


@pytest.mark.parametrize("seed", range(8))
def test_f32_cg_nullspace_drift_over_8_partitions(jax_drift_over_8, seed):
    """The drift check of JAX's ``tests/test_nullspace.py:105-121`` at its
    geometry, 8 partitions of n = 256, in both packages on the same
    inputs.  No pivot is shifted there (see the next test): the reduced
    system is exactly singular (|S^-1| ~ 2.4e6 in f32 in both packages),
    and every PC output carries the null component of its input's rounding
    times that.  The port's f32 CG ran to maxit on seeds 2, 3, 4, 7 (mean
    x ~1.6e3 at seed 3) where JAX's took 2-4 its, until its projection ran
    in double precision.  Both converge, hold |mean x| < 1e-6 and land
    within 1e-3 of u; the iteration counts are equal at the JAX test's
    seed 3 and within one elsewhere (PC outputs differ by the rounding of
    that singular reduced solve, and the last iteration sits at rtol's
    edge)."""
    xj, itj, rj, sj, u = jax_drift_over_8[seed]
    xt, itt, rt, st, _ = _drift_solve("torch", K=8, seed=seed)
    assert st == sj == 0
    assert rt == rj > 0, (rt, rj)
    assert itt == itj if seed == 3 else abs(itt - itj) <= 1, (itt, itj)
    for x in (xj, xt):
        assert abs(x.mean()) < 1e-6
        assert np.abs(x - u).max() < 1e-3


def test_projection_rounds_once():
    """``NullSpace.remove`` of an f32 vector is the double-precision
    projection rounded once: on a vector of mean 0.5 (n = 4096) the sum it
    leaves is that of the final rounding (< 1e-4 over seeds 0-19, where an
    f32 inner product left up to 4.7e-3 in JAX and more in torch's CPU
    matmul)."""
    n = 4096
    ns = tns.make_nullspace(n, constant=True, dtype=torch.float32,
                            device=CPU)
    for seed in range(20):
        v = np.random.default_rng(seed).standard_normal(n).astype(
            np.float32) + np.float32(0.5)
        out = ns.remove(torch.from_numpy(v))
        assert out.dtype == torch.float32
        v64 = v.astype(np.float64)
        exact = (v64 - v64.mean()).astype(np.float32)
        np.testing.assert_array_equal(out.numpy(), exact)
        assert abs(out.numpy().astype(np.float64).sum()) < 1e-4


def test_shift_leaves_partitioned_neumann_unshifted():
    """Over 8 partitions every partition of the Neumann Laplacian is
    nonsingular (its smallest pivot is ~1) and the singular mode lives in
    the reduced system, which no factor shifts: neither package raises a
    pivot at ``-pc_factor_shift_amount 1e-2``."""
    data, _ = _neumann_f32_case()
    opts = {"pc_spike_partitions": 8, "pc_factor_shift_type": "nonzero",
            "pc_factor_shift_amount": 1e-2}
    pj = jpkg.make_pc("spike", JBand(jnp.asarray(data), 1, 1),
                      jpkg.Options(dict(opts)))
    pt = tpkg.solvers.pc.make_pc("spike",
                                 banded_from_numpy(data, 1, 1, device=CPU),
                                 tpkg.Options(dict(opts)))
    assert pt.info["shifted_pivots"] == pj.info["shifted_pivots"] == 0

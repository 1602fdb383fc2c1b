"""PyTorch port, the KSP surface built on the transpose stack, against the
JAX package: ``bicg``, ``cgne``/``cgnr``/``cgls`` and ``lsqr`` (through
``krylov`` and through ``ksp.solve``), ``transpose=True`` in ``solve`` and
``solve_many`` (with and without null spaces), ``-ksp_compute_singularvalues``
and ``-ksp_diagonal_scale``, and the refusals of bare callables.

Same numpy inputs on both sides, f64 on the CPU.  Iteration counts and
reasons equal; histories within rtol 1e-8; x within atol 1e-8; the
singular-value line's numbers within 1e-8 relative.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.ops.band import banded_transpose as j_tr
from spike_petsc_tpu.solvers import krylov as jkr
from spike_petsc_tpu.solvers import nullspace as jns
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.ops.band import banded_transpose as t_tr
from spike_petsc_tpu_torch.solvers import krylov as tkr
from spike_petsc_tpu_torch.solvers import nullspace as tns

from torch_parity import CPU, random_band

N, KL, KU = 600, 3, 4
SPIKE = {"pc_spike_partitions": 4, "pc_spike_block": 8}
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
A_T_TYPES = ("bicg", "cgne", "cgnr", "cgls", "lsqr")


@pytest.fixture(scope="module")
def system():
    data = random_band(N, KL, KU, seed=5)
    b = np.random.default_rng(2).standard_normal(N)
    return data, b


def _bands(data, kl=KL, ku=KU):
    return (JBand(jnp.asarray(data), kl, ku),
            banded_from_numpy(data, kl, ku, device=CPU))


def _same(rt, rj, x_atol=1e-8):
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    its = rt.its
    hj = np.asarray(rj.history)[:its + 1]
    np.testing.assert_allclose(rt.history.numpy()[:its + 1], hj, rtol=1e-8,
                               atol=1e-12 * np.nanmax(np.abs(hj)))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=x_atol)
    np.testing.assert_allclose(rt.rnorm, float(rj.rnorm), rtol=1e-6,
                               atol=1e-12)


def _solve_both(data, b, opts, kl=KL, ku=KU, **kw):
    jb, tb = _bands(data, kl, ku)
    rj = jpkg.solve(jb, jnp.asarray(b), options=jpkg.Options(dict(opts)),
                    **kw)
    rt = tpkg.solve(tb, torch.from_numpy(b),
                    options=tpkg.Options(dict(opts)), **kw)
    return rj, rt


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("pc", ["spike", "none"])
@pytest.mark.parametrize("ksp", A_T_TYPES)
def test_transpose_types_through_solve_match_jax(system, ksp, pc, transpose):
    """Each A^T type with the spike PC (its M^-T from spike_transpose) and
    with none, on A and, ``transpose=True``, on A^T (the involution gives
    the shadow recurrence the forward PC)."""
    data, b = system
    rj, rt = _solve_both(data, b, SPIKE if pc == "spike" else {},
                         ksp_type=ksp, pc_type=pc, rtol=1e-10, maxit=300,
                         transpose=transpose)
    assert rt.converged
    _same(rt, rj)


def _closures(data):
    """(JAX, torch) dicts of matvec, matvec_transpose and the jacobi PC
    (diagonal, its own transpose)."""
    jb, tb = _bands(data)
    jbt, tbt = j_tr(jb), t_tr(tb)
    d = data[:, KL]
    jd, td = jnp.asarray(1 / d), torch.from_numpy(1 / d)
    return (dict(matvec=lambda v: j_mv(jb, v),
                 matvec_transpose=lambda v: j_mv(jbt, v),
                 pc_apply=lambda v: jd * v,
                 pc_apply_transpose=lambda v: jd * v),
            dict(matvec=lambda v: t_mv(tb, v),
                 matvec_transpose=lambda v: t_mv(tbt, v),
                 pc_apply=lambda v: td * v,
                 pc_apply_transpose=lambda v: td * v))


@pytest.mark.parametrize("x0", [False, True], ids=["x0=0", "x0"])
@pytest.mark.parametrize("fn", ["bicg", "cgnr", "lsqr"])
def test_transpose_types_through_krylov_match_jax(system, fn, x0):
    """The functions of ``krylov`` called with the operator, its transpose
    and a PC pair, from x0 = 0 and from a nonzero x0."""
    data, b = system
    cj, ct = _closures(data)
    x = np.random.default_rng(8).standard_normal(N) if x0 else None
    kw = dict(rtol=1e-10, maxit=300)
    mj, mt = cj.pop("matvec"), ct.pop("matvec")
    rj = getattr(jkr, fn)(mj, jnp.asarray(b),
                          None if x is None else jnp.asarray(x),
                          cj.pop("pc_apply"), **cj, **kw)
    rt = getattr(tkr, fn)(mt, torch.from_numpy(b),
                          None if x is None else torch.from_numpy(x),
                          ct.pop("pc_apply"), **ct, **kw)
    _same(rt, rj)


@pytest.mark.parametrize("m", [5, 40])
def test_golub_kahan_matches_jax(system, m):
    """The bidiagonal of m Golub-Kahan steps and the extreme singular
    values estimated from it."""
    data, b = system
    cj, ct = _closures(data)
    aj, bj, kj = jkr.golub_kahan_bidiag(
        cj["matvec"], cj["matvec_transpose"], jnp.asarray(b), m,
        cj["pc_apply"], cj["pc_apply_transpose"])
    at, bt, kt = tkr.golub_kahan_bidiag(
        ct["matvec"], ct["matvec_transpose"], torch.from_numpy(b), m,
        ct["pc_apply"], ct["pc_apply_transpose"])
    assert kt == int(kj) == m
    np.testing.assert_allclose(at, np.asarray(aj), rtol=1e-10)
    np.testing.assert_allclose(bt, np.asarray(bj), rtol=1e-10, atol=1e-14)
    sj = jkr.estimate_extreme_singular_values(
        cj["matvec"], cj["matvec_transpose"], N, jnp.float64, m=m,
        pc_apply=cj["pc_apply"], pc_apply_transpose=cj["pc_apply_transpose"])
    st = tkr.estimate_extreme_singular_values(
        ct["matvec"], ct["matvec_transpose"], N, torch.float64, m=m,
        pc_apply=ct["pc_apply"], pc_apply_transpose=ct["pc_apply_transpose"],
        device=CPU)
    np.testing.assert_allclose(st, sj, rtol=1e-8)


def test_golub_kahan_breakdown_matches_jax():
    """M^-1 A = I: the first step breaks down and appends no column (one
    singular value, 1), in both packages."""
    eye = np.ones((50, 1))
    jb, tb = _bands(eye, 0, 0)
    v0 = np.random.default_rng(9).standard_normal(50)
    sj = jkr.estimate_extreme_singular_values(
        lambda v: j_mv(jb, v), lambda v: j_mv(jb, v), 50, jnp.float64, m=10,
        v0=jnp.asarray(v0))
    st = tkr.estimate_extreme_singular_values(
        lambda v: t_mv(tb, v), lambda v: t_mv(tb, v), 50, torch.float64,
        m=10, v0=torch.from_numpy(v0))
    np.testing.assert_allclose(st, sj, rtol=1e-12)
    np.testing.assert_allclose(st, (1.0, 1.0), rtol=1e-12)


@pytest.mark.parametrize("ksp,pc,transpose", [
    ("gmres", "spike", False), ("gmres", "none", False),
    ("gmres", "spike", True), ("bicg", "jacobi", False)])
def test_compute_singularvalues_line_matches_jax(capsys, system, ksp, pc,
                                                 transpose):
    data, b = system
    opts = dict(SPIKE if pc == "spike" else {},
                ksp_compute_singularvalues=1)
    jb, tb = _bands(data)
    rj = jpkg.solve(jb, jnp.asarray(b), options=jpkg.Options(dict(opts)),
                    ksp_type=ksp, pc_type=pc, rtol=1e-10, maxit=300,
                    transpose=transpose)
    out_j = capsys.readouterr().out.strip().splitlines()[-1]
    rt = tpkg.solve(tb, torch.from_numpy(b),
                    options=tpkg.Options(dict(opts)), ksp_type=ksp,
                    pc_type=pc, rtol=1e-10, maxit=300, transpose=transpose)
    out_t = capsys.readouterr().out.strip().splitlines()[-1]
    assert out_t.startswith("Iteratively computed extreme singular values:")
    assert NUMBER.sub("#", out_t) == NUMBER.sub("#", out_j)
    np.testing.assert_allclose([float(v) for v in NUMBER.findall(out_t)],
                               [float(v) for v in NUMBER.findall(out_j)],
                               rtol=1e-8)
    _same(rt, rj)


def _scaled_band(n=200, seed=11):
    """A band whose rows and columns span 8 orders of magnitude (the JAX
    test of -ksp_diagonal_scale)."""
    data = random_band(n, 2, 2, seed=seed)
    s = 10.0 ** np.linspace(-4, 4, n)
    for d in range(5):
        cols = np.clip(np.arange(n) + d - 2, 0, n - 1)
        data[:, d] *= s * s[cols]
    x = np.random.default_rng(3).standard_normal(n)
    A = np.zeros((n, n))
    for d in range(5):
        rows = np.arange(max(0, 2 - d), min(n, n + 2 - d))
        A[rows, rows + d - 2] = data[rows, d]
    return data, A @ x, x


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("ksp,pc", [("gmres", "none"), ("bicg", "jacobi"),
                                    ("gmres", "lu")])
def test_ksp_diagonal_scale_matches_jax(ksp, pc, fix):
    """The symmetrically scaled system's history and the UNSCALED x, with
    and without -ksp_diagonal_scale_fix (a no-op: nothing is mutated)."""
    data, b, x = _scaled_band()
    opts = {"ksp_diagonal_scale": 1}
    if fix:
        opts["ksp_diagonal_scale_fix"] = 1
    rj, rt = _solve_both(data, b, opts, kl=2, ku=2, ksp_type=ksp,
                         pc_type=pc, rtol=1e-12, maxit=400)
    assert rt.converged
    _same(rt, rj, x_atol=1e-8 * np.abs(x).max())
    np.testing.assert_allclose(rt.x.numpy(), x, rtol=1e-6, atol=1e-6)


def test_ksp_diagonal_scale_refusals(system):
    """A ready-made PC or an operator that is not banded: ValueError, with
    JAX's messages."""
    data, b = system
    jb, tb = _bands(data)
    opts = {"ksp_diagonal_scale": 1}
    for jkw, tkw in ((dict(pc=jpkg.solvers.pc.make_pc("none", jb)),
                      dict(pc=tpkg.solvers.pc.make_pc("none", tb))),
                     (dict(pmat=None), dict(pmat=None))):
        ja = jb if "pc" in jkw else jnp.asarray(np.eye(N))
        ta = tb if "pc" in tkw else torch.eye(N, dtype=torch.float64)
        with pytest.raises(ValueError) as ej:
            jpkg.solve(ja, jnp.asarray(b), options=jpkg.Options(dict(opts)),
                       **jkw)
        with pytest.raises(ValueError) as et:
            tpkg.solve(ta, torch.from_numpy(b),
                       options=tpkg.Options(dict(opts)), **tkw)
        assert str(et.value) == str(ej.value)


def _neumann(n):
    data = np.tile([-1.0, 2.0, -1.0], (n, 1))
    data[0, 1] = data[-1, 1] = 1.0
    return data


@pytest.mark.parametrize("ksp", ["minres", "bicg", "cg"])
def test_transpose_solve_with_constant_nullspace_matches_jax(ksp):
    """The singular Neumann Laplacian with -ksp_nullspace_constant under
    ``transpose=True`` (the null spaces swap; here they are one)."""
    n = 300
    data = _neumann(n)
    u = np.random.default_rng(4).standard_normal(n)
    u -= u.mean()
    b = np.convolve(u, [-1, 2, -1], "same")
    b[0], b[-1] = u[0] - u[1], u[-1] - u[-2]
    rj, rt = _solve_both(data, b, {"ksp_nullspace_constant": 1}, kl=1, ku=1,
                         ksp_type=ksp, pc_type="jacobi", rtol=1e-10,
                         maxit=2000, transpose=True)
    assert rt.converged
    _same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), u, atol=1e-7)


def test_transpose_solve_distinct_nullspaces_matches_jax():
    """A nonsymmetric singular matrix with distinct right and left null
    spaces, solved transposed: ``nullspace`` and ``transpose_nullspace``
    swap, so b is projected by A's null space and x by A^T's."""
    n = 80
    rng = np.random.default_rng(6)
    P, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([[0.0], rng.uniform(1.0, 2.0, n - 1)])
    A = (P * d) @ Q.T
    u = P[:, 1:] @ rng.standard_normal(n - 1)      # in range(A^T)^perp-free
    b = A.T @ u + 0.9 * Q[:, 0]                    # an inconsistent part
    kw = dict(ksp_type="gmres", pc_type="none", rtol=1e-12, maxit=500,
              restart=80, transpose=True)
    rj = jpkg.make_solver(
        jnp.asarray(A), nullspace=jns.make_nullspace(vecs=jnp.asarray(Q[:, 0])),
        transpose_nullspace=jns.make_nullspace(vecs=jnp.asarray(P[:, 0])),
        jit=False, **kw)(jnp.asarray(b))
    rt = tpkg.make_solver(
        torch.from_numpy(A),
        nullspace=tns.make_nullspace(vecs=torch.from_numpy(Q[:, 0])),
        transpose_nullspace=tns.make_nullspace(vecs=torch.from_numpy(P[:, 0])),
        **kw)(torch.from_numpy(b))
    assert rt.converged
    _same(rt, rj)
    x = rt.x.numpy()
    assert abs(P[:, 0] @ x) < 1e-8
    np.testing.assert_allclose(A.T @ x, A.T @ u, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("ksp,pc,opts", [
    ("bcgs", "spike", SPIKE), ("gmres", "lu", {}),
    ("cg", "jacobi", {"ksp_nullspace_constant": 1})],
    ids=["bcgs-spike", "gmres-lu", "cg-nullspace"])
def test_solve_many_transpose_matches_jax(system, ksp, pc, opts):
    """``solve_many(..., transpose=True)``: the transposed PC has no
    multi-RHS apply, so its columns take ``apply`` one by one; per-column
    counts, reasons and x as JAX's."""
    data, _ = system
    kl, ku = KL, KU
    X = np.random.default_rng(12).standard_normal((N, 3))
    if opts.get("ksp_nullspace_constant"):
        data, kl, ku = _neumann(N), 1, 1
        X -= X.mean(axis=0)
    jb, tb = _bands(data, kl, ku)
    B = np.array(j_mv(j_tr(jb), jnp.asarray(X)))
    kw = dict(ksp_type=ksp, pc_type=pc, rtol=1e-10, maxit=2000,
              transpose=True)
    rj = jpkg.solve_many(jb, jnp.asarray(B), options=jpkg.Options(dict(opts)),
                         **kw)
    rt = tpkg.solve_many(tb, torch.from_numpy(B),
                         options=tpkg.Options(dict(opts)), **kw)
    assert rt.its.tolist() == np.asarray(rj.its).tolist()
    assert rt.reason.tolist() == np.asarray(rj.reason).tolist()
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), X, atol=1e-6)


@pytest.mark.parametrize("ksp", A_T_TYPES)
def test_bare_callables_refused_as_in_jax(ksp):
    """A bare matvec callable cannot be transposed: the A^T types through
    ``solve`` raise TypeError with JAX's message, and the functions of
    ``krylov`` without ``matvec_transpose`` raise ValueError with JAX's."""
    b = np.ones(16)
    with pytest.raises(TypeError) as ej:
        jpkg.solve(lambda x: 2.0 * x, jnp.asarray(b), ksp_type=ksp)
    with pytest.raises(TypeError) as et:
        tpkg.solve(lambda x: 2.0 * x, torch.from_numpy(b), ksp_type=ksp)
    assert str(et.value) == str(ej.value)
    fn = {"cgne": "cgnr", "cgls": "cgnr"}.get(ksp, ksp)
    with pytest.raises(ValueError) as ej:
        getattr(jkr, fn)(lambda x: x, jnp.asarray(b))
    with pytest.raises(ValueError) as et:
        getattr(tkr, fn)(lambda x: x, torch.from_numpy(b))
    assert str(et.value) == str(ej.value)


def test_transpose_of_a_callable_refused_as_in_jax():
    b = np.ones(16)
    with pytest.raises(TypeError) as ej:
        jpkg.solve(lambda x: 2.0 * x, jnp.asarray(b), ksp_type="gmres",
                   transpose=True)
    with pytest.raises(TypeError) as et:
        tpkg.solve(lambda x: 2.0 * x, torch.from_numpy(b), ksp_type="gmres",
                   transpose=True)
    assert str(et.value) == str(ej.value)

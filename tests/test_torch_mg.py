"""PyTorch port, the geometric multigrid PC (``-pc_type mg``: a V-cycle on
a Galerkin banded hierarchy) against the JAX package's, on the CPU in f64,
the cases of tests/test_mg.py, and BASELINE config 1's recipe with mg
through both testbeds.

On the CPU the coarse factor's block is the tip size, as in JAX; on the
card it is the kernels' block (``default_block``), tested in
tests/test_torch_cuda.py.  The SOR-smoother case runs at n = 1024 (JAX's
test: 4096): with a tridiagonal band SOR's block is 1, and the plain sweep
loops over every row on the CPU.

Tolerances: one apply within 1e-12 of max|JAX|; iteration counts and
``info`` exactly (bicg's count within 5: see its test); solutions to the JAX test's tolerance; the adjoint
identity to 1e-12 relative, as the JAX test (1e-10 with the SOR
smoother, whose inner product cancels more).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spike_petsc_tpu import BandedMatrix as JBand
from spike_petsc_tpu import Options as JOptions
from spike_petsc_tpu import solve as j_solve
from spike_petsc_tpu import sparse as jsp
from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
from spike_petsc_tpu_torch import BandedMatrix, Options, solve
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch.solvers.pc import make_pc

from torch_parity import compare_testbeds


def bands(a):
    data, kl, ku = jsp.csr_to_banded_arrays(a)
    return (JBand(data=jnp.asarray(data), kl=kl, ku=ku),
            BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _solves(a, **kw):
    """(JAX's result, the port's) of one solve of A x = A 1."""
    jb, tb = bands(a)
    b = a @ np.ones(a.shape[0])
    opts = kw.pop("options", {})
    jr = j_solve(jb, jnp.asarray(b), options=JOptions(dict(opts)), **kw)
    r = solve(tb, torch.as_tensor(b), options=Options(dict(opts)), **kw)
    assert r.reason > 0 and r.its == int(jr.its)
    return r


def test_mg_mesh_independent_iterations():
    its = {}
    for n in (511, 2048, 8192):
        r = _solves(problems.tridiag_laplacian(n), ksp_type="cg",
                    pc_type="mg", rtol=1e-10, maxit=100)
        np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-7, atol=1e-8)
        its[n] = r.its
    assert max(its.values()) <= min(its.values()) + 2, its
    assert max(its.values()) <= 15, its


def test_mg_sor_smoother_and_options():
    r = _solves(problems.tridiag_laplacian(1024), options={
        "ksp_type": "cg", "pc_type": "mg", "pc_mg_smoother": "sor",
        "pc_mg_smooth_down": "2", "pc_mg_smooth_up": "2",
        "ksp_rtol": "1e-10", "ksp_max_it": "60"})
    assert r.its <= 8
    np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-7, atol=1e-8)
    _, tb = bands(problems.tridiag_laplacian(4096))
    assert make_pc("mg", tb, Options({"pc_mg_levels": "3"})).info[
        "levels"] == 3
    with pytest.raises(ValueError, match="pc_mg_smoother"):
        make_pc("mg", tb, Options({"pc_mg_smoother": "ilu"}))


def test_mg_nonsymmetric_with_gmres():
    n = 4096
    a = sp.diags([-1.05 * np.ones(n - 1), 2.0 * np.ones(n),
                  -0.95 * np.ones(n - 1)], [-1, 0, 1], format="csr")
    r = _solves(a, ksp_type="gmres", pc_type="mg", rtol=1e-10, maxit=100)
    assert r.its <= 30
    np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opts", [
    {}, {"pc_mg_smoother": "sor", "mg_smoother_pc_sor_omega": "1.2"},
    {"pc_mg_smooth_down": "2", "pc_mg_smooth_up": "0",
     "pc_mg_jacobi_omega": "0.5", "pc_mg_coarse_size": "16"},
    {"pc_mg_levels": "2"}])
def test_mg_apply_and_info_match_jax(opts):
    """One V-cycle and its transpose against JAX's, on a nonsymmetric band
    of bandwidth 2 (the coarse bands widen), and ``info``."""
    jb, tb = bands(problems.nonsym_banded(600, 2, 2, seed=7))
    jp = j_make_pc("mg", jb, JOptions(dict(opts)))
    tp = make_pc("mg", tb, Options(dict(opts)))
    assert tp.info == jp.info
    r = np.random.default_rng(1).standard_normal(600)
    assert _rel(tp.apply(torch.as_tensor(r)),
                jp.apply(jnp.asarray(r))) <= 1e-12
    assert _rel(tp.transpose().apply(torch.as_tensor(r)),
                jp.transpose().apply(jnp.asarray(r))) <= 1e-12


@pytest.mark.parametrize("smoother,rtol", [("jacobi", 1e-12),
                                           ("sor", 1e-10)])
def test_mg_transpose_exact_adjoint(smoother, rtol):
    """<M^-1 x, y> = <x, M^-T y>: to 1e-12 with Jacobi (JAX's test); with
    SOR the sum cancels ~1.7e5 times its largest term, so to 1e-10."""
    _, tb = bands(problems.nonsym_banded(1024, 2, 2, seed=7))
    pc = make_pc("mg", tb, Options({"pc_mg_smoother": smoother,
                                    "pc_mg_smooth_up": "2"}))
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(1024))
    y = torch.as_tensor(rng.standard_normal(1024))
    np.testing.assert_allclose(float(torch.dot(pc.apply(x), y)),
                               float(torch.dot(x, pc.transpose().apply(y))),
                               rtol=rtol)


@pytest.mark.parametrize("smoother", ["jacobi", "sor"])
def test_mg_apply_many_matches_columns(smoother):
    """The cycle on [n, r] blocks against ``apply`` column by column,
    forward and transposed."""
    _, tb = bands(problems.tridiag_laplacian(512))
    pc = make_pc("mg", tb, Options({"pc_mg_smoother": smoother}))
    R = torch.as_tensor(np.random.default_rng(3).standard_normal((512, 3)))
    for p in (pc, pc.transpose()):
        Z1 = p.apply_many(R).numpy()
        Z2 = torch.stack([p.apply(R[:, j]) for j in range(3)], 1).numpy()
        np.testing.assert_allclose(Z1, Z2, rtol=1e-13, atol=1e-13)


def test_mg_bicg_uses_transpose():
    """bicg's shadow recurrence applies the transposed cycle.  The two
    packages' applies agree to 1e-16 here, but this bicg run amplifies
    rounding: the residual histories part by 3e-9 at iteration 8 and by
    20% at 24, and JAX's 94 iterations come out as 97.  So the count is
    held to 5 of JAX's, not exactly; the answer to the JAX test's bound."""
    a = problems.nonsym_banded(1024, 2, 2, seed=9)
    jb, tb = bands(a)
    b = a @ np.ones(1024)
    kw = dict(ksp_type="bicg", pc_type="mg", rtol=1e-9, maxit=200)
    jr = j_solve(jb, jnp.asarray(b), **kw)
    r = solve(tb, torch.as_tensor(b), **kw)
    assert r.reason > 0 and abs(r.its - int(jr.its)) <= 5
    np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-5, atol=1e-6)


def test_mg_config1_recipe_through_the_testbed(capsys):
    """BASELINE config 1's tridiagonal Laplacian with cg + mg (n = 8192):
    the testbed's lines, iterations and history as JAX's."""
    rc, out = compare_testbeds(
        jtb.main, ttb.main, "-problem tridiag:8192 -ksp_type cg -pc_type mg "
        "-ksp_rtol 1e-10 -ksp_monitor".split(), capsys)
    assert rc == 0

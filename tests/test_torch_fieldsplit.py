"""PyTorch port, the composite and fieldsplit PCs against the JAX
package's, on the CPU in f64, the cases of tests/test_fieldsplit.py, and
the reference's testbed2 Schur fieldsplit recipe through both testbeds.

The PCs slice a host (SciPy) matrix; the port places every sub-block on
the parent's device in its dtype, so these CPU runs stay on the CPU.

Tolerances: one apply within 1e-12 of max|JAX|; iteration counts and
``info`` exactly; solutions to the JAX test's tolerance; the adjoint
identity to 1e-10 (absolute, as the JAX test); the testbed lines as
``tests/torch_parity.py`` ``compare_testbeds`` compares them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu import Options as JOptions
from spike_petsc_tpu import make_pc as j_make_pc
from spike_petsc_tpu import solve as j_solve
from spike_petsc_tpu import testbed2 as jtb2
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.fieldsplit import (
    pc_fieldsplit_is as j_fieldsplit_is)
from spike_petsc_tpu_torch import Options, solve, testbed2 as ttb2
from spike_petsc_tpu_torch.solvers.fieldsplit import (_fieldsplit_isets,
                                                      pc_fieldsplit_is)
from spike_petsc_tpu_torch.solvers.pc import make_pc

from torch_parity import CPU, compare_testbeds


def _problem(n=240, seed=2):
    a = problems.spd_banded(n, 3, seed=seed)
    u = np.random.default_rng(0).uniform(size=n)
    return a, u, a @ u


def _pcs(name, a, opts):
    """(JAX's PC, the port's on the CPU in f64) from the same host CSR."""
    return (j_make_pc(name, a, JOptions(dict(opts))),
            make_pc(name, a, Options(dict(opts)), device=CPU,
                    dtype=torch.float64))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _check_applies(jp, tp, n, seed=1):
    r = np.random.default_rng(seed).standard_normal(n)
    assert tp.info == jp.info
    assert _rel(tp.apply(torch.as_tensor(r)),
                jp.apply(jnp.asarray(r))) <= 1e-12
    assert _rel(tp.transpose().apply(torch.as_tensor(r)),
                jp.transpose().apply(jnp.asarray(r))) <= 1e-12


def _solves(jp, tp, a, b, **kw):
    jr = j_solve(a, jnp.asarray(b), pc=jp, **kw)
    r = solve(a, torch.as_tensor(b), pc=tp, **kw)
    assert r.reason > 0 and r.its == int(jr.its)
    return r


@pytest.mark.parametrize("ctype", ["additive", "multiplicative"])
def test_composite_pc_matches_jax(ctype):
    a, u, b = _problem()
    opts = {"pc_composite_pcs": "jacobi,bjacobi",
            "pc_composite_type": ctype, "sub_1_pc_bjacobi_blocks": "4"}
    jp, tp = _pcs("composite", a, opts)
    _check_applies(jp, tp, 240)
    assert tp.inner.name == "jacobi"
    r = _solves(jp, tp, a, b, ksp_type="gmres", rtol=1e-10, maxit=500)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ftype", ["additive", "multiplicative", "schur"])
def test_fieldsplit_types_match_jax(ftype):
    a, u, b = _problem(n=300, seed=5)
    opts = {"pc_fieldsplit_type": ftype, "fieldsplit_0_pc_type": "lu",
            "fieldsplit_1_pc_type": "lu"}
    jp, tp = _pcs("fieldsplit", a, opts)
    assert tp.info["type"] == ftype
    _check_applies(jp, tp, 300)
    r = _solves(jp, tp, a, b, ksp_type="fgmres", rtol=1e-10, maxit=300)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sprec", ["selfp", "a11"])
def test_fieldsplit_schur_fast_convergence(sprec):
    a, u, b = _problem(n=400, seed=7)
    opts = {"pc_fieldsplit_type": "schur",
            "pc_fieldsplit_schur_precondition": sprec}
    jp, tp = _pcs("fieldsplit", a, opts)
    _check_applies(jp, tp, 400)
    r = _solves(jp, tp, a, b, ksp_type="fgmres", rtol=1e-10, maxit=100)
    assert r.its <= 25


@pytest.mark.parametrize("ftype,sizes", [("multiplicative", "100,80,120"),
                                         ("additive", "60,60,60,120")])
def test_fieldsplit_multifield_sizes(ftype, sizes):
    a, u, b = _problem(n=300)
    opts = {"pc_fieldsplit_sizes": sizes, "pc_fieldsplit_type": ftype}
    jp, tp = _pcs("fieldsplit", a, opts)
    assert tp.info["sizes"] == [int(s) for s in sizes.split(",")]
    _check_applies(jp, tp, 300)
    r = _solves(jp, tp, a, b, ksp_type="gmres", rtol=1e-10, maxit=500)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


def test_fieldsplit_strided_components():
    a, u, b = _problem(n=240)
    opts = {"pc_fieldsplit_block_size": "2", "pc_fieldsplit_0_fields": "0",
            "pc_fieldsplit_1_fields": "1",
            "pc_fieldsplit_type": "multiplicative"}
    jp, tp = _pcs("fieldsplit", a, opts)
    assert tp.info["sizes"] == [120, 120]
    _check_applies(jp, tp, 240)
    r = _solves(jp, tp, a, b, ksp_type="gmres", rtol=1e-10, maxit=300)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("argv,n", [
    ({"pc_fieldsplit_block_size": "3", "pc_fieldsplit_0_fields": "0,2",
      "pc_fieldsplit_1_fields": "1"}, 9),
    ({"pc_fieldsplit_block_size": "3"}, 9),
    ({"pc_fieldsplit_n0": "4"}, 10), ({}, 11)])
def test_fieldsplit_isets_match_jax(argv, n):
    from spike_petsc_tpu.solvers.fieldsplit import (
        _fieldsplit_isets as j_isets)
    got = _fieldsplit_isets(Options(dict(argv)), n)
    ref = j_isets(JOptions(dict(argv)), n)
    assert [ix.tolist() for ix in got] == [ix.tolist() for ix in ref]


def test_fieldsplit_arbitrary_is():
    a, u, b = _problem(n=200)
    perm = np.random.default_rng(5).permutation(200)
    isets = [np.sort(perm[:90]), np.sort(perm[90:])]
    jp = j_fieldsplit_is(a, isets, JOptions({"pc_fieldsplit_type": "schur"}))
    tp = pc_fieldsplit_is(a, isets, Options({"pc_fieldsplit_type": "schur"}),
                          device=CPU)
    _check_applies(jp, tp, 200)
    r = _solves(jp, tp, a, b, ksp_type="gmres", rtol=1e-10, maxit=200)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


def test_fieldsplit_bad_sets_rejected():
    a, _, _ = _problem(n=100)
    with pytest.raises(ValueError, match="partition"):
        pc_fieldsplit_is(a, [np.arange(50), np.arange(40, 100)], Options({}),
                         device=CPU)
    with pytest.raises(ValueError, match="2 fields"):
        pc_fieldsplit_is(a, [np.arange(30), np.arange(30, 60),
                             np.arange(60, 100)],
                         Options({"pc_fieldsplit_type": "schur"}),
                         device=CPU)
    with pytest.raises(ValueError, match=">= 2 fields"):
        pc_fieldsplit_is(a, [np.arange(100)], Options({}), device=CPU)
    with pytest.raises(ValueError, match="contiguously"):
        _fieldsplit_isets(Options({"pc_fieldsplit_block_size": "3",
                                   "pc_fieldsplit_0_fields": "0",
                                   "pc_fieldsplit_2_fields": "1,2"}), 9)


def test_composite_and_fieldsplit_transposes_adjoint_identity():
    """<y, M^-1 x> == <M^-T y, x> for every type (composite reverses its
    multiplicative stages on A^T; Schur swaps A01 and A10 transposed;
    block Gauss-Seidel becomes the upper sweep); bicg through the Schur
    transpose converges in JAX's count."""
    rng = np.random.default_rng(0)
    n = 200
    a = problems.nonsym_banded(n, 4, 3, seed=9).tocsr()
    x = torch.as_tensor(rng.standard_normal(n))
    y = torch.as_tensor(rng.standard_normal(n))

    def adjoint_gap(pc):
        return abs(float(torch.dot(y, pc.apply(x)))
                   - float(torch.dot(pc.transpose().apply(y), x)))

    for ct in ("additive", "multiplicative"):
        pc = make_pc("composite", a, Options(
            {"pc_composite_pcs": "jacobi,spike", "pc_composite_type": ct,
             "sub_1_pc_spike_partitions": 4}), device=CPU)
        assert adjoint_gap(pc) < 1e-10, ct
    perm = rng.permutation(n)
    isets = [np.sort(perm[:90]), np.sort(perm[90:])]
    for ft in ("schur", "additive", "multiplicative"):
        pc = pc_fieldsplit_is(a, isets, Options({"pc_fieldsplit_type": ft}),
                              device=CPU)
        assert adjoint_gap(pc) < 1e-10, ft
    u = rng.standard_normal(n)
    jp = j_fieldsplit_is(a, isets, JOptions({"pc_fieldsplit_type": "schur"}))
    tp = pc_fieldsplit_is(a, isets, Options({"pc_fieldsplit_type": "schur"}),
                          device=CPU)
    r = _solves(jp, tp, a, a @ u, ksp_type="bicg", rtol=1e-10, maxit=200)
    np.testing.assert_allclose(r.x.numpy(), u, rtol=1e-5, atol=1e-6)


def test_fieldsplit_sub_blocks_keep_the_parent_dtype():
    """An f32 placement factors every field's PC in f32 on the parent's
    device (the sub-blocks are placed as the parent was)."""
    a, _, _ = _problem(n=240)
    pc = make_pc("fieldsplit", a, Options({"pc_fieldsplit_type": "schur"}),
                 device=CPU, dtype=torch.float32)
    z = pc.apply(torch.ones(240, dtype=torch.float32))
    assert z.dtype == torch.float32 and z.device == CPU
    sf = pc.inner.apply.args[0]                 # the lu PC's SpikeFactor
    assert sf.fact.F.dtype == torch.float32


@pytest.mark.parametrize("pc_type", ["fieldsplit", "composite"])
def test_fieldsplit_solve_many_matches_columns(pc_type):
    """No multi-RHS apply (as in JAX): ``solve_many`` applies the PC
    column by column, each column's answer ``solve``'s."""
    from spike_petsc_tpu_torch import solve_many
    a, _, _ = _problem(n=240)
    pc = make_pc(pc_type, a, Options(), device=CPU, dtype=torch.float64)
    assert pc.apply_many is None
    B = torch.as_tensor(np.random.default_rng(9).standard_normal((240, 3)))
    res = solve_many(a, B, ksp_type="gmres", pc=pc, rtol=1e-10, maxit=300)
    for j in range(3):
        rj = solve(a, B[:, j], ksp_type="gmres", pc=pc, rtol=1e-10,
                   maxit=300)
        assert int(res.its[j]) == rj.its
        assert np.linalg.norm(res.x[:, j].numpy() - rj.x.numpy()) < 1e-10


@pytest.mark.parametrize("argv", [
    # the reference's recipe (reference/src/testbed2.c:4): Schur fieldsplit,
    # lu on each field
    "-problem spd:2000:4 -ksp_type fgmres -pc_type fieldsplit "
    "-pc_fieldsplit_type schur -fieldsplit_0_pc_type lu "
    "-fieldsplit_1_pc_type lu -ksp_rtol 1e-10",
    "-problem spd:1000:3 -ksp_type gmres -pc_type composite "
    "-pc_composite_pcs jacobi,bjacobi -pc_composite_type multiplicative "
    "-ksp_rtol 1e-10"])
def test_testbed2_recipe_matches_jax(argv, capsys):
    rc, out = compare_testbeds(jtb2.main, ttb2.main, argv.split(), capsys)
    assert rc == 0 and "Matrix is symmetric" in out

"""PyTorch port, batched multi-RHS Krylov engines (``krylov_many``), the
single-RHS ``bcgs`` and the ``solve_many`` composition, against the JAX
package on the same band and right-hand sides.

Tolerances (f64): equal per-column iteration counts and reasons; residual
histories at rtol 1e-8 with an absolute floor of 1e-12 of each column's
initial residual (the last GMRES residuals sit near roundoff); solutions at
atol 1e-8.  The f32 composition forced
onto the ``blocktri_many`` route: equal iteration counts and reasons,
solutions at 1e-5 relative (f32 rounding in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.solvers import krylov_many as jkm
from spike_petsc_tpu.solvers import ksp as jksp
from spike_petsc_tpu.solvers import operator as jop
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.solvers import krylov_many as tkm
from spike_petsc_tpu_torch.solvers import operator as top

from torch_parity import CPU, random_band

N, HW = 400, 3


def _sym_band(n, k, seed):
    """A symmetric, diagonally dominant band (SPD) in offset storage."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for d in range(1, k + 1):
        v = rng.uniform(-1.0, 1.0, n - d)
        a[np.arange(n - d), np.arange(d, n)] = v
        a[np.arange(d, n), np.arange(n - d)] = v
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 0.5
    data = np.zeros((n, 2 * k + 1))
    for d in range(-k, k + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        data[rows, d + k] = a[rows, rows + d]
    return data


def _operators(data, k):
    """(JAX matvec_many, port matvec_many, JAX Jacobi PC, port Jacobi PC)."""
    jb = JBand(jnp.asarray(data), k, k)
    tb = banded_from_numpy(data, k, k, device=CPU)
    dj = jnp.asarray(data[:, k])[:, None]
    dt = torch.from_numpy(data[:, k].copy())[:, None]
    return (lambda X: j_mv(jb, X), lambda X: t_mv(tb, X),
            lambda X: X / dj, lambda X: X / dt)


def _rhs(data, k, cols, seed):
    """B = A X with X random, its first column replaced by e_0 when
    ``easy`` (a column that converges in fewer iterations)."""
    X = np.random.default_rng(seed).standard_normal((data.shape[0], cols))
    X[:, 0] = 0.0
    X[0, 0] = 1.0
    return np.array(j_mv(JBand(jnp.asarray(data), k, k), jnp.asarray(X)))


def _assert_same(rj, rt, rtol=1e-8, atol=1e-8):
    its = np.asarray(rj.its)
    np.testing.assert_array_equal(rt.its.numpy(), its)
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    assert ht.shape == hj.shape
    for c in range(its.shape[0]):
        np.testing.assert_allclose(ht[:its[c] + 1, c], hj[:its[c] + 1, c],
                                   rtol=rtol, atol=1e-12 * hj[0, c],
                                   err_msg=f"column {c}")
        assert np.isnan(ht[its[c] + 1:, c]).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=atol)
    np.testing.assert_allclose(rt.rnorm.numpy(), np.asarray(rj.rnorm),
                               rtol=1e-6, atol=1e-12)


ENGINES = [  # name, symmetric operator, PC, keyword arguments
    ("bicgstab_many", False, "jacobi", dict(rtol=1e-10, maxit=100)),
    ("gmres_many", False, "jacobi", dict(rtol=1e-10, maxit=100, restart=4)),
    ("cg_many", True, "jacobi", dict(rtol=1e-10, maxit=100)),
    ("richardson_many", False, "jacobi", dict(rtol=1e-8, maxit=200)),
    ("preonly_many", False, "jacobi", dict()),
]


@pytest.mark.parametrize("name,sym,pc,kw", ENGINES)
def test_engine_matches_jax(name, sym, pc, kw):
    """Each engine on an easy/hard column pair plus two random columns:
    the easy column (B = A e_0) freezes while the others iterate."""
    data = _sym_band(N, HW, 31) if sym else random_band(N, HW, HW, seed=31)
    mvj, mvt, pcj, pct = _operators(data, HW)
    B = _rhs(data, HW, 4, seed=32)
    rj = getattr(jkm, name)(mvj, jnp.asarray(B), pc_apply=pcj, **kw)
    rt = getattr(tkm, name)(mvt, torch.from_numpy(B), pc_apply=pct, **kw)
    _assert_same(rj, rt)
    if name != "preonly_many":
        assert rt.its[0] != rt.its.max()          # genuinely different costs
        assert (rt.reason > 0).all()


def test_engines_from_nonzero_initial_guess():
    data = random_band(N, HW, HW, seed=33)
    mvj, mvt, pcj, pct = _operators(data, HW)
    B = _rhs(data, HW, 3, seed=34)
    X0 = np.random.default_rng(35).standard_normal(B.shape)
    for name in ("bicgstab_many", "gmres_many", "richardson_many",
                 "preonly_many"):
        rj = getattr(jkm, name)(mvj, jnp.asarray(B), jnp.asarray(X0),
                                pc_apply=pcj, rtol=1e-9, maxit=100)
        rt = getattr(tkm, name)(mvt, torch.from_numpy(B),
                                torch.from_numpy(X0), pc_apply=pct,
                                rtol=1e-9, maxit=100)
        _assert_same(rj, rt)


def test_bicgstab_many_half_step_exit():
    """With an exact PC every column passes the s-norm test: one iteration,
    one PC apply in it (the second half is skipped), as in JAX."""
    data = random_band(N, HW, HW, seed=36)
    mvj, mvt, _, _ = _operators(data, HW)
    B = _rhs(data, HW, 3, seed=37)
    sj = jpkg.spike_factor(JBand(jnp.asarray(data), HW, HW), K=4, block_b=8)
    st = tpkg.spike_factor(banded_from_numpy(data, HW, HW,
                                             device=CPU), K=4, block_b=8)
    calls = []

    def pct(X):
        calls.append(X.shape)
        return tpkg.spike_solve_many(st, X)
    rj = jkm.bicgstab_many(mvj, jnp.asarray(B), rtol=1e-8, maxit=20,
                           pc_apply=lambda X: jpkg.spike_solve_many(sj, X))
    rt = tkm.bicgstab_many(mvt, torch.from_numpy(B), rtol=1e-8, maxit=20,
                           pc_apply=pct)
    assert rt.its.tolist() == [1, 1, 1] and len(calls) == 1
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    hj = np.asarray(rj.history)[:2]             # the s-norm sits at roundoff
    np.testing.assert_allclose(rt.history.numpy()[:2], hj, rtol=1e-8,
                               atol=1e-12 * hj[0].max())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)


FLAGSHIP_PC = {"pc_spike_partitions": 8, "pc_spike_block": 16,
               "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
               "pc_spike_inverter": "newton_fixed"}


@pytest.mark.parametrize("ksp_type", ["bcgs", "gmres", "richardson",
                                      "preonly"])
def test_solve_many_spike_pc_matches_jax(ksp_type):
    """The composition with the spike PC's native multi-RHS apply (bf16
    spikes, so the Krylov engines iterate), on the vmapped operator."""
    data = random_band(2048, 12, 12, seed=38)
    B = np.random.default_rng(39).standard_normal((2048, 3))
    kw = dict(ksp_type=ksp_type, pc_type="spike", rtol=1e-10, maxit=30)
    rj = jksp.solve_many(JBand(jnp.asarray(data), 12, 12), jnp.asarray(B),
                         options=jpkg.Options(dict(FLAGSHIP_PC)), **kw)
    rt = tpkg.solve_many(banded_from_numpy(data, 12, 12,
                                           device=CPU), torch.from_numpy(B),
                         options=tpkg.Options(dict(FLAGSHIP_PC)), **kw)
    _assert_same(rj, rt)


def test_make_solver_many_blocktri_many_route_matches_jax(monkeypatch):
    """Both packages forced onto the multi-RHS blocktri route (the JAX one
    by its TPU rule, the port's by its CUDA rule), f32 band."""
    monkeypatch.setattr(jop, "_use_blocktri_matvec", lambda: True)
    monkeypatch.setattr(top, "_use_blocktri_matvec", lambda a: True)
    n, k, r = 1536, 48, 3
    data = random_band(n, k, k, seed=40, dtype=np.float32)
    B = np.random.default_rng(41).standard_normal((n, r)).astype(np.float32)
    jb, tb = JBand(jnp.asarray(data), k, k), banded_from_numpy(data, k, k,
                                                               device=CPU)
    assert jop.as_matvec_many(jb)[0]._route == "blocktri_many"
    assert top.as_matvec_many(tb)[0]._route == "blocktri_many"
    kw = dict(ksp_type="bcgs", pc_type="spike", rtol=1e-6, maxit=60)
    rj = jksp.make_solver_many(jb, jit=False, **kw)(jnp.asarray(B))
    rt = tpkg.make_solver_many(tb, **kw)(torch.from_numpy(B))
    np.testing.assert_array_equal(rt.its.numpy(), np.asarray(rj.its))
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, atol=1e-5 * np.abs(xj).max())
    for j in range(r):
        res = t_mv(tb, rt.x[:, j]) - torch.from_numpy(B[:, j])
        assert float(torch.linalg.norm(res) / np.linalg.norm(B[:, j])) < 5e-6


def test_make_solver_many_pc_without_apply_many():
    """A PC with no multi-RHS apply is applied column by column (JAX: a
    vmap of ``apply``)."""
    from spike_petsc_tpu.solvers.pc import PC as JPC
    from spike_petsc_tpu_torch.solvers.pc import PC as TPC
    data = random_band(N, HW, HW, seed=45)
    _, _, pcj, pct = _operators(data, HW)
    B = _rhs(data, HW, 3, seed=46)
    kw = dict(ksp_type="gmres", rtol=1e-10, maxit=100, restart=10)
    rj = jksp.make_solver_many(JBand(jnp.asarray(data), HW, HW),
                               pc=JPC(name="diag",
                                      apply=lambda x: pcj(x[:, None])[:, 0]),
                               jit=False, **kw)(jnp.asarray(B))
    rt = tpkg.make_solver_many(banded_from_numpy(data, HW, HW, device=CPU),
                               pc=TPC(name="diag",
                                      apply=lambda x: pct(x[:, None])[:, 0]),
                               **kw)(torch.from_numpy(B))
    _assert_same(rj, rt)


@pytest.mark.parametrize("pc_type,opts", [("none", {}),
                                          ("spike", FLAGSHIP_PC)])
def test_single_rhs_bcgs_matches_jax(pc_type, opts):
    data = random_band(2048, 12, 12, seed=42)
    b = np.random.default_rng(43).standard_normal(2048)
    kw = dict(ksp_type="bcgs", pc_type=pc_type, rtol=1e-10, maxit=100)
    rj = jpkg.solve(JBand(jnp.asarray(data), 12, 12), jnp.asarray(b),
                    options=jpkg.Options(dict(opts)), **kw)
    rt = tpkg.solve(banded_from_numpy(data, 12, 12,
                                      device=CPU), torch.from_numpy(b),
                    options=tpkg.Options(dict(opts)), **kw)
    assert rt.its == int(rj.its) and rt.its >= 1
    assert rt.reason == int(rj.reason) == 2
    hj = np.asarray(rj.history)
    np.testing.assert_allclose(rt.history.numpy()[:rt.its + 1],
                               hj[:rt.its + 1], rtol=1e-8)
    assert np.isnan(rt.history.numpy()[rt.its + 1:]).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.rnorm, float(rj.rnorm), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(ksp_type="tfqmr"), ValueError, "no batched engine"),
])
def test_make_solver_many_rejects(kwargs, exc, match):
    kwargs = dict(kwargs)
    opts = tpkg.Options(kwargs.pop("options", {}))
    band = banded_from_numpy(random_band(600, 2, 2, seed=44), 2, 2, device=CPU)
    with pytest.raises(exc, match=match):
        tpkg.make_solver_many(band, options=opts, **kwargs)
    if exc is ValueError:      # the JAX package says the same
        with pytest.raises(exc, match=match):
            jksp.make_solver_many(JBand(jnp.asarray(band.data.numpy()), 2, 2),
                                  **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(transpose=True),
    dict(transpose=True, options={"ksp_nullspace_constant": 1}),
    dict(options={"ksp_diagonal_scale": 1}),
], ids=["transpose", "transpose-nullspace", "diagonal-scale"])
def test_make_solver_many_transpose_and_options_match_jax(kwargs):
    """What make_solver_many once refused, solved as JAX solves it: A^T X = B
    on the same band (the null-space projections swapped), and
    ``-ksp_diagonal_scale``, which the batched composition does not read in
    either package (``solve`` scales)."""
    kwargs = dict(kwargs)
    opts = kwargs.pop("options", {})
    data = random_band(600, 2, 2, seed=44)
    B = np.random.default_rng(45).standard_normal((600, 3))
    kw = dict(ksp_type="bcgs", pc_type="jacobi", rtol=1e-10, maxit=300,
              **kwargs)
    rj = jksp.make_solver_many(JBand(jnp.asarray(data), 2, 2),
                               options=jpkg.Options(dict(opts)), jit=False,
                               **kw)(jnp.asarray(B))
    rt = tpkg.make_solver_many(banded_from_numpy(data, 2, 2, device=CPU),
                               options=tpkg.Options(dict(opts)),
                               **kw)(torch.from_numpy(B))
    assert rt.its.tolist() == np.asarray(rj.its).tolist()
    assert rt.reason.tolist() == np.asarray(rj.reason).tolist()
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("mode", ["never", "ifneeded", "always"])
def test_gmres_many_side_and_cgs_refinement_match_jax(side, mode):
    """``side`` and ``cgs_refinement`` through the batched GMRES (once
    refused here): JAX's test_gmres_many_cgs_refinement_parity problem
    (``nonsym_banded(256, 3, 3, seed=6, dominance=0.4)``, two columns,
    restart 30, rtol 1e-10) with a Jacobi PC, against JAX's gmres_many
    (counts, reasons, histories, x) and per column against the port's
    single-RHS ``gmres`` under the same options (counts, x at 1e-9)."""
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu_torch.solvers import krylov as tkr
    a = problems.nonsym_banded(256, 3, 3, seed=6, dominance=0.4).toarray()
    data = np.zeros((256, 7))
    for d in range(-3, 4):
        rows = np.arange(max(0, -d), min(256, 256 - d))
        data[rows, d + 3] = a[rows, rows + d]
    mvj, mvt, pcj, pct = _operators(data, 3)
    U = np.random.default_rng(1).standard_normal((256, 2))
    B = a @ U
    kw = dict(rtol=1e-10, maxit=600, restart=30, side=side,
              cgs_refinement=mode)
    rj = jkm.gmres_many(mvj, jnp.asarray(B), pc_apply=pcj, **kw)
    rt = tkm.gmres_many(mvt, torch.from_numpy(B), pc_apply=pct, **kw)
    _assert_same(rj, rt)
    assert (rt.reason > 0).all()
    tb = banded_from_numpy(data, 3, 3, device=CPU)
    diag = torch.from_numpy(data[:, 3].copy())
    for j in range(2):
        r1 = tkr.gmres(lambda v: t_mv(tb, v), torch.from_numpy(B[:, j]),
                       pc_apply=lambda v: v / diag, **kw)
        assert r1.its == int(rt.its[j]) and r1.reason == int(rt.reason[j])
        np.testing.assert_allclose(rt.x[:, j].numpy(), r1.x.numpy(),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(rt.x[:, j].numpy(), U[:, j], rtol=1e-6,
                                   atol=1e-8)


def test_gmres_many_rejects_unknown_options():
    """``cgs_refinement='bogus'`` raises ``ValueError`` naming the option,
    as in JAX; an unknown ``side`` too."""
    data = random_band(64, 2, 2, seed=3)
    _, mvt, _, _ = _operators(data, 2)
    B = torch.ones((64, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="cgs_refinement"):
        tkm.gmres_many(mvt, B, maxit=2, cgs_refinement="bogus")
    with pytest.raises(ValueError, match="side"):
        tkm.gmres_many(mvt, B, maxit=2, side="middle")


def test_solve_many_gmres_right_spike_matches_jax():
    """``make_solver_many(ksp_type='gmres')`` with the spike PC applied on
    the right (``-ksp_pc_side right``), against JAX's."""
    data = random_band(600, 2, 2, seed=44)
    B = np.random.default_rng(46).standard_normal((600, 3))
    opts = {"ksp_pc_side": "right", "pc_spike_partitions": 4,
            "pc_spike_block": 8}
    kw = dict(ksp_type="gmres", pc_type="spike", rtol=1e-10, maxit=100)
    rj = jksp.make_solver_many(JBand(jnp.asarray(data), 2, 2),
                               options=jpkg.Options(dict(opts)), jit=False,
                               **kw)(jnp.asarray(B))
    rt = tpkg.make_solver_many(banded_from_numpy(data, 2, 2, device=CPU),
                               options=tpkg.Options(dict(opts)),
                               **kw)(torch.from_numpy(B))
    assert rt.its.tolist() == np.asarray(rj.its).tolist()
    assert rt.reason.tolist() == np.asarray(rj.reason).tolist()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)

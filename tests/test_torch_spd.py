"""PyTorch port, the SPD path, against the JAX package: ``method='spd'``
block-LDL^T factors, truncated SPIKE, single-RHS ``cg``, the ``cholesky``
PC, and ``solve``/``solve_many`` with ``ksp_type="cg"``,
``pc_type="cholesky"`` (BASELINE config 2 cut to n <= 4096, K <= 16,
b <= 16).

Inputs: ``models.problems.spd_banded`` from numpy seeds (the same matrix
as ``torch_parity.spd_band``), handed to both packages as numpy arrays.

Tolerances: factors, spikes, reduced systems and solves at atol 1e-10 in
f64 (the same algebra in another summation order); ``solve`` solutions at
1e-10 relative; Krylov iteration counts and reasons equal, histories at
rtol 1e-8 with an absolute floor of 1e-12 of the initial residual (a direct
PC leaves the second residual at roundoff); the plain sweeps against the
fused Pallas kernels (interpret mode) in f32 at rtol 1e-5, atol 1e-6, as
tests/test_spd.py holds those kernels against the XLA scan; the truncated
config-2 solve at relative error < 1e-5, as tests/test_baseline_configs.py
requires.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_from_dense as j_from_dense
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.ops.pallas.fused_sweep import (
    blocktri_solve_fused_many_pallas, blocktri_solve_fused_pallas)
from spike_petsc_tpu.solvers import krylov as jkr
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import blocktri as tbt
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many_spd as cfms
from spike_petsc_tpu_torch.ops.cuda import fused_sweep_spd as cfss
from spike_petsc_tpu_torch.solvers import krylov as tkr
from spike_petsc_tpu_torch.solvers.pc import PC as TPC
from spike_petsc_tpu_torch.solvers.pc import _newton_safety_net

from torch_parity import CPU, jax_spike_to_numpy, spd_band, t2n

ATOL = 1e-10
N, HW, B = 2048, 8, 16


@pytest.fixture(scope="module")
def band():
    return spd_band(N, HW, seed=2)


@pytest.fixture(scope="module")
def rhs():
    return np.random.default_rng(3).standard_normal(N)


@pytest.fixture(scope="module")
def jax_spd_factor(band):
    """JAX spd spike factors of ``band`` at block B, one per (K,
    truncated, store_spikes), each made once for the module."""
    jb = JBand(jnp.asarray(band), HW, HW)
    made = {}

    def get(K, truncated, store):
        if (K, truncated, store) not in made:
            made[K, truncated, store] = jsp.spike_factor(
                jb, K=K, block_b=B, method="spd", truncated=truncated,
                store_spikes=store)
        return made[K, truncated, store]
    return get


def _bands(data, k=HW):
    return JBand(jnp.asarray(data), k, k), banded_from_numpy(data, k, k,
                                                             device=CPU)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(t2n(got), np.asarray(ref), atol=atol)


def test_spd_band_is_the_problems_matrix():
    """torch_parity.spd_band is models.problems.spd_banded in band storage."""
    n, k = 300, 5
    data = spd_band(n, k, seed=7)
    dense = np.zeros((n, n))
    for d in range(-k, k + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        dense[rows, rows + d] = data[rows, d + k]
    np.testing.assert_allclose(          # the diagonal's sums in another order
        dense, problems.spd_banded(n, k, seed=7).toarray(), rtol=1e-14)


@pytest.mark.parametrize("inverter", ["lapack", "newton_fixed"])
def test_blocktri_spd_factor_and_solve_match_jax(band, inverter):
    """F and Sinv of the symmetric factorization, its empty U, and the
    symmetric sweeps, batched over a leading partition axis."""
    jb, tb = _bands(band[:8 * 4 * B])
    jt = jbt.band_to_blocktri(jb, B)
    tt = tbt.band_to_blocktri(tb, B)
    lead = lambda m: m.reshape(4, 8, B, B)
    fj = jax.vmap(lambda t: jbt.blocktri_factor(
        t, method="spd", inverter=inverter))(
        jbt.BlockTridiagonal(D=lead(jt.D), L=lead(jt.L), U=lead(jt.U)))
    ft = tbt.blocktri_factor(tbt.BlockTridiagonal(
        D=lead(tt.D), L=lead(tt.L), U=lead(tt.U)), method="spd",
        inverter=inverter)
    assert ft.method == "spd" and tuple(ft.U.shape) == (4, 8, 0, 0)
    _close(ft.F, fj.F)
    _close(ft.Sinv, fj.Sinv)
    R = np.random.default_rng(4).standard_normal((4, 8, B, 3))
    xj = jax.vmap(jbt.blocktri_solve)(fj, jnp.asarray(R))
    _close(tbt.blocktri_solve(ft, torch.from_numpy(R)), xj)
    _close(tbt.blocktri_solve(ft, torch.from_numpy(R[..., 0])), xj[..., 0])
    f16 = tbt.cast_factor(ft, torch.bfloat16)
    assert f16.method == "spd" and f16.F.dtype == torch.bfloat16
    # complex Hermitian blocks (the real ones with an antisymmetric
    # imaginary part on the diagonal blocks) factor as JAX factors them
    rng = np.random.default_rng(5)
    im = rng.standard_normal((4, 8, B, B))
    im = 0.1 * (im - np.swapaxes(im, -1, -2))
    D = lead(tt.D).numpy() + 1j * im
    L, U = lead(tt.L).numpy() + 0j, lead(tt.U).numpy() + 0j
    fjc = jax.vmap(lambda t: jbt.blocktri_factor(
        t, method="spd", inverter=inverter))(jbt.BlockTridiagonal(
            D=jnp.asarray(D), L=jnp.asarray(L), U=jnp.asarray(U)))
    ftc = tbt.blocktri_factor(tbt.BlockTridiagonal(
        D=torch.from_numpy(D), L=torch.from_numpy(L), U=torch.from_numpy(U)),
        method="spd", inverter=inverter)
    _close(ftc.F, fjc.F)
    _close(ftc.Sinv, fjc.Sinv)
    Rc = R + 1j * np.random.default_rng(6).standard_normal(R.shape)
    _close(tbt.blocktri_solve(ftc, torch.from_numpy(Rc)),
           jax.vmap(jbt.blocktri_solve)(fjc, jnp.asarray(Rc)))


def test_spd_sweeps_match_pallas_interpret():
    """The plain spd sweeps, reached through the kernels' wrappers on CPU
    tensors, against the JAX fused Pallas kernels in interpret mode."""
    a = problems.spd_banded(256, 3, seed=51)
    data = np.asarray(j_from_dense(jnp.asarray(a.toarray(), jnp.float32),
                                   3, 3).data)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), 3, 3), K=4, block_b=8,
                          method="spd")
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    rng = np.random.default_rng(9)
    r = rng.standard_normal((4, sj.nb, 8)).astype(np.float32)
    R = rng.standard_normal((4, sj.nb, 8, 3)).astype(np.float32)
    x = cfss.blocktri_solve_fused_spd_cuda(st.fact, torch.from_numpy(r))
    X = cfms.blocktri_solve_fused_many_spd_cuda(st.fact, torch.from_numpy(R))
    np.testing.assert_allclose(
        t2n(x), np.asarray(blocktri_solve_fused_pallas(sj.fact,
                                                       jnp.asarray(r))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t2n(X), np.asarray(blocktri_solve_fused_many_pallas(sj.fact,
                                                            jnp.asarray(R))),
        rtol=1e-5, atol=1e-6)


SPIKE_CASES = [  # K, truncated, store_spikes
    (1, False, False), (4, False, True), (4, True, False), (16, True, True)]


@pytest.mark.parametrize("K,truncated,store", SPIKE_CASES)
def test_spike_factor_spd_matches_jax(band, rhs, jax_spd_factor, K,
                                      truncated, store):
    _, tb = _bands(band)
    sj = jax_spd_factor(K, truncated, store)
    st = tsp.spike_factor(tb, K=K, block_b=B, method="spd",
                          truncated=truncated, store_spikes=store)
    assert (st.n, st.K, st.m, st.b, st.k, st.truncated) == \
        (sj.n, sj.K, sj.m, sj.b, sj.k, sj.truncated)
    assert st.fact.method == "spd" and st.fact.U.numel() == 0
    _close(st.fact.F, sj.fact.F)
    _close(st.fact.Sinv, sj.fact.Sinv)
    _close(st.Btip, sj.Btip)
    _close(st.Ctip, sj.Ctip)
    if K == 1:
        assert st.red_fact is None and st.red_Dinv is None
    elif truncated:                      # the reduced diagonal's inverse
        assert st.red_fact is None and sj.red_fact is None
        _close(st.red_Dinv, sj.red_Dinv)
    else:                                # spd partitions -> inv reduced
        assert st.red_Dinv is None and st.red_fact.method == "inv"
        for name in ("F", "U", "Sinv"):
            _close(getattr(st.red_fact, name), getattr(sj.red_fact, name))
    if store and K > 1:
        _close(st.V, sj.V)
        _close(st.W, sj.W)
    else:
        assert st.V is None and st.W is None
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs)))
    R = np.random.default_rng(5).standard_normal((N, 3))
    _close(tsp.spike_solve_many(st, torch.from_numpy(R)),
           jsp.spike_solve_many(sj, jnp.asarray(R)))


@pytest.mark.parametrize("truncated", [False, True])
def test_jax_spd_factor_through_convert(band, rhs, jax_spd_factor,
                                        truncated):
    """Solve parity alone: the port's solves on a JAX spd factor (the
    stored-spike factors of SPIKE_CASES)."""
    sj = jax_spd_factor(16 if truncated else 4, truncated, True)
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    assert st.fact.method == "spd" and st.truncated == truncated
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs)))
    R = np.random.default_rng(6).standard_normal((N, 2))
    _close(tsp.spike_solve_many(st, torch.from_numpy(R)),
           jsp.spike_solve_many(sj, jnp.asarray(R)))


def test_config2_truncated_spike_matches_jax():
    """BASELINE config 2 as tests/test_baseline_configs.py runs it: 'inv'
    partitions, truncated reduced system, K = 16, batched solves, then CG
    with the factorization as PC."""
    n, k = 4096, 8
    a = problems.spd_banded(n, k, seed=2)
    data = spd_band(n, k, seed=2)
    jb, tb = _bands(data, k)
    sj = jsp.spike_factor(jb, K=16, block_b=16, truncated=True)
    st = tsp.spike_factor(tb, K=16, block_b=16, truncated=True)
    U = np.random.default_rng(0).standard_normal((n, 4))
    X = tsp.spike_solve_many(st, torch.from_numpy(a @ U)).numpy()
    assert np.linalg.norm(X - U) / np.linalg.norm(U) < 1e-5
    np.testing.assert_allclose(
        X, np.asarray(jsp.spike_solve_many(sj, jnp.asarray(a @ U))),
        atol=ATOL)
    b = a @ U[:, 0]
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type="cg",
                    pc=TPC(name="spike",
                           apply=lambda v: tsp.spike_solve(st, v)),
                    rtol=1e-12, maxit=50)
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type="cg",
                    pc=jpkg.PC(name="spike",
                               apply=lambda v: jsp.spike_solve(sj, v)),
                    rtol=1e-12, maxit=50)
    assert rt.reason == int(rj.reason) > 0 and rt.its == int(rj.its) <= 5
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)


def _history_close(ht, hj, its):
    hj = np.asarray(hj)[:its + 1]
    np.testing.assert_allclose(ht.numpy()[:its + 1], hj, rtol=1e-8,
                               atol=1e-12 * hj[0])
    assert np.isnan(ht.numpy()[its + 1:]).all()


@pytest.mark.parametrize("pc", ["none", "spd_spike"])
def test_cg_matches_jax(band, rhs, jax_spd_factor, pc):
    """krylov.cg on the same operator and PC: iterations, reason, history
    and solution."""
    jb, tb = _bands(band)
    pj = pt = None
    if pc == "spd_spike":
        sj = jax_spd_factor(4, True, False)
        st = tsp.spike_factor(tb, K=4, block_b=B, method="spd",
                              truncated=True)
        pj = lambda v: jsp.spike_solve(sj, v)
        pt = lambda v: tsp.spike_solve(st, v)
    rj = jkr.cg(lambda v: j_mv(jb, v), jnp.asarray(rhs), None, pj,
                rtol=1e-10, maxit=200)
    rt = tkr.cg(lambda v: t_mv(tb, v), torch.from_numpy(rhs), None, pt,
                rtol=1e-10, maxit=200)
    assert (rt.its, rt.reason) == (int(rj.its), int(rj.reason))
    assert rt.reason == 2 and rt.its >= 1
    _history_close(rt.history, rj.history, rt.its)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.rnorm, float(rj.rnorm), rtol=1e-6,
                               atol=1e-12)
    # a nonzero initial guess takes the b - A x0 branch
    x0 = np.full(N, 0.5)
    rj0 = jkr.cg(lambda v: j_mv(jb, v), jnp.asarray(rhs), jnp.asarray(x0),
                 pj, rtol=1e-10, maxit=200)
    rt0 = tkr.cg(lambda v: t_mv(tb, v), torch.from_numpy(rhs),
                 torch.from_numpy(x0), pt, rtol=1e-10, maxit=200)
    assert (rt0.its, rt0.reason) == (int(rj0.its), int(rj0.reason))
    _history_close(rt0.history, rj0.history, rt0.its)


CHOLESKY_OPTS = [
    {"pc_cholesky_partitions": 8, "pc_cholesky_block": B,
     "pc_cholesky_truncated": 1, "pc_cholesky_store_spikes": 1},
    {"pc_cholesky_partitions": 4, "pc_cholesky_block": B},
    {},                                  # K = 1: the direct solve
]


@pytest.mark.parametrize("opts", CHOLESKY_OPTS)
def test_solve_cg_cholesky_matches_jax(band, rhs, opts):
    jb, tb = _bands(band)
    rj = jpkg.solve(jb, jnp.asarray(rhs), ksp_type="cg", pc_type="cholesky",
                    options=jpkg.Options(dict(opts)), rtol=1e-10)
    rt = tpkg.solve(tb, torch.from_numpy(rhs), ksp_type="cg",
                    pc_type="cholesky", options=tpkg.Options(dict(opts)),
                    rtol=1e-10)
    assert (rt.its, rt.reason) == (int(rj.its), int(rj.reason))
    assert rt.reason == 2 and 1 <= rt.its <= 5
    _history_close(rt.history, rj.history, rt.its)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)
    # the same PC's info as the JAX one
    from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
    from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc
    assert t_make_pc("cholesky", tb, tpkg.Options(dict(opts))).info == \
        j_make_pc("cholesky", jb, jpkg.Options(dict(opts))).info


@pytest.mark.parametrize("opts", CHOLESKY_OPTS[:1])
def test_solve_many_cg_cholesky_matches_jax(band, opts):
    jb, tb = _bands(band)
    Bm = np.random.default_rng(8).standard_normal((N, 3))
    rj = jpkg.solve_many(jb, jnp.asarray(Bm), ksp_type="cg",
                         pc_type="cholesky",
                         options=jpkg.Options(dict(opts)), rtol=1e-10)
    rt = tpkg.solve_many(tb, torch.from_numpy(Bm), ksp_type="cg",
                         pc_type="cholesky",
                         options=tpkg.Options(dict(opts)), rtol=1e-10)
    np.testing.assert_array_equal(rt.its.numpy(), np.asarray(rj.its))
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    assert (rt.reason.numpy() == 2).all()
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)


def test_safety_net_exact_and_truncated(band):
    """A factor of 2A solves A x = b to a probe residual of 1/2: an exact
    factorization re-factors, a truncated one (exact=False) keeps it."""
    _, tb = _bands(band)
    twice = tpkg.BandedMatrix(data=2 * tb.data, kl=HW, ku=HW)
    sf = tsp.spike_factor(twice, K=4, block_b=B, method="spd")
    calls = []

    def refactor():
        calls.append(1)
        return sf

    _, fb = _newton_safety_net(tb, sf, "newton_fixed", None, None, refactor)
    assert fb and calls == [1]
    _, fb = _newton_safety_net(tb, sf, "newton_fixed", None, None, refactor,
                               exact=False)
    assert not fb and calls == [1]


def test_cholesky_pc_transpose_matches_jax(band, rhs):
    """The cholesky PC's transpose: a real spd factorization is its own
    transpose, so M^-T r is M^-1 r, as JAX's."""
    from spike_petsc_tpu.solvers.pc import make_pc as jmake_pc
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    jb, tb = _bands(band)
    opts = {"pc_cholesky_partitions": 4, "pc_cholesky_block": B}
    pc = make_pc("cholesky", tb, tpkg.Options(dict(opts)))
    assert pc.info["method"] == "spd" and pc.apply_many is not None
    pct = pc.transpose()
    assert pct.name == "cholesky_transpose" and pct.transpose() is pc
    got = pct.apply(torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(),
                               pc.apply(torch.from_numpy(rhs)).numpy(),
                               rtol=0, atol=0)
    ref = jmake_pc("cholesky", jb, jpkg.Options(dict(opts))).transpose()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.apply(jnp.asarray(rhs))),
                               atol=ATOL)


@pytest.mark.parametrize("k,block", [(1, 64), (16, 64), (64, 64), (65, 128),
                                     (128, 128)])
def test_spd_block_for_picks_the_smallest_kernel_block(k, block):
    """The block the cholesky PC takes on the card when none is given."""
    assert cfss.spd_block_for(k) == block


def test_spd_block_for_refuses_wide_tips():
    with pytest.raises(ValueError, match="none of which covers a tip of 129"):
        cfss.spd_block_for(129)

"""PyTorch port, the transpose stack against the JAX package: band
transposes (both forms), the transposed matvec and diagonal scaling, the
block-Thomas transpose solves and the regular-form transposed factor,
``spike_transpose`` in its three forms, ``transpose_operator`` and the
transpose of every PC.

Same numpy inputs on both sides, f64 on the CPU.  Tolerances: 1e-14 for
the band operations (the same products in another order), 1e-12 for the
block-Thomas transposes and every solve; a bf16 ``store_lt`` solve within
5e-3 relative of JAX's (both store the L blocks in bf16 and compute in
f32 or wider, in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import band as jband
from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.solvers import operator as jop
from spike_petsc_tpu.solvers import pc as jpc
from spike_petsc_tpu.utils.options import Options as JOptions
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_from_numpy)
from spike_petsc_tpu_torch.ops import band as tband
from spike_petsc_tpu_torch.ops import blocktri as tbt
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.solvers import operator as top
from spike_petsc_tpu_torch.solvers import pc as tpc
from spike_petsc_tpu_torch.utils.options import Options as TOptions

from torch_parity import CPU, j2n, random_band, spd_band, t2n

N, KL, KU, B = 333, 3, 2, 8          # n not divisible by K * b: padding


@pytest.fixture(scope="module")
def band():
    return random_band(N, KL, KU, seed=7)


@pytest.fixture(scope="module")
def rhs():
    return np.random.default_rng(92).standard_normal(N)


def _jband(data, kl, ku):
    return jband.BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def _close(got, ref, atol):
    np.testing.assert_allclose(t2n(got), j2n(ref), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# ops/band.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kl,ku", [(701, 3, 5), (701, 300, 250),
                                     (40, 30, 20)],
                         ids=["shifted", "gather", "wider-than-n"])
def test_banded_transpose_matches_jax(n, kl, ku):
    """w <= 512 takes the shifted slices, w > 512 the gather, as in JAX;
    both forms agree with each other and with JAX, kl and ku swapped."""
    data = random_band(n, kl, ku, seed=n + kl)
    got = tband.banded_transpose(banded_from_numpy(data, kl, ku, device=CPU))
    ref = jband.banded_transpose(_jband(data, kl, ku))
    assert (got.kl, got.ku) == (ref.kl, ref.ku) == (ku, kl)
    _close(got.data, ref.data, 0)
    tb = banded_from_numpy(data, kl, ku, device=CPU)
    np.testing.assert_array_equal(tband._transpose_shifted(tb).data.numpy(),
                                  tband._transpose_gather(tb).data.numpy())
    dense = tband.banded_to_dense(tb).numpy()
    np.testing.assert_array_equal(tband.banded_to_dense(got).numpy(),
                                  dense.T)


@pytest.mark.parametrize("ncols", [0, 3])
def test_banded_matvec_t_matches_jax(band, ncols):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, ncols) if ncols else N)
    got = tband.banded_matvec_t(banded_from_numpy(band, KL, KU, device=CPU),
                                torch.from_numpy(x))
    ref = jband.banded_matvec_t(_jband(band, KL, KU), jnp.asarray(x))
    _close(got, ref, 1e-14 * np.abs(j2n(ref)).max())


@pytest.mark.parametrize("rows,cols", [(True, True), (True, False),
                                       (False, True)])
@pytest.mark.parametrize("kl,ku", [(KL, KU), (300, 250)])
def test_banded_diagonal_scale_matches_jax(rows, cols, kl, ku):
    n = 600
    data = random_band(n, kl, ku, seed=11)
    rng = np.random.default_rng(12)
    dr = rng.uniform(0.5, 2.0, n) if rows else None
    dc = rng.uniform(0.5, 2.0, n) if cols else None
    tb = banded_from_numpy(data, kl, ku, device=CPU)
    got = tband.banded_diagonal_scale(
        tb, None if dr is None else torch.from_numpy(dr),
        None if dc is None else torch.from_numpy(dc))
    ref = jband.banded_diagonal_scale(
        _jband(data, kl, ku), None if dr is None else jnp.asarray(dr),
        None if dc is None else jnp.asarray(dc))
    assert (got.kl, got.ku) == (kl, ku)
    _close(got.data, ref.data, 1e-14 * np.abs(data).max())
    np.testing.assert_array_equal(tb.data.numpy(), data)    # not mutated


# ---------------------------------------------------------------------------
# ops/blocktri.py
# ---------------------------------------------------------------------------

def _blocks(seed, nb=6, b=4, lead=()):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal(lead + (nb, b, b)) + 4 * np.eye(b)
    L = 0.3 * rng.standard_normal(lead + (nb, b, b))
    U = 0.3 * rng.standard_normal(lead + (nb, b, b))
    L[..., 0, :, :] = 0
    U[..., -1, :, :] = 0
    return D, L, U


def _jfactor(D, L, U, method, lead):
    f = jbt.blocktri_factor
    t = jbt.BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L),
                             U=jnp.asarray(U))
    if lead:
        import jax
        return jax.vmap(lambda tt: f(tt, method=method))(t)
    return f(t, method=method)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batched"])
def test_transposed_factor_matches_jax(lead):
    """F' = (Sinv U)^T, Sinv' = Sinv^T, U' = L^T shifted: entries within
    1e-12 of JAX's, contiguous tensors, and the forward sweeps on them the
    transpose solve."""
    D, L, U = _blocks(91, lead=lead)
    fj = _jfactor(D, L, U, "inv", lead)
    ft = tbt.blocktri_factor(blocktri_from_numpy(D, L, U, device=CPU))
    refs = jbt.transposed_factor_from_L(fj, jnp.asarray(L))
    for got in (tbt.transposed_factor_from_L(ft, torch.from_numpy(L)),
                tbt.transposed_factor_from_blocks(
                    ft, blocktri_from_numpy(D, L, U, device=CPU))):
        assert got.method == "inv"
        for name in ("F", "U", "Sinv"):
            g = getattr(got, name)
            assert g.is_contiguous(), name
            _close(g, getattr(refs, name), 1e-12)
    r = np.random.default_rng(5).standard_normal(lead + (6, 4))
    x = tbt.blocktri_solve(got, torch.from_numpy(r))
    _close(x, jbt.blocktri_solve(refs, jnp.asarray(r)) if not lead else
           np.stack([j2n(jbt.blocktri_solve(
               jbt.BlockTriFactor(F=refs.F[i], U=refs.U[i],
                                  Sinv=refs.Sinv[i], Slu=refs.Slu[i],
                                  piv=refs.piv[i], method="inv"),
               jnp.asarray(r[i]))) for i in range(lead[0])]), 1e-12)


@pytest.mark.parametrize("method", ["inv", "spd"])
@pytest.mark.parametrize("ncols", [0, 3])
def test_blocktri_solve_transpose_matches_jax(method, ncols):
    D, L, U = _blocks(93)
    if method == "spd":            # a symmetric block-tridiagonal matrix
        D = D + np.swapaxes(D, -1, -2)
        U = np.concatenate([np.swapaxes(L[1:], -1, -2), 0 * L[:1]])
    fj = _jfactor(D, L, U, method, ())
    ft = tbt.blocktri_factor(blocktri_from_numpy(D, L, U, device=CPU),
                             method=method)
    r = np.random.default_rng(94).standard_normal(
        (6, 4, ncols) if ncols else (6, 4))
    got = tbt.blocktri_solve_transpose(ft, torch.from_numpy(r))
    ref = jbt.blocktri_solve_transpose(fj, jnp.asarray(r))
    _close(got, ref, 1e-12)
    T = np.zeros((24, 24))
    for i in range(6):
        T[4 * i:4 * i + 4, 4 * i:4 * i + 4] = D[i]
        if i:
            T[4 * i:4 * i + 4, 4 * i - 4:4 * i] = L[i]
        if i < 5:
            T[4 * i:4 * i + 4, 4 * i + 4:4 * i + 8] = U[i]
    np.testing.assert_allclose(t2n(got).reshape(24, -1),
                               np.linalg.solve(T.T, r.reshape(24, -1)),
                               atol=1e-12)


def test_blocktri_solve_transpose_lu_is_unported():
    """The transposed solve on an ``lu`` factor (once refused here): JAX's
    answer, and T^T x = r."""
    D, L, U = _blocks(95)
    ft = tbt.blocktri_factor(blocktri_from_numpy(D, L, U, device=CPU),
                             method="lu")
    fj = jbt.blocktri_factor(jbt.BlockTridiagonal(
        D=jnp.asarray(D), L=jnp.asarray(L), U=jnp.asarray(U)), method="lu")
    r = np.random.default_rng(96).standard_normal((6, 4))
    got = tbt.blocktri_solve_transpose(ft, torch.from_numpy(r))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbt.blocktri_solve_transpose(
            fj, jnp.asarray(r))), atol=1e-12)
    T = np.zeros((24, 24))
    for i in range(6):
        T[4 * i:4 * i + 4, 4 * i:4 * i + 4] = D[i]
        if i:
            T[4 * i:4 * i + 4, 4 * i - 4:4 * i] = L[i]
        if i < 5:
            T[4 * i:4 * i + 4, 4 * i + 4:4 * i + 8] = U[i]
    np.testing.assert_allclose(got.numpy().reshape(24),
                               np.linalg.solve(T.T, r.reshape(24)),
                               atol=1e-12)


# ---------------------------------------------------------------------------
# ops/spike.py
# ---------------------------------------------------------------------------

def _factors(band, K, store, truncated, store_lt=False, store_dtype=None):
    jdt = {None: None, "bf16": jnp.bfloat16}[store_dtype]
    tdt = {None: None, "bf16": torch.bfloat16}[store_dtype]
    kw = dict(K=K, block_b=B, store_spikes=store, truncated=truncated,
              store_lt=store_lt)
    sj = jsp.spike_factor(_jband(band, KL, KU), store_dtype=jdt, **kw)
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU),
                          store_dtype=tdt, **kw)
    return sj, st


@pytest.mark.parametrize("form", ["store_lt", "band", "marker"])
@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("K,truncated", [(1, False), (2, False), (2, True),
                                         (4, False), (4, True)])
def test_spike_transpose_matches_jax(band, rhs, K, truncated, store, form):
    """Each form's solve (one and three right-hand sides) within 1e-12 of
    JAX's; the regular forms' factors are BlockTriFactor with contiguous
    F', U', Sinv', the marker form the marker.  (A single partition has no
    reduced system to truncate.)"""
    sj, st = _factors(band, K, store, truncated, store_lt=form == "store_lt")
    kw = dict(band=_jband(band, KL, KU)) if form == "band" else {}
    tkw = (dict(band=banded_from_numpy(band, KL, KU, device=CPU))
           if form == "band" else {})
    if form == "marker":
        kw = tkw = dict(fast=False)
    sjt = jsp.spike_transpose(sj, **kw)
    stt = tsp.spike_transpose(st, **tkw)
    if form == "marker":
        assert isinstance(stt.fact, tbt.TransposedBlockTriFactor)
    else:
        assert isinstance(stt.fact, tbt.BlockTriFactor)
        assert all(getattr(stt.fact, m).is_contiguous()
                   for m in ("F", "U", "Sinv"))
        for m in ("F", "U", "Sinv"):
            _close(getattr(stt.fact, m), getattr(sjt.fact, m), 1e-12)
    assert (stt.V is None) == (sjt.V is None) == (not store or K == 1)
    for tip in ("Btip", "Ctip"):
        assert getattr(stt, tip).is_contiguous()
        _close(getattr(stt, tip), getattr(sjt, tip), 0)
    _close(tsp.spike_solve(stt, torch.from_numpy(rhs)),
           jsp.spike_solve(sjt, jnp.asarray(rhs), impl="xla"), 1e-12)
    R = np.random.default_rng(97).standard_normal((N, 3))
    _close(tsp.spike_solve_many(stt, torch.from_numpy(R)),
           jsp.spike_solve_many(sjt, jnp.asarray(R), impl="xla"), 1e-12)


def test_spike_transpose_stored_lt_bf16_matches_jax(band, rhs):
    """bf16-stored factors and L blocks: the regular-form transpose solve
    within 5e-3 relative of JAX's; Lb stored bf16, F' stored bf16."""
    sj, st = _factors(band, 4, True, False, store_lt=True,
                      store_dtype="bf16")
    assert st.Lb.dtype == torch.bfloat16 and st.Lb.shape == st.fact.F.shape
    stt = tsp.spike_transpose(st)
    assert stt.fact.F.dtype == stt.fact.U.dtype == torch.bfloat16
    got = t2n(tsp.spike_solve(stt, torch.from_numpy(rhs)))
    ref = j2n(jsp.spike_solve(jsp.spike_transpose(sj), jnp.asarray(rhs),
                              impl="xla"))
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()


def test_store_lt_matches_jax_blocks(band):
    """The L blocks kept at factor time are JAX's (L[:, 0] zero); the
    spd method refuses store_lt with JAX's error."""
    sj, st = _factors(band, 4, False, False, store_lt=True)
    _close(st.Lb, sj.Lb, 0)
    sj1, st1 = _factors(band, 1, False, False, store_lt=True)
    _close(st1.Lb, sj1.Lb, 0)
    sym = spd_band(N, 3, seed=2)
    with pytest.raises(ValueError, match="store_lt"):
        tsp.spike_factor(banded_from_numpy(sym, 3, 3, device=CPU), K=2,
                         block_b=B, method="spd", store_lt=True)


def test_spd_spike_transpose_is_the_factor():
    sym = spd_band(N, 3, seed=2)
    st = tsp.spike_factor(banded_from_numpy(sym, 3, 3, device=CPU), K=4,
                          block_b=B, method="spd")
    assert tsp.spike_transpose(st) is st


def test_marker_refuses_the_kernels(band, rhs):
    _, st = _factors(band, 4, False, False)
    stt = tsp.spike_transpose(st, fast=False)
    for impl in ("cuda", "pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="block-Thomas"):
            tsp.spike_solve(stt, torch.from_numpy(rhs), impl=impl)
    with pytest.raises(ValueError, match="block-Thomas"):
        tsp.spike_solve_many(stt, torch.from_numpy(rhs[:, None]),
                             impl="pallas")


def _meta_factor(K, nb, b):
    """An ``inv`` factor of the given shape with no storage (meta
    tensors): enough for the route's rules, which read shapes and
    dtypes."""
    z = torch.zeros((K, nb, b, b), device="meta")
    return tbt.BlockTriFactor(F=z, U=z, Sinv=z, method="inv")


@pytest.mark.parametrize("K,nb,b,route", [(64, 123, 128, "fused"),
                                          (1, 1563, 64, "sweeps")],
                         ids=["flagship", "config1"])
def test_card_route_of_regular_form_transposes(K, nb, b, route):
    """A regular-form transpose routes as any ``inv`` factor on the card:
    the flagship shape to #1, config 1's single partition (nb = 1563) to
    #9; the marker to the plain transpose sweeps."""
    fwd = _meta_factor(K, nb, b)
    factT = tbt.transposed_factor_from_L(fwd, fwd.F)
    assert factT.F.shape == fwd.F.shape and factT.F.is_contiguous()
    assert tsp.sweep_route(fwd, b, torch.float32, on_cuda=True) == route
    assert tsp.sweep_route(factT, b, torch.float32, on_cuda=True) == route
    marker = tbt.TransposedBlockTriFactor(fwd)
    assert tsp.sweep_route(marker, b, torch.float32, on_cuda=True) == "plain"
    assert tsp.sweep_route(factT, b, torch.float32, on_cuda=False) == "plain"


# ---------------------------------------------------------------------------
# solvers/operator.py
# ---------------------------------------------------------------------------

def _apply(op, x):
    mv, n, _ = top.as_matvec(op, device=CPU)
    return mv(torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["band", "blocktri", "sparse", "dense_np",
                                  "dense_torch"])
def test_transpose_operator_matches_jax(band, kind):
    """The transposed operator of each representation: JAX's entries, and
    its matvec A^T x (within 1e-14 of max|A^T x|)."""
    x = np.random.default_rng(21).standard_normal(N)
    A = tband.banded_to_dense(banded_from_numpy(band, KL, KU,
                                                device=CPU)).numpy()
    ref_y = A.T @ x
    if kind == "band":
        got = top.transpose_operator(banded_from_numpy(band, KL, KU,
                                                       device=CPU))
        ref = jop.transpose_operator(_jband(band, KL, KU))
        assert (got.kl, got.ku) == (KU, KL)
        _close(got.data, ref.data, 0)
    elif kind == "blocktri":
        n = 40 * B
        data = random_band(n, KL, KU, seed=22)
        T = jbt.band_to_blocktri(_jband(data, KL, KU), B)
        got = top.transpose_operator(blocktri_from_numpy(
            *(np.asarray(a) for a in (T.D, T.L, T.U)), device=CPU))
        ref = jop.transpose_operator(T)
        for name in ("D", "L", "U"):
            _close(getattr(got, name), getattr(ref, name), 0)
        A = tband.banded_to_dense(banded_from_numpy(data, KL, KU,
                                                    device=CPU)).numpy()
        x = np.random.default_rng(23).standard_normal(n)
        ref_y = A.T @ x
    elif kind == "sparse":
        csr = sp.csr_matrix(A)
        got = top.transpose_operator(csr)
        assert sp.isspmatrix_csr(got) or got.format == "csr"
        assert abs(got - jop.transpose_operator(csr)).max() == 0
    elif kind == "dense_np":
        got = top.transpose_operator(A)
        np.testing.assert_array_equal(got, np.asarray(
            jop.transpose_operator(A)))
    else:
        got = top.transpose_operator(torch.from_numpy(A))
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jop.transpose_operator(A)))
    y = t2n(_apply(got, x))
    np.testing.assert_allclose(y, ref_y, rtol=0,
                               atol=1e-14 * np.abs(ref_y).max() * 10)


def test_transpose_operator_refuses_callables():
    """A bare callable raises TypeError with JAX's message; so does an
    operator of no known kind."""
    with pytest.raises(TypeError) as jerr:
        jop.transpose_operator(lambda v: v)
    with pytest.raises(TypeError) as terr:
        top.transpose_operator(lambda v: v)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="cannot transpose"):
        top.transpose_operator(np.zeros(3))


# ---------------------------------------------------------------------------
# solvers/pc.py
# ---------------------------------------------------------------------------

SPIKE_OPTS = {"pc_spike_partitions": 4, "pc_spike_block": B}
PC_CASES = [
    ("none", {}, "band"),
    ("jacobi", {}, "band"),
    ("spike", SPIKE_OPTS, "band"),
    ("spike", dict(SPIKE_OPTS, pc_spike_store_lt=1), "band"),
    ("spike", dict(SPIKE_OPTS, pc_spike_transpose_fast=0,
                   pc_spike_store_spikes=1), "band"),
    ("spike", dict(SPIKE_OPTS, pc_spike_factor_dtype="f32"), "band"),
    ("spike", dict(SPIKE_OPTS, pc_spike_inverter="newton"), "band"),
    ("cholesky", {"pc_cholesky_partitions": 4, "pc_cholesky_block": B},
     "spd"),
    ("lu", {}, "band"),
    ("lu", {"pc_lu_store_lt": 1, "pc_lu_block": B}, "band"),
    ("lu", {"pc_lu_transpose_fast": 0}, "band"),
    ("bjacobi", {"pc_bjacobi_blocks": 4, "pc_bjacobi_block": B}, "band"),
    ("banded", {"pc_banded_kmax": 6, "banded_pc_spike_partitions": 4,
                "banded_pc_spike_block": B}, "sparse"),
]


@pytest.mark.parametrize("name,opts,pmat", PC_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PC_CASES)])
def test_pc_transpose_matches_jax(band, rhs, name, opts, pmat):
    """M^-T r of every PC within 1e-12 of JAX's (the factor_dtype case,
    f32 factors, within 1e-5 of max|M^-T r|); the transpose is cached and
    an involution."""
    if pmat == "spd":
        data, kl, ku = spd_band(N, 3, seed=2), 3, 3
    else:
        data, kl, ku = band, KL, KU
    if pmat == "sparse":
        A = tband.banded_to_dense(banded_from_numpy(data, kl, ku,
                                                    device=CPU)).numpy()
        jmat, tmat = sp.csr_matrix(A), sp.csr_matrix(A)
    else:
        jmat, tmat = (_jband(data, kl, ku),
                      banded_from_numpy(data, kl, ku, device=CPU))
    pj = jpc.make_pc(name, jmat, JOptions(dict(opts)))
    pt = tpc.make_pc(name, tmat, TOptions(dict(opts)), device=CPU,
                     dtype=torch.float64)
    tj, tt = pj.transpose(), pt.transpose()
    assert tt.name == tj.name and tt.info == tj.info
    assert pt.transpose() is tt and tt.transpose() is pt
    got = t2n(tt.apply(torch.from_numpy(rhs)))
    ref = j2n(tj.apply(jnp.asarray(rhs)))
    atol = (1e-5 if "pc_spike_factor_dtype" in opts else 1e-12) \
        * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)

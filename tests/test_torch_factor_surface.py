"""PyTorch port, the factor surface of ``ops/blocktri.py`` and
``ops/spike.py`` beyond ``inv``/``spd``, against the JAX package.

Covered: ``boost_diag``; ``shift='nonzero'`` for the ``inv``, ``spd``,
``lu`` and ``cr`` methods (``nshift`` equal to JAX's); the zero-diagonal
matrix of ``tests/test_spike.py:140-198`` (b = 3: singular diagonal blocks)
solved by gmres on the shifted factor; the ``lu`` method (factor, solve,
transposed solve) on blocks whose pivots are not the identity; the
Newton–Schulz inverse from the Pan start (``newton_pan``); the block
conversions ``blocktri_to_band`` and ``blocktri_to_dense``;
``blocktri_factor_inv_waux``; ``spike_factor_blocks`` and
``spike_factor_grouped``; and the ``convert.py`` round trips of ``lu`` and
CR factors factored in JAX and solved in the port.

Inputs: numpy-seeded blocks and bands handed to both packages, f64 on the
CPU (JAX with x64 on, ``impl='xla'``).  Tolerances: f64 1e-10 (factor
blocks, solutions); pivots and counts exactly.  The zero-diagonal gmres
solves: the iteration counts equal and the answers within 1e-6 (the
shifted pivots are ~1e-8, so the factors' roundoff is amplified ~1e8: a
single shifted solve agrees with JAX's to ~1e-8 relative, not 1e-10).
The unshifted zero diagonal at b = 64 runs in f32 (the card's phase A):
its factors equal JAX's to the bit, and x is held within 1e-4 of u.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.solvers.krylov import gmres as j_gmres
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_factor_from_numpy,
                                           blocktri_from_numpy,
                                           cr_factor_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import blocktri as tbt
from spike_petsc_tpu_torch.ops import cyclic as tcr
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.solvers.krylov import gmres as t_gmres

from torch_parity import (CPU, j2n, jax_factor_to_kwargs,
                          jax_spike_to_numpy, random_band, t2n)

ATOL = 1e-10


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(t2n(got), j2n(ref), atol=atol)


def _general_blocks(nb, b, seed):
    """Random blocks, NOT diagonally dominant: the LU pivots of their Schur
    complements are not the identity."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((nb, b, b)) + 0.5 * np.eye(b)
    L = rng.standard_normal((nb, b, b)) * 0.3
    U = rng.standard_normal((nb, b, b)) * 0.3
    L[0] = 0
    U[nb - 1] = 0
    return D, L, U


def _both(D, L, U):
    return (blocktri_from_numpy(D, L, U, device=CPU),
            jbt.BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L),
                                 U=jnp.asarray(U)))


# ---------------------------------------------------------------------------
# boost_diag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amount", [0.0, 1e-3, 0.5])
def test_boost_diag_matches_jax(amount):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 6, 6))
    s[:, 2, 2] = 0.0                       # a zero pivot
    s[:, 3, 3] = -1e-12                    # a tiny negative one
    s[1] = 0.0                             # an all-zero block
    s[2, 4, 4] = 3e-4                      # below 1e-3 and 0.5 only
    got, n = tbt.boost_diag(torch.from_numpy(s), amount)
    ref, nj = jbt.boost_diag(jnp.asarray(s), amount)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert n.dtype == torch.int32 and int(n) == int(nj)
    # the sign of a raised pivot is kept
    assert got[0, 3, 3] < 0


# ---------------------------------------------------------------------------
# shifts on the zero-diagonal matrix, every method
# ---------------------------------------------------------------------------

ZN = 120


@pytest.fixture(scope="module")
def zerodiag():
    data, kl, ku = hsp.csr_to_banded_arrays(problems.zero_diag_tridiag(ZN))
    return data, kl, ku


SHIFT_CASES = {  # the factor options of each case
    "inv": dict(K=4, block_b=3),
    "spd": dict(K=4, block_b=3, method="spd"),
    "lu": dict(K=4, block_b=3, method="lu"),
    "cr": dict(K=2, block_b=3, method="cr"),
    "inv_b4_amount": dict(K=4, block_b=4, shift_amount=1e-2),
    "inv_K1": dict(K=1, block_b=3),
}


@pytest.mark.parametrize("case", sorted(SHIFT_CASES))
def test_shift_nonzero_matches_jax(zerodiag, case):
    data, kl, ku = zerodiag
    kw = dict(SHIFT_CASES[case], shift="nonzero")
    sj = jsp.spike_factor(JBand(jnp.asarray(data), kl, ku), **kw)
    st = tsp.spike_factor(banded_from_numpy(data, kl, ku, device=CPU), **kw)
    nsj = np.asarray(sj.fact.nshift)
    assert st.fact.nshift.dtype == torch.int32
    np.testing.assert_array_equal(st.fact.nshift.numpy(), nsj)
    assert nsj.sum() > 0
    if case in ("inv", "inv_b4_amount", "inv_K1", "spd"):
        for name in ("F", "Sinv"):
            _close(getattr(st.fact, name), getattr(sj.fact, name),
                   atol=1e-8)
    rhs = np.random.default_rng(2).standard_normal(ZN)
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    xj = j2n(jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    assert np.abs(x.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()


@pytest.mark.parametrize("method,K,maxit", [("inv", 4, 200),
                                            ("cr", 2, 300)])
def test_zero_diagonal_gmres_matches_jax(zerodiag, method, K, maxit):
    """``tests/test_spike.py:140-198``: b = 3 makes the diagonal blocks
    singular; the shifted factor preconditions gmres to the exact
    solution, in JAX's iteration count."""
    data, kl, ku = zerodiag
    kw = dict(K=K, block_b=3, method=method, shift="nonzero")
    jb = JBand(jnp.asarray(data), kl, ku)
    tb = banded_from_numpy(data, kl, ku, device=CPU)
    sj = jsp.spike_factor(jb, **kw)
    st = tsp.spike_factor(tb, **kw)
    u = np.ones(ZN)
    b = np.asarray(j_mv(jb, jnp.asarray(u)))
    rj = j_gmres(lambda v: j_mv(jb, v), jnp.asarray(b), None,
                 lambda v: jsp.spike_solve(sj, v, impl="xla"), rtol=1e-10,
                 maxit=maxit)
    rt = t_gmres(lambda v: t_mv(tb, v), torch.from_numpy(b), None,
                 lambda v: tsp.spike_solve(st, v), rtol=1e-10, maxit=maxit)
    assert (rt.its, rt.reason) == (int(rj.its), int(rj.reason))
    assert rt.reason > 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-6)
    np.testing.assert_allclose(rt.x.numpy(), u, atol=1e-5)


def test_unshifted_zero_diagonal_b3_is_singular(zerodiag):
    """Without the shift the b = 3 blocks of the zero diagonal are
    singular: the port's factor, as JAX's, holds non-finite inverses."""
    data, kl, ku = zerodiag
    st = tsp.spike_factor(banded_from_numpy(data, kl, ku, device=CPU), K=4,
                          block_b=3)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), kl, ku), K=4, block_b=3)
    assert st.fact.nshift is None
    assert (not bool(torch.isfinite(st.fact.Sinv).all())
            or float(st.fact.Sinv.abs().max()) > 1e12)
    assert (not bool(np.isfinite(np.asarray(sj.fact.Sinv)).all())
            or float(np.abs(np.asarray(sj.fact.Sinv)).max()) > 1e12)


# the zero-diagonal PCs of the card's phase A, unshifted, at b = 64 in f32
ZD_F32_PCS = {"spike": ({"pc_spike_partitions": 64, "pc_spike_block": 64}, 64),
              "lu": ({"pc_lu_block": 64}, 1)}


@pytest.mark.parametrize("pc", sorted(ZD_F32_PCS))
def test_unshifted_zero_diagonal_b64_f32_matches_jax(pc):
    """The zero diagonal at b = 64 without the shift, in f32 (n = 4000):
    the blocks are nonsingular and both packages' factors are the same to
    the bit, every entry an integer.  With u = 1 (the testbed's default)
    and rtol 1e-9, below f32's floor, the port's spike PC took 1 iteration
    and JAX's 2 (31 and 1 at n = 2e5): one PC apply maps A 1 to within f32
    rounding of 1 in both (checked here), and whether the first GMRES
    estimate lands under 1e-9 depends on that rounding alone.  On a
    seeded random u the iteration counts and reasons are equal."""
    opts, K = ZD_F32_PCS[pc]
    n = 4000
    data = np.tile([-1.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    jb = JBand(jnp.asarray(data), 1, 1)
    tb = banded_from_numpy(data, 1, 1, device=CPU)
    fj = jsp.spike_factor(jb, K, block_b=64)
    ft = tsp.spike_factor(tb, K, block_b=64)
    pairs = [(fj.fact, ft.fact)] + ([(fj.red_fact, ft.red_fact)] if K > 1
                                    else [])
    for fa, fb in pairs:
        for name in ("F", "U", "Sinv"):
            got = getattr(fb, name).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(fa, name)))
            np.testing.assert_array_equal(got, np.round(got))
    ones = np.ones(n, np.float32)
    b1 = np.asarray(j_mv(jb, jnp.asarray(ones)))
    pj = jpkg.make_pc(pc, jb, jpkg.Options(dict(opts)))
    pt = tpkg.solvers.pc.make_pc(pc, tb, tpkg.Options(dict(opts)))
    for y in (np.asarray(pj.apply(jnp.asarray(b1))),
              pt.apply(torch.from_numpy(b1)).numpy()):
        assert y.dtype == np.float32
        assert np.abs(y - 1).max() < 1e-5
    u = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    b = np.asarray(j_mv(jb, jnp.asarray(u)))
    kw = dict(ksp_type="gmres", pc_type=pc, rtol=1e-9, maxit=200)
    rj = jpkg.make_solver(jb, jit=False, options=jpkg.Options(dict(opts)),
                          **kw)(jnp.asarray(b))
    rt = tpkg.make_solver(tb, options=tpkg.Options(dict(opts)), **kw)(
        torch.from_numpy(b))
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) > 0
    for x in (np.asarray(rj.x), rt.x.numpy()):
        assert x.dtype == np.float32
        assert np.abs(x - u).max() < 1e-4


# ---------------------------------------------------------------------------
# the lu method
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lu_pair():
    D, L, U = _general_blocks(6, 5, seed=3)
    t, tj = _both(D, L, U)
    return tbt.blocktri_factor(t, method="lu"), jbt.blocktri_factor(
        tj, method="lu")


def test_lu_factor_matches_jax(lu_pair):
    ft, fj = lu_pair
    assert ft.method == "lu" and ft.Sinv.shape == (6, 0, 0)
    for name in ("F", "U", "Slu"):
        _close(getattr(ft, name), getattr(fj, name))
    assert ft.piv.dtype == torch.int32
    # the port's pivots are 1-based (LAPACK), JAX's 0-based
    np.testing.assert_array_equal(ft.piv.numpy() - 1, np.asarray(fj.piv))
    assert (np.asarray(fj.piv) != np.arange(5)).any(), \
        "the case must have non-identity pivots"


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 3)])
def test_lu_solve_and_transpose_match_jax(lu_pair, shape):
    ft, fj = lu_pair
    rhs = np.random.default_rng(4).standard_normal(shape)
    _close(tbt.blocktri_solve(ft, torch.from_numpy(rhs)),
           jbt.blocktri_solve(fj, jnp.asarray(rhs)))
    _close(tbt.blocktri_solve_transpose(ft, torch.from_numpy(rhs)),
           jbt.blocktri_solve_transpose(fj, jnp.asarray(rhs)))


def test_lu_refuses_cast():
    D, L, U = _general_blocks(3, 4, seed=5)
    ft = tbt.blocktri_factor(blocktri_from_numpy(D, L, U, device=CPU),
                             method="lu")
    with pytest.raises(ValueError, match="cast_factor"):
        tbt.cast_factor(ft, torch.float32)


def test_lu_shift_counts_match_jax():
    D, L, U = _general_blocks(5, 4, seed=6)
    D[:, 1, 1] = 0.0
    D[2] = 0.0
    t, tj = _both(D, L, U)
    for method in ("inv", "lu"):
        ft = tbt.blocktri_factor(t, method=method, shift="nonzero")
        fj = jbt.blocktri_factor(tj, method=method, shift="nonzero")
        assert int(ft.nshift) == int(fj.nshift) > 0
        _close(ft.F, fj.F, atol=1e-8)


# ---------------------------------------------------------------------------
# newton_pan
# ---------------------------------------------------------------------------

def test_newton_pan_matches_jax():
    """``tests/test_inverters.py:56``: any nonsingular block."""
    S = np.random.default_rng(1).standard_normal((4, 12, 12))
    X = tbt.newton_inv(torch.from_numpy(S), init="pan", max_steps=80)
    Xj = jbt.newton_inv(jnp.asarray(S), init="pan", max_steps=80)
    assert float((torch.from_numpy(S) @ X - torch.eye(12)).abs().max()) \
        < 1e-10
    _close(X, Xj, atol=1e-9)


def test_batched_inverse_newton_pan():
    S = np.random.default_rng(2).standard_normal((3, 8, 8)) + 4 * np.eye(8)
    X = tbt.batched_inverse(torch.from_numpy(S), "newton_pan")
    _close(X, jbt.batched_inverse(jnp.asarray(S), "newton_pan"))
    np.testing.assert_allclose(X.numpy(), np.linalg.inv(S), atol=1e-12)


# ---------------------------------------------------------------------------
# block conversions, the materialized waux factor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kl,ku,b", [(2, 3, 4), (4, 4, 4), (1, 0, 3)])
def test_blocktri_to_band_and_dense(kl, ku, b):
    data = random_band(5 * b, kl, ku, seed=kl + ku)
    cols = np.arange(5 * b)[:, None] + np.arange(-kl, ku + 1)[None, :]
    data[(cols < 0) | (cols >= 5 * b)] = 0       # zero edge slots
    t = tbt.band_to_blocktri(banded_from_numpy(data, kl, ku, device=CPU), b)
    tj = jbt.band_to_blocktri(JBand(jnp.asarray(data), kl, ku), b)
    back = tbt.blocktri_to_band(t, kl, ku)
    np.testing.assert_array_equal(back.data.numpy(), data)
    np.testing.assert_array_equal(
        back.data.numpy(), np.asarray(jbt.blocktri_to_band(tj, kl, ku).data))
    np.testing.assert_array_equal(tbt.blocktri_to_dense(t).numpy(),
                                  np.asarray(jbt.blocktri_to_dense(tj)))
    with pytest.raises(ValueError, match="half-bandwidths"):
        tbt.blocktri_to_band(t, b + 1, ku)


@pytest.mark.parametrize("shift", ["none", "nonzero"])
def test_blocktri_factor_inv_waux_matches_jax(shift):
    D, L, U = _general_blocks(6, 4, seed=7)
    D += 4 * np.eye(4)
    D[3, 0, 0] = 0.0
    t, tj = _both(D, L, U)
    y0 = np.random.default_rng(8).standard_normal((4, 2))
    ft, yt = tbt.blocktri_factor_inv_waux(t, torch.from_numpy(y0),
                                          shift=shift)
    fj, yj = jbt.blocktri_factor_inv_waux(tj, jnp.asarray(y0), shift=shift)
    for name in ("F", "U", "Sinv"):
        _close(getattr(ft, name), getattr(fj, name))
    _close(yt, yj)
    assert (ft.nshift is None) == (fj.nshift is None)
    if shift != "none":
        assert int(ft.nshift) == int(fj.nshift)


# ---------------------------------------------------------------------------
# spike_factor_blocks, spike_factor_grouped
# ---------------------------------------------------------------------------

GN, GK, GB = 768, 8, 8


@pytest.fixture(scope="module")
def grouped_band():
    return random_band(GN, 3, 3, seed=12)


@pytest.mark.parametrize("method", ["inv", "lu", "cr"])
def test_spike_factor_blocks_matches_jax(grouped_band, method):
    data = grouped_band
    t = tbt.band_to_blocktri(banded_from_numpy(data, 3, 3, device=CPU), GB)
    tj = jbt.band_to_blocktri(JBand(jnp.asarray(data), 3, 3), GB)
    st = tsp.spike_factor_blocks(t, GN, GK, 3, 3, method=method,
                                 store_spikes=True)
    sj = jsp.spike_factor_blocks(tj, GN, GK, 3, 3, method=method,
                                 store_spikes=True)
    _close(st.Btip, sj.Btip)
    _close(st.Ctip, sj.Ctip)
    _close(st.V, sj.V)
    _close(st.W, sj.W)
    rhs = np.random.default_rng(5).standard_normal(GN)
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    # the band entry gives the same factor
    sb = tsp.spike_factor(banded_from_numpy(data, 3, 3, device=CPU), GK,
                          block_b=GB, method=method, store_spikes=True)
    np.testing.assert_allclose(st.V.numpy(), sb.V.numpy(), atol=ATOL)


GROUPED_CASES = {  # ``tests/test_spike.py:226-233``
    "default": {}, "store_spikes": dict(store_spikes=True),
    "bf16_spikes": dict(store_spikes=True, spike_dtype="bf16"),
    "cr": dict(method="cr"), "truncated": dict(truncated=True),
    "shift": dict(shift="nonzero"), "store_lt": dict(store_lt=True),
    "lu": dict(method="lu"),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_spike_factor_grouped_matches(grouped_band, case):
    """Grouped (4 groups of 2) against the monolithic factor and JAX's
    grouped factor."""
    data = grouped_band
    kw = dict(GROUPED_CASES[case])
    kj = dict(kw)
    if kw.get("spike_dtype"):
        kw["spike_dtype"], kj["spike_dtype"] = torch.bfloat16, jnp.bfloat16
    tb = banded_from_numpy(data, 3, 3, device=CPU)
    st = tsp.spike_factor_grouped(tb, GK, 4, block_b=GB, **kw)
    sm = tsp.spike_factor(tb, GK, block_b=GB, **kw)
    sj = jsp.spike_factor_grouped(JBand(jnp.asarray(data), 3, 3), K=GK,
                                  groups=4, block_b=GB, **kj)
    rhs = np.random.default_rng(5).standard_normal(GN)
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    np.testing.assert_allclose(
        x.numpy(), tsp.spike_solve(sm, torch.from_numpy(rhs)).numpy(),
        atol=1e-12)
    _close(x, jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    if kw.get("shift"):
        np.testing.assert_array_equal(st.fact.nshift.numpy(),
                                      np.asarray(sj.fact.nshift))
    if kw.get("store_lt"):
        np.testing.assert_array_equal(st.Lb.numpy(), sm.Lb.numpy())


def test_spike_factor_grouped_refuses_bad_groups(grouped_band):
    with pytest.raises(ValueError, match="must divide"):
        tsp.spike_factor_grouped(
            banded_from_numpy(grouped_band, 3, 3, device=CPU), GK, 3,
            block_b=GB)


# ---------------------------------------------------------------------------
# convert.py: JAX lu and CR factors solved by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,shift", [("lu", "none"), ("lu", "nonzero"),
                                          ("cr", "none"), ("cr", "nonzero")])
def test_convert_round_trip(grouped_band, method, shift):
    data = grouped_band
    sj = jsp.spike_factor(JBand(jnp.asarray(data), 3, 3), K=GK, block_b=GB,
                          method=method, shift=shift, store_spikes=True)
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    if method == "lu":
        assert st.fact.method == "lu"
        np.testing.assert_array_equal(st.fact.piv.numpy() - 1,
                                      np.asarray(sj.fact.piv))
    else:
        assert isinstance(st.fact, tcr.CRFactor)
        assert (st.fact.nb, st.fact.n_pad) == (sj.fact.nb, sj.fact.n_pad)
    if shift != "none":
        np.testing.assert_array_equal(st.fact.nshift.numpy(),
                                      np.asarray(sj.fact.nshift))
    rhs = np.random.default_rng(6).standard_normal(GN)
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    R = np.random.default_rng(7).standard_normal((GN, 2))
    _close(tsp.spike_solve_many(st, torch.from_numpy(R)),
           jsp.spike_solve_many(sj, jnp.asarray(R), impl="xla"))


def test_convert_single_factors():
    D, L, U = _general_blocks(4, 5, seed=9)
    _, tj = _both(D, L, U)
    fj = jbt.blocktri_factor(tj, method="lu")
    ft = blocktri_factor_from_numpy(**jax_factor_to_kwargs(fj), device=CPU)
    rhs = np.random.default_rng(1).standard_normal((4, 5))
    _close(tbt.blocktri_solve(ft, torch.from_numpy(rhs)),
           jbt.blocktri_solve(fj, jnp.asarray(rhs)))
    from spike_petsc_tpu.ops import cyclic as jcr
    cj = jcr.cr_factor(jbt.BlockTridiagonal(
        D=tj.D + 6 * jnp.eye(5), L=tj.L, U=tj.U))
    ct = cr_factor_from_numpy(**jax_factor_to_kwargs(cj), device=CPU)
    _close(tcr.cr_solve(ct, torch.from_numpy(rhs)),
           jcr.cr_solve(cj, jnp.asarray(rhs)))
    with pytest.raises(ValueError, match="Slu and piv"):
        blocktri_factor_from_numpy(fj.F, fj.U, fj.Sinv, device=CPU,
                                   method="lu")


# ---------------------------------------------------------------------------
# the PC layer: -pc_factor_shift_type, -pc_<name>_method lu|cr
# ---------------------------------------------------------------------------

PC_CASES = {
    "spike_lu_shift": ("spike", {"pc_spike_partitions": 4,
                                 "pc_spike_block": 3,
                                 "pc_spike_method": "lu",
                                 "pc_factor_shift_type": "nonzero"}),
    "spike_cr_shift": ("spike", {"pc_spike_partitions": 2,
                                 "pc_spike_block": 3,
                                 "pc_spike_method": "cr",
                                 "pc_factor_shift_type": "nonzero"}),
    "spike_inv_amount": ("spike", {"pc_spike_partitions": 4,
                                   "pc_spike_block": 3,
                                   "pc_factor_shift_type": "nonzero",
                                   "pc_factor_shift_amount": 0.5}),
    "cholesky_shift": ("cholesky", {"pc_cholesky_block": 3,
                                    "pc_factor_shift_type": "nonzero"}),
    "lu_shift": ("lu", {"pc_lu_block": 3,
                        "pc_factor_shift_type": "nonzero"}),
    "lu_method_lu": ("lu", {"pc_lu_block": 3, "pc_lu_method": "lu",
                            "pc_factor_shift_type": "nonzero"}),
    "bjacobi_lu": ("bjacobi", {"pc_bjacobi_blocks": 4,
                               "pc_bjacobi_block": 4,
                               "pc_bjacobi_method": "lu"}),
    "spike_newton_pan": ("spike", {"pc_spike_partitions": 4,
                                   "pc_spike_block": 4,
                                   "pc_spike_inverter": "newton_pan",
                                   "pc_factor_shift_type": "nonzero"}),
}


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_pc_options_match_jax(zerodiag, case):
    """Each PC on the zero-diagonal matrix: the same ``describe`` line
    (``shifted_pivots`` included) and the same apply as JAX's."""
    from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
    from spike_petsc_tpu.utils.options import Options as JOptions
    from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc
    from spike_petsc_tpu_torch.utils.options import Options as TOptions
    data, kl, ku = zerodiag
    name, opts = PC_CASES[case]
    pj = j_make_pc(name, JBand(jnp.asarray(data), kl, ku),
                   JOptions(dict(opts)))
    pt = t_make_pc(name, banded_from_numpy(data, kl, ku, device=CPU),
                   TOptions(dict(opts)))
    assert pt.describe() == pj.describe()
    if "pc_factor_shift_type" in opts:
        assert pt.info["shifted_pivots"] > 0
    r = np.random.default_rng(3).standard_normal(ZN)
    got = pt.apply(torch.from_numpy(r)).numpy()
    ref = j2n(pj.apply(jnp.asarray(r)))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_pc_check_still_raises(zerodiag):
    """``-pc_<name>_check`` (once refused here): the shifted factor of the
    zero-diagonal matrix reports JAX's health code in ``info["health"]``;
    unshifted, with the ``lapack`` inverter, its singular pivots raise
    ``FloatingPointError`` in both packages."""
    from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
    from spike_petsc_tpu.utils.options import Options as JOptions
    from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc
    from spike_petsc_tpu_torch.utils.options import Options as TOptions
    data, kl, ku = zerodiag
    tb = banded_from_numpy(data, kl, ku, device=CPU)
    jb = JBand(jnp.asarray(data), kl, ku)
    shifted = {"pc_spike_check": 1, "pc_factor_shift_type": "nonzero"}
    pt = t_make_pc("spike", tb, TOptions(dict(shifted)))
    pj = j_make_pc("spike", jb, JOptions(dict(shifted)))
    assert pt.info["health"] == pj.info["health"] == 0
    bare = {"pc_spike_check": 1, "pc_spike_inverter": "lapack"}
    with pytest.raises(FloatingPointError, match="singular Schur pivots"):
        j_make_pc("spike", jb, JOptions(dict(bare)))
    with pytest.raises(FloatingPointError, match="singular Schur pivots"):
        t_make_pc("spike", tb, TOptions(dict(bare)))


@pytest.mark.parametrize("method", ["lu", "cr"])
def test_kernel_impls_refuse_lu_and_cr_factors(grouped_band, method):
    """No kernel takes ``lu`` or CR partition factors: the kernel impl
    names raise ``ValueError`` (as JAX's ``_require_inv_factors``), on any
    device; 'auto' on a CPU tensor runs the plain sweeps."""
    st = tsp.spike_factor(banded_from_numpy(grouped_band, 3, 3, device=CPU),
                          GK, block_b=GB, method=method)
    rhs = torch.from_numpy(np.random.default_rng(8).standard_normal(GN))
    assert tsp.sweep_route(st.fact, GB, torch.float32, True) == "plain"
    for impl in ("cuda", "pallas", "pallas_fused"):
        with pytest.raises(ValueError, match="requires method"):
            tsp.spike_solve(st, rhs, impl=impl)
    with pytest.raises(ValueError, match="requires method"):
        tsp.spike_solve_many(st, rhs[:, None], impl="pallas")
    np.testing.assert_allclose(tsp.spike_solve(st, rhs).numpy(),
                               tsp.spike_solve(st, rhs, impl="xla").numpy())

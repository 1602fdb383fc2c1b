"""PyTorch port, complex scalars through the band, SPIKE and Krylov stack,
against the JAX package (``tests/test_complex.py``'s cases but the
distributed one, on the same seeds and tolerances) and beyond it: the A^T
types (bicg, cgne, lsqr) on conjugated transposes, complex Hermitian
``spd`` factors, their transpose and the ``cholesky`` PC, the batched
engines, and the transpose-free types JAX's file does not name.

f64 (complex128) on the CPU.  Iteration counts and reasons equal JAX's;
histories within rtol 1e-8 (an absolute floor of 1e-12 of the first
entry); histories real; solutions within JAX's test's tolerances of the
exact answer and within 1e-8 of JAX's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.solvers import krylov as jkr
from spike_petsc_tpu.solvers import krylov_many as jkm
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.solvers import krylov as tkr
from spike_petsc_tpu_torch.solvers import krylov_many as tkm

from torch_parity import CPU


def _complex_banded(n, k, seed=0, hermitian=False):
    """JAX's tests/test_complex.py matrix: N(0,1) + i N(0,1) entries in the
    band, the diagonal the row's absolute sum + 1."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.complex128)
    for i in range(n):
        lo, hi = max(0, i - k), min(n, i + k + 1)
        a[i, lo:hi] = rng.standard_normal(hi - lo) + \
            1j * rng.standard_normal(hi - lo)
    if hermitian:
        a = 0.5 * (a + a.conj().T)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
    return a


def _data_of(a, k):
    n = a.shape[0]
    data = np.zeros((n, 2 * k + 1), dtype=a.dtype)
    for d in range(-k, k + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        data[rows, d + k] = a[rows, rows + d]
    return data


def _bands(a, k):
    data = _data_of(a, k)
    return (JBand(jnp.asarray(data), k, k),
            banded_from_numpy(data, k, k, device=CPU))


def _crandn(n, seed_re, seed_im=None):
    if seed_im is None:
        rng = np.random.default_rng(seed_re)
        return rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (np.random.default_rng(seed_re).standard_normal(n)
            + 1j * np.random.default_rng(seed_im).standard_normal(n))


def _same(rt, rj, x_atol=1e-8, hist_its=None):
    """Counts and reasons equal, the history real and within rtol 1e-8 (its
    first ``hist_its + 1`` entries where given), x within ``x_atol`` of
    JAX's."""
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    assert rt.history.dtype == torch.float64
    its = rt.its if hist_its is None else hist_its
    hj = np.asarray(rj.history)[:its + 1]
    np.testing.assert_allclose(rt.history.numpy()[:its + 1], hj, rtol=1e-8,
                               atol=1e-12 * np.nanmax(np.abs(hj)))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=x_atol)


def test_complex_banded_matvec():
    n, k = 50, 3
    a = _complex_banded(n, k, seed=1)
    jb, tb = _bands(a, k)
    x = _crandn(n, 0, 1)
    y = t_mv(tb, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, a @ x, rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(j_mv(jb, jnp.asarray(x))),
                               rtol=1e-12)


def test_complex_spike_direct_solve():
    n, k = 300, 4
    a = _complex_banded(n, k, seed=2)
    jb, tb = _bands(a, k)
    st = tsp.spike_factor(tb, K=4, block_b=8)
    sj = jsp.spike_factor(jb, K=4, block_b=8)
    u = _crandn(n, 3)
    x = tsp.spike_solve(st, torch.from_numpy(a @ u)).numpy()
    np.testing.assert_allclose(x, u, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(
        x, np.asarray(jsp.spike_solve(sj, jnp.asarray(a @ u))), atol=1e-12)


def test_complex_gmres_with_spike_pc():
    n, k = 200, 3
    a = _complex_banded(n, k, seed=4)
    jb, tb = _bands(a, k)
    st = tsp.spike_factor(tb, K=4, block_b=8)
    sj = jsp.spike_factor(jb, K=4, block_b=8)
    u = _crandn(n, 5)
    b = a @ u
    rt = tkr.gmres(lambda v: t_mv(tb, v), torch.from_numpy(b), None,
                   lambda v: tsp.spike_solve(st, v), rtol=1e-12, maxit=50)
    rj = jkr.gmres(lambda v: j_mv(jb, v), jnp.asarray(b), None,
                   lambda v: jsp.spike_solve(sj, v), rtol=1e-12, maxit=50)
    assert rt.reason > 0 and rt.its <= 3
    np.testing.assert_allclose(rt.x.numpy(), u, rtol=1e-8, atol=1e-9)
    assert rt.history.numpy().dtype.kind == "f"   # the history stays real
    _same(rt, rj)


def test_complex_gmres_unpreconditioned_matches_scipy():
    import scipy.sparse.linalg as spla
    n, k = 120, 2
    a = _complex_banded(n, k, seed=6)
    jb, tb = _bands(a, k)
    b = _crandn(n, 7)
    rt = tkr.gmres(lambda v: t_mv(tb, v), torch.from_numpy(b), None, None,
                   rtol=1e-10, restart=30, maxit=500)
    rj = jkr.gmres(lambda v: j_mv(jb, v), jnp.asarray(b), None, None,
                   rtol=1e-10, restart=30, maxit=500)
    x_sp, info = spla.gmres(sp.csr_matrix(a), b, rtol=1e-10, restart=30,
                            maxiter=500)
    assert info == 0 and rt.reason > 0
    np.testing.assert_allclose(rt.x.numpy(), x_sp, rtol=1e-6, atol=1e-8)
    _same(rt, rj)


def test_complex_cg_hermitian():
    n, k = 150, 2
    a = _complex_banded(n, k, seed=8, hermitian=True)
    jb, tb = _bands(a, k)
    u = _crandn(n, 9)
    rt = tkr.cg(lambda v: t_mv(tb, v), torch.from_numpy(a @ u), None, None,
                rtol=1e-11, maxit=500)
    rj = jkr.cg(lambda v: j_mv(jb, v), jnp.asarray(a @ u), None, None,
                rtol=1e-11, maxit=500)
    assert rt.reason > 0
    np.testing.assert_allclose(rt.x.numpy(), u, rtol=1e-7, atol=1e-8)
    _same(rt, rj)


def test_complex_bicgstab():
    n, k = 150, 2
    a = _complex_banded(n, k, seed=10)
    jb, tb = _bands(a, k)
    u = _crandn(n, 11)
    rt = tkr.bicgstab(lambda v: t_mv(tb, v), torch.from_numpy(a @ u), None,
                      None, rtol=1e-11, maxit=500)
    rj = jkr.bicgstab(lambda v: j_mv(jb, v), jnp.asarray(a @ u), None,
                      None, rtol=1e-11, maxit=500)
    assert rt.reason > 0
    np.testing.assert_allclose(rt.x.numpy(), u, rtol=1e-6, atol=1e-7)
    _same(rt, rj)


@pytest.mark.parametrize("name", ["cgnr", "lsqr", "cgs", "tfqmr", "gcr",
                                  "bicg"])
def test_complex_new_ksps(name):
    """JAX's case (conjugation wrapping in the normal-equations methods,
    complex rho/omega algebra in the transpose-free ones, the conjugated
    Gram row in GCR), and bicg on the same pure transpose.  cgnr and lsqr
    square the conditioning: their histories agree with JAX's to 1e-15
    for 20 iterations, after which both packages' rounding grows to 1e-1
    relative by the end (~40 its, n = 60); counts, reasons and x are held
    in full, the histories over those 20 iterations."""
    n, k = 60, 2
    a = _complex_banded(n, k, seed=7)
    jb, tb = _bands(a, k)
    jbt, tbt = _bands(a.T.copy(), k)
    xe = _crandn(n, 3, 4)
    b = a @ xe
    kw_t, kw_j = {}, {}
    if name in ("cgnr", "lsqr", "bicg"):
        kw_t["matvec_transpose"] = lambda y: t_mv(tbt, y)
        kw_j["matvec_transpose"] = lambda y: j_mv(jbt, y)
    rt = getattr(tkr, name)(lambda x: t_mv(tb, x), torch.from_numpy(b),
                            rtol=1e-11, maxit=800, **kw_t)
    rj = getattr(jkr, name)(lambda x: j_mv(jb, x), jnp.asarray(b),
                            rtol=1e-11, maxit=800, **kw_j)
    assert rt.reason > 0, (name, rt.reason)
    assert np.linalg.norm(rt.x.numpy() - xe) < 1e-6, name
    _same(rt, rj, x_atol=1e-7,
          hist_its=20 if name in ("cgnr", "lsqr") else None)


def test_complex_batched_bicgstab_many():
    n, k = 64, 2
    a = _complex_banded(n, k, seed=9)
    jb, tb = _bands(a, k)
    rng = np.random.default_rng(5)
    U = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    B = a @ U
    mv_j = jax.vmap(lambda x: j_mv(jb, x), in_axes=1, out_axes=1)
    rj = jkm.bicgstab_many(mv_j, jnp.asarray(B), rtol=1e-11, maxit=400)
    rt = tkm.bicgstab_many(lambda X: t_mv(tb, X), torch.from_numpy(B),
                           rtol=1e-11, maxit=400)
    assert (rt.reason > 0).all()
    np.testing.assert_allclose(rt.x.numpy(), U, rtol=1e-6, atol=1e-7)
    assert rt.its.tolist() == np.asarray(rj.its).tolist()
    assert rt.reason.tolist() == np.asarray(rj.reason).tolist()
    assert rt.history.dtype == torch.float64
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


@pytest.mark.parametrize("name", ["gmres_many", "cg_many",
                                  "richardson_many"])
def test_complex_other_engines_match_jax(name):
    """The other batched engines on complex columns (cg on the Hermitian
    band), with a Jacobi PC: per-column counts, reasons and x."""
    n, k = 64, 2
    a = _complex_banded(n, k, seed=12, hermitian=name == "cg_many")
    jb, tb = _bands(a, k)
    rng = np.random.default_rng(13)
    B = a @ (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3)))
    dg = np.diag(a)[:, None].copy()
    mv_j = jax.vmap(lambda x: j_mv(jb, x), in_axes=1, out_axes=1)
    kw = dict(rtol=1e-10, maxit=300)
    rj = getattr(jkm, name)(mv_j, jnp.asarray(B),
                            pc_apply=lambda X: X / jnp.asarray(dg), **kw)
    rt = getattr(tkm, name)(lambda X: t_mv(tb, X), torch.from_numpy(B),
                            pc_apply=lambda X: X / torch.from_numpy(dg),
                            **kw)
    assert rt.its.tolist() == np.asarray(rj.its).tolist()
    assert rt.reason.tolist() == np.asarray(rj.reason).tolist()
    assert (rt.reason > 0).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


GENERAL = ("fgmres", "lgmres", "bcgsl", "chebyshev", "richardson")
HERMITIAN = ("pipecg", "cr", "minres", "symmlq")


@pytest.mark.parametrize("name", GENERAL + HERMITIAN)
def test_complex_remaining_types_match_jax(name):
    """Every other single-RHS type on complex scalars (the Hermitian band
    for the symmetric ones), with a Jacobi PC, against JAX."""
    n, k = 80, 2
    a = _complex_banded(n, k, seed=14, hermitian=name in HERMITIAN)
    jb, tb = _bands(a, k)
    b = a @ _crandn(n, 15)
    dg = np.diag(a).copy()
    kw = dict(rtol=1e-10, maxit=400)
    if name == "chebyshev":
        kw.update(emin=0.2, emax=1.8)
    rt = getattr(tkr, name)(lambda v: t_mv(tb, v), torch.from_numpy(b), None,
                            lambda v: v / torch.from_numpy(dg), **kw)
    rj = getattr(jkr, name)(lambda v: j_mv(jb, v), jnp.asarray(b), None,
                            lambda v: v / jnp.asarray(dg), **kw)
    assert rt.reason > 0, (name, rt.reason)
    _same(rt, rj, x_atol=1e-7)


@pytest.mark.parametrize("ksp,pc", [("gmres", "spike"), ("bicg", "spike"),
                                    ("cgne", "spike"), ("lsqr", "none"),
                                    ("cg", "cholesky")])
def test_complex_solve_through_ksp(ksp, pc):
    """``solve`` on a complex band (the roadmap's F5 reproduction: gmres +
    spike once raised a ``KeyError``): the A^T types take the spike PC's
    transpose, cg the cholesky PC on the Hermitian band."""
    n, k = 400, 3
    a = _complex_banded(n, k, seed=16, hermitian=pc == "cholesky")
    jb, tb = _bands(a, k)
    b = a @ _crandn(n, 17)
    opts = {f"pc_{pc}_partitions": 4, f"pc_{pc}_block": 8}
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type=ksp, pc_type=pc,
                    rtol=1e-10, maxit=200, options=jpkg.Options(dict(opts)))
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type=ksp, pc_type=pc,
                    rtol=1e-10, maxit=200, options=tpkg.Options(dict(opts)))
    assert rt.reason > 0
    _same(rt, rj)


def test_complex_hermitian_spd_factor_solve_transpose():
    """Complex Hermitian ``spd`` SPIKE (exact and truncated reduced
    systems): tips, spikes and solves against JAX, the solve against the
    dense answer, and the transpose solve A^T x = r."""
    n, k = 512, 3
    a = _complex_banded(n, k, seed=18, hermitian=True)
    jb, tb = _bands(a, k)
    r = _crandn(n, 19)
    for truncated in (False, True):
        st = tsp.spike_factor(tb, K=4, block_b=8, method="spd",
                              truncated=truncated, store_spikes=True)
        sj = jsp.spike_factor(jb, K=4, block_b=8, method="spd",
                              truncated=truncated, store_spikes=True)
        np.testing.assert_allclose(st.fact.Sinv.numpy(),
                                   np.asarray(sj.fact.Sinv), atol=1e-12)
        np.testing.assert_allclose(st.V.numpy(), np.asarray(sj.V),
                                   atol=1e-12)
        x = tsp.spike_solve(st, torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(
            x, np.asarray(jsp.spike_solve(sj, jnp.asarray(r))), atol=1e-12)
        if not truncated:
            np.testing.assert_allclose(a @ x, r, atol=1e-9)
            xt = tsp.spike_solve(tsp.spike_transpose(st),
                                 torch.from_numpy(r)).numpy()
            np.testing.assert_allclose(a.T @ xt, r, atol=1e-9)


def test_complex_arnoldi_estimate_matches_jax():
    """The Arnoldi Ritz values of a complex operator (a complex
    Hessenberg on the host)."""
    n, k = 100, 2
    a = _complex_banded(n, k, seed=20)
    jb, tb = _bands(a, k)
    v0 = _crandn(n, 21)
    et = tkr.estimate_extreme_eigs(lambda v: t_mv(tb, v), n,
                                   torch.complex128, m=8,
                                   v0=torch.from_numpy(v0))
    ej = jkr.estimate_extreme_eigs(lambda v: j_mv(jb, v), n, jnp.complex128,
                                   m=8, v0=jnp.asarray(v0))
    np.testing.assert_allclose(np.sort_complex(et), np.sort_complex(ej),
                               rtol=1e-10)


def test_complex_spd_takes_the_plain_sweep_on_the_card():
    """``sweep_route`` (a pure function): on a CUDA right-hand side a real
    ``spd`` factor takes its fused kernel (#3, #5), a complex Hermitian
    one the plain sweep, as JAX's ``fused_sweep_feasible`` routes it; a
    complex ``inv`` factor is refused by #1's and #9's rules."""
    n, k = 512, 3
    a = _complex_banded(n, k, seed=22, hermitian=True)
    _, tb = _bands(a, k)
    st = tsp.spike_factor(tb, K=4, block_b=64, method="spd")
    si = tsp.spike_factor(tb, K=4, block_b=64)
    for many in (False, True):
        assert tsp.sweep_route(st.fact, 64, torch.complex64, True,
                               many=many) == "plain"
        assert tsp.sweep_route(si.fact, 64, torch.complex64, True,
                               many=many) == "plain"
    real = tsp.spike_factor(banded_from_numpy(_data_of(a.real.copy(), k), k,
                                              k, device=CPU), K=4,
                            block_b=64, method="spd")
    assert tsp.sweep_route(real.fact, 64, torch.float32, True) == "fused"

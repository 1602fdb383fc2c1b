"""PyTorch port, block-tridiagonal conversion, factorization, inverses and
sweeps, against the JAX package.

Tolerances: 1e-10 in f64 (the same algebra in another summation order);
the plain sweep against the fused Pallas kernel (interpret mode) at rtol
1e-5 in f32, and for bf16-stored factors at 1e-5 relative to ||x|| (both
promote the stored blocks to f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.pallas.fused_sweep import blocktri_solve_fused_pallas
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_factor_from_numpy)
from spike_petsc_tpu_torch.ops import blocktri as tbt
from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs

from torch_parity import CPU, j2n, jax_factor_to_numpy, random_band, t2n

ATOL = 1e-10


def _blocks(nb, b, seed, K=None):
    """Diagonally dominant random blocks (numpy), optional leading K."""
    rng = np.random.default_rng(seed)
    lead = () if K is None else (K,)
    D = rng.uniform(size=lead + (nb, b, b)) + 2.0 * b * np.eye(b)
    L = rng.uniform(size=lead + (nb, b, b))
    U = rng.uniform(size=lead + (nb, b, b))
    L[..., 0, :, :] = 0
    U[..., nb - 1, :, :] = 0
    return D, L, U


def _jax_factor(D, L, U, inverter="auto"):
    T = jbt.BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L),
                             U=jnp.asarray(U))
    if D.ndim == 4:
        return jax.vmap(lambda t: jbt.blocktri_factor(
            t, method="inv", inverter=inverter))(T)
    return jbt.blocktri_factor(T, method="inv", inverter=inverter)


def _torch_factor(D, L, U, inverter="auto"):
    T = tbt.BlockTridiagonal(D=torch.from_numpy(D), L=torch.from_numpy(L),
                             U=torch.from_numpy(U))
    return tbt.blocktri_factor(T, method="inv", inverter=inverter)


@pytest.mark.parametrize("n,kl,ku,b", [(1000, 5, 7, 8), (64, 8, 8, 8),
                                       (333, 0, 16, 16)])
def test_band_to_blocktri_matches_jax(n, kl, ku, b):
    data = random_band(n, kl, ku, seed=n)
    ref = jbt.band_to_blocktri(JBand(jnp.asarray(data), kl, ku), b)
    got = tbt.band_to_blocktri(banded_from_numpy(data, kl, ku, device=CPU), b)
    for name in ("D", "L", "U"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    x = np.random.default_rng(1).standard_normal((got.nb, b))
    np.testing.assert_allclose(
        tbt.blocktri_matvec(got, torch.from_numpy(x)).numpy(),
        np.asarray(jbt.blocktri_matvec(ref, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("kl,ku,b", [(5, 7, 8), (16, 3, 16), (0, 0, 8)])
def test_skew_block_rows_matches_jax(kl, ku, b):
    X = np.random.default_rng(kl + ku).standard_normal((b, kl + ku + 1))
    ref = jbt._skew_block_rows(jnp.asarray(X), b, kl, ku)
    got = tbt._skew_block_rows(torch.from_numpy(X), b, kl, ku)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("nb", [1, 5])
def test_factor_inv_waux_band_matches_jax(nb):
    kl, ku, b, k = 6, 8, 16, 8
    data = random_band(nb * b, kl, ku, seed=nb)
    local = data.reshape(nb, b, kl + ku + 1)
    y0 = np.random.default_rng(2).standard_normal((b, k))
    fj, yj = jbt.blocktri_factor_inv_waux_band(
        jnp.asarray(local), jnp.asarray(y0), kl, ku, b,
        inverter="newton_fixed")
    ft, yt = tbt.blocktri_factor_inv_waux_band(
        torch.from_numpy(local), torch.from_numpy(y0), kl, ku, b,
        inverter="newton_fixed")
    for got, ref in zip((ft.F, ft.U, ft.Sinv, yt),
                        (fj.F, fj.U, fj.Sinv, yj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["newton_fixed", "newton", "blocked",
                                  "lapack"])
def test_inverters_match_jax(name):
    rng = np.random.default_rng(3)
    b = 48                                  # > blocked_inv's base of 32
    S = rng.uniform(-1, 1, (6, b, b)) + 2.0 * b * np.eye(b)
    ref = np.asarray(jbt.batched_inverse(jnp.asarray(S), name))
    got = tbt.batched_inverse(torch.from_numpy(S), name).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.max(np.abs(S @ got - np.eye(b))) < 1e-12


def test_inverter_auto_is_lapack_and_unknown_raises():
    S = torch.eye(4, dtype=torch.float64) * 3
    np.testing.assert_array_equal(tbt.batched_inverse(S).numpy(),
                                  np.eye(4) / 3)
    with pytest.raises(ValueError, match="unknown inverter"):
        tbt.batched_inverse(S, "nope")


@pytest.mark.parametrize("inverter", ["lapack", "newton_fixed"])
def test_blocktri_factor_and_solve_match_jax(inverter):
    D, L, U = _blocks(7, 8, seed=4)
    fj = _jax_factor(D, L, U, inverter)
    ft = _torch_factor(D, L, U, inverter)
    for name in ("F", "U", "Sinv"):
        np.testing.assert_allclose(getattr(ft, name).numpy(),
                                   np.asarray(getattr(fj, name)), atol=ATOL)
    rhs = np.random.default_rng(5).standard_normal((7, 8, 3))
    np.testing.assert_allclose(
        tbt.blocktri_solve(ft, torch.from_numpy(rhs)).numpy(),
        np.asarray(jbt.blocktri_solve(fj, jnp.asarray(rhs))), atol=ATOL)
    # method='lu' (once refused here): the same solve as JAX's lu factor
    flu = tbt.blocktri_factor(tbt.BlockTridiagonal(
        D=torch.from_numpy(D), L=torch.from_numpy(L),
        U=torch.from_numpy(U)), method="lu")
    fjlu = jbt.blocktri_factor(jbt.BlockTridiagonal(
        D=jnp.asarray(D), L=jnp.asarray(L), U=jnp.asarray(U)), method="lu")
    np.testing.assert_allclose(flu.Slu.numpy(), np.asarray(fjlu.Slu),
                               atol=ATOL)
    np.testing.assert_allclose(
        tbt.blocktri_solve(flu, torch.from_numpy(rhs)).numpy(),
        np.asarray(jbt.blocktri_solve(fjlu, jnp.asarray(rhs))), atol=ATOL)


def _sweep_case(K, nb, b, seed):
    fj = _jax_factor(*_blocks(nb, b, seed, K=K))
    rhs = np.random.default_rng(seed + 1).standard_normal((K, nb, b))
    return fj, rhs


@pytest.mark.parametrize("K,nb,b", [(4, 7, 8), (2, 1, 8), (2, 3, 16),
                                    (1, 6, 32)])
def test_plain_sweep_matches_fused_pallas_f64(K, nb, b):
    """f64 at 1e-10, including nb == 1 and nb < nbuf (4)."""
    fj, rhs = _sweep_case(K, nb, b, seed=K * nb)
    ref = np.asarray(blocktri_solve_fused_pallas(fj, jnp.asarray(rhs)))
    ft = blocktri_factor_from_numpy(*jax_factor_to_numpy(fj), device=CPU)
    got = cfs.blocktri_solve_fused_cuda(ft, torch.from_numpy(rhs))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_plain_sweep_matches_fused_pallas_low_precision(store):
    fj, rhs = _sweep_case(4, 5, 16, seed=11)
    fj = jbt.BlockTriFactor(F=fj.F.astype(jnp.float32),
                            U=fj.U.astype(jnp.float32),
                            Sinv=fj.Sinv.astype(jnp.float32), Slu=fj.Slu,
                            piv=fj.piv, method="inv")
    rhs = rhs.astype(np.float32)
    ft = blocktri_factor_from_numpy(*jax_factor_to_numpy(fj), device=CPU)
    if store == "bf16":
        fj = jbt.cast_factor(fj, jnp.bfloat16)
        ft = tbt.cast_factor(ft, torch.bfloat16)
        np.testing.assert_array_equal(t2n(ft.Sinv), j2n(fj.Sinv))
    ref = np.asarray(blocktri_solve_fused_pallas(fj, jnp.asarray(rhs)))
    got = cfs.blocktri_solve_fused_cuda(ft, torch.from_numpy(rhs))
    assert got.dtype == torch.float32
    scale = np.linalg.norm(ref) if store == "bf16" else np.abs(ref)
    np.testing.assert_array_less(np.abs(got.numpy() - ref),
                                 1e-5 * scale + 1e-30)


def test_fused_sweep_feasibility_rule():
    fact = blocktri_factor_from_numpy(*(np.zeros((2, 3, 128, 128),
                                                 np.float32),) * 3, device=CPU)
    assert cfs.fused_sweep_feasible(fact, 128)
    assert cfs.fused_sweep_feasible(tbt.cast_factor(fact, torch.bfloat16),
                                    128)
    assert not cfs.fused_sweep_feasible(fact, 128, torch.float64)
    assert not cfs.fused_sweep_feasible(
        blocktri_factor_from_numpy(*(np.zeros((2, 3, 32, 32)),) * 3,
                                   device=CPU), 32)
    big = blocktri_factor_from_numpy(*(np.zeros((1, 460, 128, 128),
                                                np.float32),) * 3, device=CPU)
    assert not cfs.fused_sweep_feasible(big, 128)      # y exceeds smem


"""PyTorch port, differentiable banded solves (``ops.autodiff``), against
the JAX package and a dense ``torch.autograd`` oracle.

JAX's three single-chip cases of ``tests/test_autodiff.py`` (the
distributed ones wait for the port's ``parallel/``) on the same matrices,
in f64 on the CPU, and the gradient dtypes of mixed f32-data / f64-rhs
runs.  Tolerance: gradients within rtol 1e-8, atol 1e-10 of JAX's
``jax.grad`` and of the dense oracle (``torch.linalg.solve`` on the dense
matrix), as JAX's test holds its own against ``jnp.linalg.solve``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.autodiff import solve_banded_diff as j_diff
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff as t_diff
from spike_petsc_tpu_torch.ops.band import banded_to_dense

from torch_parity import CPU

TOL = dict(rtol=1e-8, atol=1e-10)


def _setup(n=60, k=2, seed=0):
    """JAX's test's problem: ``nonsym_banded(n, k, k, seed)`` and a seeded
    right-hand side."""
    a = problems.nonsym_banded(n, k, k, seed=seed)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    rhs = np.random.default_rng(1).standard_normal(n)
    return np.asarray(data), kl, ku, rhs


def _leaves(data, rhs, dtype=torch.float64, rhs_dtype=None):
    d = torch.tensor(data, dtype=dtype, requires_grad=True)
    b = torch.tensor(rhs, dtype=rhs_dtype or dtype, requires_grad=True)
    return d, b


def _sin_loss(x):
    return (torch.sin(x) * x).sum()


def test_gradients_match_dense_oracle():
    data, kl, ku, rhs = _setup()
    d, b = _leaves(data, rhs)
    gd, gb = torch.autograd.grad(_sin_loss(t_diff(d, b, kl, ku, 1)), (d, b))

    # the oracle: torch.autograd through a dense solve of the same band
    d2, b2 = _leaves(data, rhs)
    from spike_petsc_tpu_torch.ops.band import BandedMatrix
    a = banded_to_dense(BandedMatrix(data=d2, kl=kl, ku=ku))
    gd_ref, gb_ref = torch.autograd.grad(
        _sin_loss(torch.linalg.solve(a, b2)), (d2, b2))
    # the dense oracle has gradient in the out-of-range slots too; the band
    # storage's are zero there in both packages
    n, w = data.shape
    col = np.arange(n)[:, None] + np.arange(w)[None, :] - kl
    inside = torch.from_numpy((col >= 0) & (col < n))
    np.testing.assert_allclose(gb.numpy(), gb_ref.numpy(), **TOL)
    np.testing.assert_allclose(gd.numpy(), torch.where(
        inside, gd_ref, 0.0).numpy(), **TOL)

    gd_j, gb_j = jax.grad(
        lambda dd, bb: jnp.sum(jnp.sin(x := j_diff(dd, bb, kl, ku, 1)) * x),
        argnums=(0, 1))(jnp.asarray(data), jnp.asarray(rhs))
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), **TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(gd_j), **TOL)


@pytest.mark.parametrize("K", [1, 4])
def test_gradients_multi_partition(K):
    """K = 1 against K = 4 (the transpose spikes and reduced system in the
    backward), each against JAX's at the same K."""
    data, kl, ku, rhs = _setup(n=96, k=2, seed=3)

    def grads(K):
        d, b = _leaves(data, rhs)
        return torch.autograd.grad(
            (t_diff(d, b, kl, ku, K) ** 2).sum(), (d, b))

    g1, gK = grads(1), grads(K)
    for a, r in zip(gK, g1):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL)
    gj = jax.grad(lambda dd, bb: jnp.sum(j_diff(dd, bb, kl, ku, K) ** 2),
                  argnums=(0, 1))(jnp.asarray(data), jnp.asarray(rhs))
    for a, r in zip(gK, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_jit_grad_composes():
    """JAX's case is ``jit(grad(...))``; the port has no jit, so: a
    gradient through two chained solves (x = A^-1 b, y = A^-1 x, K = 2) is
    finite and matches JAX's."""
    data, kl, ku, rhs = _setup(n=48, k=1, seed=5)
    d, b = _leaves(data, rhs)
    y = t_diff(d, t_diff(d, b, kl, ku, 2), kl, ku, 2)
    gd, gb = torch.autograd.grad(y.sum(), (d, b))
    assert torch.isfinite(gd).all() and torch.isfinite(gb).all()
    gd_j, gb_j = jax.jit(jax.grad(
        lambda dd, bb: jnp.sum(j_diff(dd, j_diff(dd, bb, kl, ku, 2), kl, ku,
                                      2)), argnums=(0, 1)))(
        jnp.asarray(data), jnp.asarray(rhs))
    np.testing.assert_allclose(gd.numpy(), np.asarray(gd_j), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), **TOL)


def test_mixed_dtypes_keep_the_primal_dtypes():
    """f32 data and an f64 right-hand side: the data gradient comes back
    f32 (the primal data dtype) and the rhs gradient f64, as JAX gives
    them, and within f32 rounding of JAX's values."""
    data, kl, ku, rhs = _setup(n=64, k=2, seed=7)
    d, b = _leaves(data, rhs, dtype=torch.float32, rhs_dtype=torch.float64)
    x = t_diff(d, b, kl, ku, 2)
    gd, gb = torch.autograd.grad(_sin_loss(x), (d, b))
    gd_j, gb_j = jax.grad(
        lambda dd, bb: jnp.sum(jnp.sin(xx := j_diff(dd, bb, kl, ku, 2)) * xx),
        argnums=(0, 1))(jnp.asarray(data, jnp.float32), jnp.asarray(rhs))
    assert gd.dtype == torch.float32 and gd_j.dtype == jnp.float32
    assert gb.dtype == torch.float64 and gb_j.dtype == jnp.float64
    np.testing.assert_allclose(gd.numpy(), np.asarray(gd_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), rtol=1e-4,
                               atol=1e-5)


def test_band_from_numpy_leaf_takes_gradients():
    """A band made by ``convert.banded_from_numpy`` (the port's usual
    entry) differentiates once its data is a leaf that requires grad."""
    data, kl, ku, rhs = _setup(n=40, k=1, seed=9)
    band = banded_from_numpy(data, kl, ku, device=CPU)
    d = band.data.clone().requires_grad_(True)
    x = t_diff(d, torch.from_numpy(rhs), kl, ku, 1)
    (gd,) = torch.autograd.grad(x.sum(), (d,))
    assert gd.shape == d.shape and torch.isfinite(gd).all()

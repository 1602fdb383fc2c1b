"""PyTorch port, ``models.problems.blocktri_diagdom_device`` (the flagship
class assembled in block-tridiagonal layout on the device) against the JAX
package, on the CPU.

A torch generator cannot reproduce ``jax.random``'s bits, so the port
splits the generator in two: the draws (three ``torch.rand`` calls) and
``_assemble_diagdom``, JAX's assembly written line for line.  Fed JAX's own
draws (made here), the assembly equals JAX's output: every masked entry,
zero and padding row to the bit; the diagonal, a sum of 3b magnitudes
whose rounding depends on the summation order (XLA's CPU reduction and
torch's add in another order), within 4 ulps of JAX's.  The torch draws are
held by their statistics and by JAX's structural test
(tests/test_blocktri_native.py), and ``spike_factor_blocks`` on them
solves to 1e-10 in f64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spike_petsc_tpu.models import problems as jproblems
from spike_petsc_tpu_torch.models import problems
from spike_petsc_tpu_torch.ops.band import banded_matvec
from spike_petsc_tpu_torch.ops.blocktri import (blocktri_matvec,
                                                blocktri_to_band)
from spike_petsc_tpu_torch.ops.spike import spike_factor_blocks, spike_solve

from torch_parity import CPU

DIAG_ULPS = 4


def _jax_draws(NB, b, seed, dtype):
    """JAX's three draws, as its generator makes them."""
    key = jax.random.PRNGKey(seed)
    return [np.array(jax.random.uniform(k, (NB, b, b), jnp.dtype(dtype),
                                        minval=-1.0, maxval=1.0))
            for k in jax.random.split(key, 3)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,kl,ku,K,b", [(1000, 3, 2, 8, 8),
                                         (777, 5, 7, 4, 16),
                                         (512, 16, 16, 2, 16)])
def test_assembly_from_jax_draws_matches_jax(n, kl, ku, K, b, dtype):
    jT, npad = jproblems.blocktri_diagdom_device(n, kl, ku, K, b, seed=3,
                                                 dtype=dtype)
    NB = npad // b
    D, L, U = (torch.as_tensor(a) for a in _jax_draws(NB, b, 3, dtype))
    T = problems._assemble_diagdom(D, L, U, n, kl, ku, b)
    assert T.nb == NB and T.D.dtype == getattr(torch, dtype)
    for got, ref in ((T.L, jT.L), (T.U, jT.U)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    eye = np.eye(b, dtype=bool)
    off_t, off_j = T.D.numpy().copy(), np.asarray(jT.D).copy()
    dg_t, dg_j = off_t[:, eye], off_j[:, eye]
    off_t[:, eye] = off_j[:, eye] = 0
    assert np.array_equal(off_t, off_j)
    eps = np.finfo(dtype).eps
    assert np.all(np.abs(dg_t - dg_j) <= DIAG_ULPS * eps * np.abs(dg_j))
    # the padding rows' diagonal is exactly 1
    rows = np.arange(npad).reshape(NB, b)
    assert np.array_equal(dg_t[rows >= n], np.ones((rows >= n).sum()))


def test_torch_draws_statistics():
    """Three draws uniform on [-1, 1): mean ~ 0, variance ~ 1/3, and the
    three blocks drawn apart (no two equal)."""
    n, kl, ku, K, b = 4096, 8, 8, 4, 32
    T, npad = problems.blocktri_diagdom_device(n, kl, ku, K, b, seed=1,
                                               device=CPU)
    p = torch.arange(b)[:, None]
    q = torch.arange(b)[None, :]
    inner = T.D[:, (q - p <= ku) & (p - q <= kl) & (p != q)]
    assert float(inner.abs().max()) <= 1.0
    assert abs(float(inner.mean())) < 0.01
    assert abs(float(inner.var()) - 1 / 3) < 0.01
    assert not torch.equal(T.L[1:], T.U[:-1])
    T2, _ = problems.blocktri_diagdom_device(n, kl, ku, K, b, seed=1,
                                             device=CPU)
    assert torch.equal(T.D, T2.D)                     # seeded
    T3, _ = problems.blocktri_diagdom_device(n, kl, ku, K, b, seed=2,
                                             device=CPU)
    assert not torch.equal(T.D, T3.D)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("float64", 1e-10)])
def test_torch_draws_pass_jax_structural_test(dtype, tol):
    """JAX's tests/test_blocktri_native.py case on the torch draws: the
    derived band's matvec equals the blocks', the padding rows are the
    identity, and the native factor solves the system."""
    n, kl, ku, K, b = 1000, 3, 2, 8, 8
    T, npad = problems.blocktri_diagdom_device(n, kl, ku, K, b, seed=5,
                                               dtype=dtype, device=CPU)
    assert npad == T.nb * b and npad >= n
    band = blocktri_to_band(T, kl, ku)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(npad)).to(T.D.dtype)
    y_bt = blocktri_matvec(T, x.reshape(T.nb, b)).reshape(-1)
    y_bd = banded_matvec(band, x)
    torch.testing.assert_close(y_bt, y_bd, rtol=tol, atol=tol)
    assert torch.equal(y_bt[n:], x[n:])
    # strict row dominance on the true rows
    dense = torch.zeros(npad, npad, dtype=T.D.dtype)
    for i in range(T.nb):
        s = slice(i * b, (i + 1) * b)
        dense[s, s] = T.D[i]
        if i > 0:
            dense[s, (i - 1) * b:i * b] = T.L[i]
        if i < T.nb - 1:
            dense[s, (i + 1) * b:(i + 2) * b] = T.U[i]
    diag = dense.diagonal().abs()
    assert bool((2 * diag > dense.abs().sum(dim=1)).all())
    sf = spike_factor_blocks(T, n=n, K=K, kl=kl, ku=ku, store_spikes=True)
    u = torch.as_tensor(rng.standard_normal(npad)).to(T.D.dtype)
    u[n:] = 0
    rhs = blocktri_matvec(T, u.reshape(T.nb, b)).reshape(-1)
    xs = spike_solve(sf, rhs[:n])
    assert float(torch.linalg.norm(xs - u[:n]) / torch.linalg.norm(u[:n])) \
        < tol


def test_native_assembly_refuses_wide_bands():
    with pytest.raises(ValueError, match="must be <= b"):
        problems.blocktri_diagdom_device(100, 9, 2, 2, 8, device=CPU)

"""PyTorch port, the band helpers of ``ops/band.py`` (``banded_from_coo``,
``banded_shift``, ``banded_scale``, ``banded_axpy``, ``banded_bandwidth``,
``banded_from_numpy_dense``, ``extract_banded_device``) against the JAX
package's, the cases of ``tests/test_band.py:33-270``.

Inputs: numpy-seeded dense bands and COO triplets, handed to both packages
as numpy arrays, f64 on the CPU.  Tolerance: 1e-14 (the same sums; band
storage is a copy), bandwidths and k exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops import band as J
from spike_petsc_tpu_torch.ops import band as T

from torch_parity import CPU

ATOL = 1e-14


def random_banded_dense(n, kl, ku, seed=0):
    """``tests/test_band.py``'s dominant random band, as a dense matrix."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - kl), min(n, i + ku + 1)
        a[i, lo:hi] = rng.uniform(-1, 1, hi - lo)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
    return a


def _same(got: T.BandedMatrix, ref: J.BandedMatrix, atol=ATOL):
    assert (got.kl, got.ku) == (ref.kl, ref.ku)
    np.testing.assert_allclose(got.data.cpu().numpy(), np.asarray(ref.data),
                               atol=atol)


def _both_dense(a, kl, ku):
    return (T.banded_from_dense(torch.from_numpy(a), kl, ku),
            J.banded_from_dense(jnp.asarray(a), kl, ku))


@pytest.mark.parametrize("n,kl,ku,klx,kux", [(23, 2, 4, 2, 4),
                                             (12, 3, 3, 1, 1)])
def test_banded_from_coo(n, kl, ku, klx, kux):
    """All entries in band, and out-of-band entries dropped (klx, kux
    narrower than the matrix); numpy input on the CPU and a tensor input
    keeping its device."""
    a = random_banded_dense(n, kl, ku, seed=n)
    coo = sp.coo_matrix(a)
    ref = J.banded_from_coo(coo.row, coo.col, coo.data, n, klx, kux)
    got = T.banded_from_coo(coo.row, coo.col, coo.data, n, klx, kux,
                            device=CPU)
    _same(got, ref)
    np.testing.assert_allclose(T.banded_to_dense(got).numpy(),
                               np.triu(np.tril(a, kux), -klx), atol=ATOL)
    got_t = T.banded_from_coo(torch.from_numpy(coo.row),
                              torch.from_numpy(coo.col),
                              torch.from_numpy(coo.data), n, klx, kux)
    assert got_t.data.device == CPU
    _same(got_t, ref)


def test_banded_from_coo_sums_duplicates_and_casts():
    rows = np.array([0, 0, 1, 2, 2])
    cols = np.array([0, 0, 2, 1, 0])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    ref = J.banded_from_coo(rows, cols, vals, 3, 1, 1, dtype=jnp.float32)
    got = T.banded_from_coo(rows, cols, vals, 3, 1, 1, dtype=torch.float32,
                            device=CPU)
    assert got.dtype == torch.float32
    _same(got, ref)


def test_banded_shift_scale_axpy():
    a = random_banded_dense(15, 2, 3, seed=9)
    c = random_banded_dense(15, 1, 4, seed=10)
    ta, ja = _both_dense(a, 2, 3)
    tc, jc = _both_dense(c, 1, 4)
    _same(T.banded_shift(ta, 2.5), J.banded_shift(ja, 2.5))
    assert float(ta.data[0, 2]) == a[0, 0]          # no mutation
    _same(T.banded_scale(ta, -3.0), J.banded_scale(ja, -3.0))
    got = T.banded_axpy(ta, 0.5, tc)
    _same(got, J.banded_axpy(ja, 0.5, jc))
    np.testing.assert_allclose(T.banded_to_dense(got).numpy(), a + 0.5 * c,
                               atol=ATOL)
    with pytest.raises(ValueError, match="size mismatch"):
        T.banded_axpy(ta, 1.0, _both_dense(
            random_banded_dense(9, 1, 1), 1, 1)[0])


@pytest.mark.parametrize("tol", [0.0, 0.5])
def test_banded_bandwidth(tol):
    a = random_banded_dense(20, 3, 1, seed=2)
    ta, ja = _both_dense(a, 5, 5)                    # over-allocated band
    got = T.banded_bandwidth(ta, tol)
    ref = J.banded_bandwidth(ja, tol)
    assert tuple(int(v) for v in got) == tuple(int(v) for v in ref)
    if tol == 0.0:
        assert tuple(int(v) for v in got) == (3, 1)


def test_banded_from_numpy_dense():
    a = random_banded_dense(17, 2, 3, seed=4)
    got = T.banded_from_numpy_dense(a, 2, 3, device=CPU)
    _same(got, J.banded_from_numpy_dense(a, 2, 3))


@pytest.mark.parametrize("case", ["lap2d", "kmax_fallback"])
def test_extract_banded_device(case):
    if case == "lap2d":
        a, kmax, frac = problems.laplacian_2d(6, 6), 50, 0.95
    else:
        a, kmax, frac = (problems.general_sparse(200, seed=4,
                                                 band_heavy=False), 3,
                         0.9999)
    coo = a.tocoo()
    n = a.shape[0]
    bm, k, fr = T.extract_banded_device(coo.row, coo.col, coo.data, n=n,
                                        kmax=kmax, frac=frac, device=CPU)
    bj, kj, frj = J.extract_banded_device(
        jnp.asarray(coo.row), jnp.asarray(coo.col), jnp.asarray(coo.data),
        n=n, kmax=kmax, frac=frac)
    assert int(k) == int(kj)
    np.testing.assert_allclose(float(fr), float(frj), rtol=1e-12)
    _same(bm, bj)
    if case == "kmax_fallback":
        assert int(k) == 3


def test_helpers_exported():
    for name in ("banded_from_coo", "banded_shift", "banded_scale",
                 "banded_axpy", "banded_bandwidth",
                 "banded_from_numpy_dense", "extract_banded_device",
                 "spike_factor_grouped", "spike_factor_blocks"):
        assert name in tpkg.__all__ and hasattr(tpkg, name)

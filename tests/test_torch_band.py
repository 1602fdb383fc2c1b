"""PyTorch port, banded storage and matvec, against the JAX package.

Tolerances: rtol 1e-5 in f32 (different summation order over w <= 231
terms), 1e-12 in f64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_from_dense as j_from_dense
from spike_petsc_tpu.ops.band import banded_matvec as j_matvec
from spike_petsc_tpu.ops.band import pad_banded as j_pad
from spike_petsc_tpu.ops.pallas.band_matvec import (
    banded_matvec_prepared as j_prepared, prepare_banded_mv as j_prepare)
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.band import (BandedMatrix, banded_from_dense,
                                            banded_matvec, banded_to_dense,
                                            pad_banded)
from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
from spike_petsc_tpu_torch.solvers.operator import as_matvec

from torch_parity import CPU, random_band

SHAPES = [
    (1024, 6, 6),      # narrow symmetric
    (999, 1, 1),       # tridiagonal, ragged n
    (1500, 150, 80),   # kl != ku, w > 128
    (2000, 0, 3),      # upper only
    (4099, 20, 20),    # the slice test's band, ragged n
]
TOL = {np.float32: dict(rtol=1e-5), np.float64: dict(rtol=1e-12)}


def _atol(ref, dtype):
    return TOL[dtype]["rtol"] * np.max(np.abs(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,kl,ku", SHAPES)
def test_plain_matvec_matches_jax(n, kl, ku, dtype):
    data = random_band(n, kl, ku, seed=n, dtype=dtype, dominant=False)
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    ref = np.asarray(j_matvec(JBand(jnp.asarray(data), kl, ku),
                              jnp.asarray(x)))
    got = banded_matvec(banded_from_numpy(data, kl, ku, device=CPU),
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=_atol(ref, dtype),
                               **TOL[dtype])


@pytest.mark.parametrize("n,kl,ku", SHAPES)
def test_prepared_plain_matches_jax_kernel(n, kl, ku):
    """The kernel's plain version against the Pallas kernel (interpret
    mode), f32 as the JAX kernel takes it."""
    data = random_band(n, kl, ku, seed=n + 1, dtype=np.float32,
                       dominant=False)
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    ref = np.asarray(j_prepared(j_prepare(JBand(jnp.asarray(data), kl, ku)),
                                jnp.asarray(x)))
    prep = cbm.prepare_banded_mv(banded_from_numpy(data, kl, ku, device=CPU))
    got = cbm.banded_matvec_prepared(prep, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=_atol(ref, np.float32),
                               rtol=1e-5)


def test_prepared_layout_and_bf16_storage():
    n, kl, ku = 700, 9, 4
    data = random_band(n, kl, ku, seed=3, dtype=np.float32, dominant=False)
    band = banded_from_numpy(data, kl, ku, device=CPU)
    prep = cbm.prepare_banded_mv(band)
    assert prep.d3.shape == (kl + ku + 1, 704)
    np.testing.assert_array_equal(prep.d3[:, :n].numpy(), data.T)
    assert not prep.d3[:, n:].any()
    # bf16 storage is promoted to f32: equal to f32 math on the rounded band
    b16 = BandedMatrix(data=band.data.to(torch.bfloat16), kl=kl, ku=ku)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(n)
                         .astype(np.float32))
    ref = banded_matvec(BandedMatrix(data=b16.data.float(), kl=kl, ku=ku), x)
    got = cbm.banded_matvec_prepared(cbm.prepare_banded_mv(b16), x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("n,kl,ku", [(300, 4, 7), (257, 0, 0)])
def test_dense_roundtrip_and_padding_match_jax(n, kl, ku):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n))
    got = banded_from_dense(torch.from_numpy(a), kl, ku)
    ref = j_from_dense(jnp.asarray(a), kl, ku)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    dense = banded_to_dense(got).numpy()
    assert np.array_equal(np.triu(np.tril(a, ku), -kl), dense)
    np.testing.assert_array_equal(pad_banded(got, n + 13).data.numpy(),
                                  np.asarray(j_pad(ref, n + 13).data))


def test_operator_routes_on_cpu():
    data = random_band(600, 3, 3, seed=6)
    band = banded_from_numpy(data, 3, 3, device=CPU)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(600))
    mv, n, dtype = as_matvec(band)
    assert (mv._route, n, dtype) == ("xla", 600, torch.float64)
    ref = mv(x)
    for impl in ("banded_pallas", "banded_cuda"):
        mvk, _, _ = as_matvec(band, impl=impl)
        assert mvk._route == "banded_cuda_f64"          # the band is f64
        np.testing.assert_allclose(mvk(x).numpy(), ref.numpy(), rtol=1e-12)
    assert as_matvec(band, impl="xla")[0]._route == "xla"
    # blocktri: the plain version on the CPU (as the JAX package off the TPU)
    assert as_matvec(band, impl="blocktri")[0]._route == "xla"
    with pytest.raises(ValueError, match="unknown matvec impl"):
        as_matvec(band, impl="nope")


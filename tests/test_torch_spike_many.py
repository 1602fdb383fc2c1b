"""PyTorch port, multi-RHS SPIKE solve (``spike_solve_many``), against the
JAX package: its XLA path and its fused multi-RHS Pallas kernel in interpret
mode (the kernel the port's ``csrc/fused_sweep_many.cu`` replaces).

Tolerances: atol 1e-12 in f64 (the same algebra in another summation
order); 1e-6 relative in f32 with bf16 spikes (both promote the spikes to
f32); the f32 solve against the port's own f64 solve of the same factor at
relative error 1e-5 (f32 carried end to end).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.band import banded_matvec
from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor

from torch_parity import CPU, jax_spike_to_numpy, random_band

N, HW, K, B = 600, 5, 4, 8


@pytest.fixture(scope="module")
def band():
    return random_band(N, HW, HW, seed=21)


def _rhs(r, seed=22, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((N, r)).astype(dtype)


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("r", [1, 4, 6])
def test_spike_solve_many_matches_jax_xla_and_fused_pallas(band, store, r):
    sj = jsp.spike_factor(JBand(jnp.asarray(band), HW, HW), K=K, block_b=B,
                          store_spikes=store)
    st = tsp.spike_factor(banded_from_numpy(band, HW, HW,
                                            device=CPU), K=K, block_b=B,
                          store_spikes=store)
    rhs = _rhs(r)
    got = tsp.spike_solve_many(st, torch.from_numpy(rhs))
    assert got.shape == (N, r) and got.dtype == torch.float64
    for impl in ("xla", "pallas_fused"):
        ref = np.asarray(jsp.spike_solve_many(sj, jnp.asarray(rhs),
                                              impl=impl))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12,
                                   err_msg=impl)
    # the solution solves the system
    res = banded_matvec(banded_from_numpy(band, HW, HW, device=CPU), got) \
        - torch.from_numpy(rhs)
    assert float(res.abs().max()) < 1e-10


def test_spike_solve_many_on_jax_bf16_spike_factor(band):
    """Solve parity apart from factor parity: a JAX factor in f32 with bf16
    spikes, carried across, solved by both packages."""
    b32 = band.astype(np.float32)
    sj = jsp.spike_factor(JBand(jnp.asarray(b32), HW, HW), K=K, block_b=B,
                          store_spikes=True, spike_dtype=jnp.bfloat16)
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    assert st.V.dtype == torch.bfloat16 and st.fact.F.dtype == torch.float32
    rhs = _rhs(5, dtype=np.float32)
    got = tsp.spike_solve_many(st, torch.from_numpy(rhs))
    ref = np.asarray(jsp.spike_solve_many(sj, jnp.asarray(rhs), impl="xla"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("K_,store", [(1, False), (K, False), (K, True)])
def test_columns_equal_single_rhs_solves(band, K_, store):
    st = tsp.spike_factor(banded_from_numpy(band, HW, HW,
                                            device=CPU), K=K_, block_b=B,
                          store_spikes=store)
    rhs = torch.from_numpy(_rhs(3, seed=23))
    got = tsp.spike_solve_many(st, rhs)
    for j in range(3):
        np.testing.assert_allclose(got[:, j].numpy(),
                                   tsp.spike_solve(st, rhs[:, j]).numpy(),
                                   atol=1e-13, err_msg=f"column {j}")
    # impl="cuda" on a CPU tensor runs the kernel's plain version
    np.testing.assert_allclose(
        tsp.spike_solve_many(st, rhs, impl="cuda").numpy(), got.numpy(),
        atol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        tsp.spike_solve_many(st, rhs, impl="mosaic")


def test_multi_rhs_f32_solve_carries_f32(band):
    """The multi-RHS precision trap: with f32 factors and bf16 spikes, the
    f32 solve must match the port's own f64 solve of the same factor (the
    factor and spikes promoted exactly) to f32 level.  A carry rounded to
    bf16, as JAX's DEFAULT precision does on a TPU, misses by ~1e-3."""
    sf = tsp.spike_factor(banded_from_numpy(band.astype(np.float32), HW, HW,
                                            device=CPU),
                          K=K, block_b=B, store_spikes=True,
                          spike_dtype=torch.bfloat16)
    assert sf.fact.F.dtype == torch.float32 and sf.V.dtype == torch.bfloat16
    f = sf.fact
    sf64 = tsp.SpikeFactor(
        fact=BlockTriFactor(F=f.F.double(), U=f.U.double(),
                            Sinv=f.Sinv.double()),
        Btip=sf.Btip.double(), Ctip=sf.Ctip.double(),
        red_fact=BlockTriFactor(F=sf.red_fact.F.double(),
                                U=sf.red_fact.U.double(),
                                Sinv=sf.red_fact.Sinv.double()),
        V=sf.V.double(), W=sf.W.double(), n=sf.n, K=sf.K, m=sf.m, b=sf.b,
        k=sf.k)
    rhs = torch.from_numpy(_rhs(8, seed=24))
    x32 = tsp.spike_solve_many(sf, rhs.float())
    x64 = tsp.spike_solve_many(sf64, rhs)
    assert x32.dtype == torch.float32 and x64.dtype == torch.float64
    rel = float(torch.linalg.norm(x32.double() - x64) / torch.linalg.norm(x64))
    assert rel <= 1e-5, rel

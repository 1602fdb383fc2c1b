"""The chunked scan of the two-pass sweep kernels (``csrc/sweeps.cu``,
C > 1): its split written in plain PyTorch (``blocktri_solve_chunked_model``:
phase 1 a zero-carry sweep and a propagator per chunk, phase 2 the carry
chain, phase 3 the sweeps again from the carries) against the JAX two-pass
Pallas sweeps ``blocktri_solve_batched_pallas`` in interpret mode, on a JAX
factor carried across; on the Laplacian's ``lu`` factor (BASELINE config 1
at n = 1e4, b = 64) against the plain sweep; and the chunk plan
``sweeps_chunks``.

Tolerances: 1e-12 in f64; 1e-5 relative in f32 and with bf16-stored factors
(both promote them to f32; the split sums in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.blocktri import cast_factor as j_cast
from spike_petsc_tpu.ops.pallas.sweeps import blocktri_solve_batched_pallas
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_factor_from_numpy)
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve
from spike_petsc_tpu_torch.ops.cuda import sweeps as csw

from torch_parity import CPU, j2n, jax_factor_to_numpy, random_band, t2n

# (K, b, n): nb = 19 and 50 block rows a partition
SHAPES = {"K4_b16_nb19": (4, 16, 1200), "K2_b8_nb50": (2, 8, 800)}
TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": 1e-5}
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _case(shape, dtype):
    """The JAX factor (cast to ``dtype``) of a dominant random band, the
    port's copy of it, a right-hand side and the JAX two-pass solve."""
    K, b, n = SHAPES[shape]
    band = random_band(n, 6, 5, seed=41 + b)
    jf = jsp.spike_factor(JBand(jnp.asarray(band), 6, 5), K=K,
                          block_b=b).fact
    if dtype != "f64":
        jf = j_cast(jf, {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tf = blocktri_factor_from_numpy(*jax_factor_to_numpy(jf), device=CPU)
    nb = tf.F.shape[1]
    rhs = np.random.default_rng(42 + b).standard_normal((K, nb, b)).astype(
        np.float64 if dtype == "f64" else np.float32)
    ref = j2n(blocktri_solve_batched_pallas(jf, jnp.asarray(rhs)))
    return tf, rhs, ref


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_chunked_split_matches_jax_pallas(shape, dtype, chunks):
    """C = 1 is the sequential sweep; C = 2 has no chained step; 3 one; 7
    divides neither nb = 19 nor 50 (ragged chunks)."""
    tf, rhs, ref = _case(shape, dtype)
    got = csw.blocktri_solve_chunked_model(tf, torch.from_numpy(rhs), chunks)
    assert got.shape == rhs.shape
    assert got.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    err = np.abs(t2n(got) - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype]


@pytest.fixture(scope="module")
def laplacian_lu():
    """BASELINE config 1's factor at n = 1e4 (the ``lu`` PC's card block
    64: one partition of nb = 157) in f32, and a right-hand side."""
    n = 10_000
    band = banded_from_numpy(np.tile(np.float32([-1, 2, -1]), (n, 1)), 1, 1,
                             device=CPU)
    sf = tsp.spike_factor(band, K=1, block_b=64)
    assert (sf.K, sf.nb, sf.b) == (1, 157, 64)
    rhs = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (1, sf.nb, 64)).astype(np.float32))
    return sf.fact, rhs


@pytest.mark.parametrize("chunks", [2, 13, 39, 40])
def test_chunked_split_on_the_laplacian_lu_factor(laplacian_lu, chunks):
    """The propagators of the Laplacian's factor contract (the scalar LU
    pivots are (j + 1) / j), so the split keeps f32 accuracy; 39 chunks of
    4 or 5 rows, 40 of 3 or 4 (157 is prime: every C > 1 is ragged)."""
    fact, rhs = laplacian_lu
    assert fact.F.dtype == torch.float32
    ref = blocktri_solve(fact, rhs)
    got = csw.blocktri_solve_chunked_model(fact, rhs, chunks)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_chunk_plan_at_the_flagship_and_config_1():
    """K = 64 partitions fill the card: one block each (C = 1).  BASELINE
    config 1's one partition of 1563 rows spreads over the SMs."""
    assert csw.sweeps_chunks(64, 123, 128, H100_SMS) == 1
    C = csw.sweeps_chunks(1, 1563, 64, H100_SMS)
    assert 1 < C <= H100_SMS


@pytest.mark.parametrize("K,nb,b", [
    (1, 1563, 64), (1, 1563, 128), (2, 400, 64), (4, 400, 64),
    (1, 301, 128), (8, 977, 64), (1, 4, 64), (1, 9, 128), (132, 5000, 64)])
@pytest.mark.parametrize("sms", [132, 16])
def test_chunk_plan_covers_every_row(K, nb, b, sms):
    """Chunks cover nb exactly, none is empty, C <= nb, and K C blocks fit
    one an SM where C > 1."""
    C = csw.sweeps_chunks(K, nb, b, sms)
    assert 1 <= C <= nb
    assert C == 1 or K * C <= sms
    bounds = csw.sweeps_chunk_bounds(nb, C)
    assert bounds[0] == 0 and bounds[-1] == nb and len(bounds) == C + 1
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))


def test_chunk_plan_refuses_other_blocks():
    with pytest.raises(ValueError, match="no chunk plan"):
        csw.sweeps_chunks(1, 100, 32, H100_SMS)

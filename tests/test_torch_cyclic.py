"""PyTorch port, block cyclic reduction (``ops/cyclic.py``) and the SPIKE
paths on it, against the JAX package, block-Thomas and
scipy.linalg.solve_banded.

The cases of ``tests/test_cyclic.py``: CR against block-Thomas at
nb = 2^L - 1 and ragged nb, several right-hand sides, a batched partition
dimension, ``spike_factor(method='cr')`` against JAX and scipy, bf16 CR
blocks; and K = 300 under 'auto' (a CR reduced system, K - 1 >= 255) for
``spike_solve``, ``spike_solve_many`` and the transposed factor.

Inputs: numpy-seeded bands and blocks handed to both packages, f64 on the
CPU (JAX with x64 on, ``impl='xla'``).  Tolerances: f64 1e-10 (factor
blocks and solutions against JAX; against block-Thomas and scipy 1e-10
relative, the same algebra in another order); bf16 blocks 1e-5 relative
to JAX's bf16 solve (both promote the blocks to f32; the products' order
differs), and 5e-2 from the truth, the JAX test's bound.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import cyclic as jcr
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.ops.blocktri import (BlockTridiagonal as JBT,
                                          band_to_blocktri as j_b2t)
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import cyclic as tcr
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                band_to_blocktri,
                                                blocktri_factor,
                                                blocktri_matvec,
                                                blocktri_solve)

from torch_parity import (CPU, band_to_scipy, j2n, jax_spike_to_numpy,
                          random_band, t2n)

ATOL = 1e-10


def _blocks(nb, b, seed, kl=2, ku=2):
    """Port and JAX block-tridiagonal views of one dominant random band."""
    data = random_band(nb * b, kl, ku, seed=seed)
    t = band_to_blocktri(banded_from_numpy(data, kl, ku, device=CPU), b)
    tj = j_b2t(JBand(jnp.asarray(data), kl, ku), b)
    return t, tj


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(t2n(got), j2n(ref), atol=atol)


@pytest.mark.parametrize("nb,b", [(7, 4), (8, 4), (15, 8), (20, 4), (1, 4),
                                  (3, 8)])
def test_cr_matches_thomas_and_jax(nb, b):
    """CR against block-Thomas (lu) at nb = 2^L - 1 and ragged nb, and its
    levels and solve against JAX's."""
    t, tj = _blocks(nb, b, seed=nb)
    ft = tcr.cr_factor(t)
    fj = jcr.cr_factor(tj)
    assert (ft.nb, ft.n_pad, len(ft.levels)) == (fj.nb, fj.n_pad,
                                                  len(fj.levels))
    for lt, lj in zip(ft.levels, fj.levels):
        for name in ("Dinv_e", "P", "Q", "L_e", "U_e"):
            _close(getattr(lt, name), getattr(lj, name))
    _close(ft.root_Dinv, fj.root_Dinv)
    rhs = np.random.default_rng(0).standard_normal((nb, b))
    x = tcr.cr_solve(ft, torch.from_numpy(rhs))
    _close(x, jcr.cr_solve(fj, jnp.asarray(rhs)))
    thomas = blocktri_solve(blocktri_factor(t, method="lu"),
                            torch.from_numpy(rhs))
    np.testing.assert_allclose(x.numpy(), thomas.numpy(), rtol=ATOL,
                               atol=ATOL)


def test_cr_multi_rhs():
    t, tj = _blocks(10, 4, seed=3)
    rhs = np.random.default_rng(1).standard_normal((10, 4, 3))
    x = tcr.cr_solve(tcr.cr_factor(t), torch.from_numpy(rhs))
    np.testing.assert_allclose(blocktri_matvec(t, x).numpy(), rhs,
                               atol=ATOL)
    _close(x, jcr.cr_solve(jcr.cr_factor(tj), jnp.asarray(rhs)))


def test_cr_batched_partitions():
    """A leading partition dimension (the JAX package vmaps CR)."""
    import jax
    pairs = [_blocks(7, 4, seed=s, kl=1, ku=1) for s in (5, 6)]
    t = BlockTridiagonal(*(torch.stack([getattr(p[0], f) for p in pairs])
                           for f in ("D", "L", "U")))
    tj = JBT(*(jnp.stack([getattr(p[1], f) for p in pairs])
               for f in ("D", "L", "U")))
    rhs = np.random.default_rng(2).standard_normal((2, 7, 4))
    ft = tcr.cr_factor(t)
    xs = tcr.cr_solve(ft, torch.from_numpy(rhs))
    xj = jax.vmap(jcr.cr_solve)(jax.vmap(jcr.cr_factor)(tj),
                                jnp.asarray(rhs))
    _close(xs, xj)
    for i, (ti, _) in enumerate(pairs):
        ref = blocktri_solve(blocktri_factor(ti, method="lu"),
                             torch.from_numpy(rhs[i]))
        np.testing.assert_allclose(xs[i].numpy(), ref.numpy(), atol=ATOL)


N, KL, KU, B = 400, 3, 3, 8


@pytest.fixture(scope="module")
def band():
    return random_band(N, KL, KU, seed=9)


def test_spike_method_cr_matches_jax_and_scipy(band):
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), K=4, block_b=B,
                          method="cr")
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU), K=4,
                          block_b=B, method="cr")
    assert isinstance(st.fact, tcr.CRFactor)
    assert isinstance(st.red_fact, tcr.CRFactor)
    _close(st.fact.root_Dinv, sj.fact.root_Dinv)
    rhs = np.random.default_rng(2).standard_normal(N)
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    _close(x, jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    xs = sla.solve_banded((KL, KU), band_to_scipy(band, KL, KU), rhs)
    np.testing.assert_allclose(x.numpy(), xs, rtol=ATOL, atol=ATOL)
    # the JAX factor solved by the port (solve parity alone)
    sc = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    _close(tsp.spike_solve(sc, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))


def test_spike_method_cr_multi_rhs(band):
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU), K=4,
                          block_b=B, method="cr")
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), K=4, block_b=B,
                          method="cr")
    R = np.random.default_rng(3).standard_normal((N, 3))
    _close(tsp.spike_solve_many(st, torch.from_numpy(R)),
           jsp.spike_solve_many(sj, jnp.asarray(R), impl="xla"))


def test_spike_cr_bf16_factors(band):
    """bf16 CR blocks (store_dtype): the solve promotes them to f32."""
    b32 = band.astype(np.float32)
    st = tsp.spike_factor(banded_from_numpy(b32, KL, KU, device=CPU), K=4,
                          block_b=B, method="cr", store_dtype=torch.bfloat16)
    sj = jsp.spike_factor(JBand(jnp.asarray(b32), KL, KU), K=4, block_b=B,
                          method="cr", store_dtype=jnp.bfloat16)
    assert st.fact.levels[0].P.dtype == torch.bfloat16
    u = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    rhs = np.asarray(j_mv(JBand(jnp.asarray(b32), KL, KU), jnp.asarray(u)))
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    assert x.dtype == torch.float32
    xj = j2n(jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))
    assert np.abs(x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    assert np.linalg.norm(x.numpy() - u) / np.linalg.norm(u) < 5e-2


K300, NB300 = 300, 16


@pytest.fixture(scope="module")
def k300():
    """K = 300 partitions of 16 rows (tridiagonal, b = 16): the reduced
    system has 299 block rows, so 'auto' factors it by CR."""
    data = random_band(K300 * NB300, 1, 1, seed=2)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), 1, 1), K=K300,
                          block_b=NB300)
    st = tsp.spike_factor(banded_from_numpy(data, 1, 1, device=CPU),
                          K=K300, block_b=NB300)
    return data, sj, st


def test_k300_auto_reduced_cr_solve(k300):
    data, sj, st = k300
    assert isinstance(st.red_fact, tcr.CRFactor)
    assert isinstance(sj.red_fact, jcr.CRFactor)
    assert st.red_fact.n_pad == sj.red_fact.n_pad == 511
    _close(st.red_fact.root_Dinv, sj.red_fact.root_Dinv)
    rhs = np.random.default_rng(3).standard_normal(K300 * NB300)
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))


def test_k300_auto_reduced_cr_solve_many(k300):
    data, sj, st = k300
    R = np.random.default_rng(4).standard_normal((K300 * NB300, 3))
    _close(tsp.spike_solve_many(st, torch.from_numpy(R)),
           jsp.spike_solve_many(sj, jnp.asarray(R), impl="xla"))


def test_k300_transpose(k300):
    """The transposed K = 300 factor: its reduced system by CR too."""
    data, sj, st = k300
    tj, tt = jsp.spike_transpose(sj), tsp.spike_transpose(st)
    assert isinstance(tt.red_fact, tcr.CRFactor)
    rhs = np.random.default_rng(5).standard_normal(K300 * NB300)
    _close(tsp.spike_solve(tt, torch.from_numpy(rhs)),
           jsp.spike_solve(tj, jnp.asarray(rhs), impl="xla"))


def test_transpose_of_cr_partitions_raises(band):
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU), K=4,
                          block_b=B, method="cr")
    with pytest.raises(ValueError, match="block-Thomas"):
        tsp.spike_transpose(st)

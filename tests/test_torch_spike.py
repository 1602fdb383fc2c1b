"""PyTorch port, SPIKE factorization and solve, against the JAX package and
scipy.linalg.solve_banded (the ``lu``/``cr`` methods, the shift and the CR
reduced system at this file's sizes too).

Tolerance: 1e-9 in f64 (tips, spikes, reduced factor, solution); the same
algebra in another summation order.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import pad_banded as j_pad
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.band import pad_banded

from torch_parity import (CPU, band_to_scipy, j2n, jax_spike_to_numpy,
                          random_band, t2n)

ATOL = 1e-9
N, KL, KU, B = 1500, 6, 8, 16


@pytest.fixture(scope="module")
def band():
    return random_band(N, KL, KU, seed=0)


@pytest.fixture(scope="module")
def rhs():
    return np.random.default_rng(1).standard_normal(N)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(t2n(got), j2n(ref), atol=atol)


def test_extract_tips_match_jax(band):
    K = 4
    k, b, m = tsp._partition_geometry(N, K, KL, KU, B)
    assert (k, b, m) == jsp._partition_geometry(N, K, KL, KU, B)
    padded = pad_banded(banded_from_numpy(band, KL, KU,
                                          device=CPU), K * m).data
    jpadded = j_pad(JBand(jnp.asarray(band), KL, KU), K * m).data
    got = tsp._extract_tips(padded, K, m, k, KL, KU)
    ref = jsp._extract_tips(jpadded, K, m, k, KL, KU)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


CASES = [  # K, store_spikes, spike_dtype, inverter
    (1, False, None, "lapack"),
    (4, False, None, "newton_fixed"),
    (8, True, None, "lapack"),
    (8, True, "bf16", "newton_fixed"),
]


@pytest.mark.parametrize("K,store,spike_dtype,inverter", CASES)
def test_spike_factor_and_solve_match_jax(band, rhs, K, store, spike_dtype,
                                          inverter):
    jdt = {None: None, "bf16": jnp.bfloat16}[spike_dtype]
    tdt = {None: None, "bf16": torch.bfloat16}[spike_dtype]
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), K=K, block_b=B,
                          store_spikes=store, spike_dtype=jdt,
                          inverter=inverter)
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU,
                                            device=CPU), K=K, block_b=B,
                          store_spikes=store, spike_dtype=tdt,
                          inverter=inverter)
    assert (st.n, st.K, st.m, st.b, st.k) == (sj.n, sj.K, sj.m, sj.b, sj.k)
    for name in ("F", "U", "Sinv"):
        _close(getattr(st.fact, name), getattr(sj.fact, name))
    _close(st.Btip, sj.Btip)
    _close(st.Ctip, sj.Ctip)
    if K > 1:                                   # the reduced factor
        for name in ("F", "U", "Sinv"):
            _close(getattr(st.red_fact, name), getattr(sj.red_fact, name))
    else:
        assert st.red_fact is None and sj.red_fact is None
    if store:                                   # the V/W spikes
        assert st.V.dtype == (tdt or torch.float64)
        _close(st.V, sj.V)
        _close(st.W, sj.W)
    else:
        assert st.V is None and st.W is None
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    _close(x, jsp.spike_solve(sj, jnp.asarray(rhs)))
    if spike_dtype is None:                     # exact solve
        ref = sla.solve_banded((KL, KU), band_to_scipy(band, KL, KU), rhs)
        np.testing.assert_allclose(x.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("store", [False, True])
def test_solve_on_jax_factor(band, rhs, store):
    """Solve parity alone: the port's spike_solve on the JAX factor."""
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), K=8, block_b=B,
                          store_spikes=store, inverter="lapack")
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    x = tsp.spike_solve(st, torch.from_numpy(rhs))
    _close(x, jsp.spike_solve(sj, jnp.asarray(rhs)))
    # impl="cuda" on a CPU tensor runs the kernel's plain version
    _close(tsp.spike_solve(st, torch.from_numpy(rhs), impl="cuda"),
           jsp.spike_solve(sj, jnp.asarray(rhs)))
    with pytest.raises(ValueError, match="unknown impl"):
        tsp.spike_solve(st, torch.from_numpy(rhs), impl="mosaic")


@pytest.mark.parametrize("kwargs", [dict(method="lu"), dict(method="cr"),
                                    dict(shift="nonzero"),
                                    dict(reduced="cr")])
def test_unported_options_raise(band, rhs, kwargs):
    """The options these cases once refused (``lu`` and ``cr`` partitions,
    the pivot shift, a CR reduced system) now factor as JAX's do: the
    solution and the reduced factor's type against JAX's."""
    from spike_petsc_tpu.ops.cyclic import CRFactor as JCR
    from spike_petsc_tpu_torch.ops.cyclic import CRFactor as TCR
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU), K=4,
                          block_b=B, **kwargs)
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), K=4, block_b=B,
                          **kwargs)
    assert isinstance(st.red_fact, TCR) == isinstance(sj.red_fact, JCR)
    assert isinstance(st.fact, TCR) == isinstance(sj.fact, JCR)
    if "shift" in kwargs:
        np.testing.assert_array_equal(st.fact.nshift.numpy(),
                                      np.asarray(sj.fact.nshift))
    _close(tsp.spike_solve(st, torch.from_numpy(rhs)),
           jsp.spike_solve(sj, jnp.asarray(rhs), impl="xla"))


def test_store_lt_matches_jax(band, rhs):
    """``store_lt=True`` keeps JAX's L blocks beside the same factor, and
    the transpose built from them solves A^T x = rhs as JAX's does."""
    kw = dict(K=4, block_b=B, store_lt=True)
    sj = jsp.spike_factor(JBand(jnp.asarray(band), KL, KU), **kw)
    st = tsp.spike_factor(banded_from_numpy(band, KL, KU, device=CPU), **kw)
    _close(st.Lb, sj.Lb)
    for name in ("F", "U", "Sinv"):
        _close(getattr(st.fact, name), getattr(sj.fact, name))
    _close(tsp.spike_solve(tsp.spike_transpose(st), torch.from_numpy(rhs)),
           jsp.spike_solve(jsp.spike_transpose(sj), jnp.asarray(rhs),
                           impl="xla"))


def test_reduced_cyclic_reduction_not_ported():
    """K = 300 (299 reduced block rows, >= 255): 'auto' factors the reduced
    system by cyclic reduction, as JAX does, once refused here."""
    from spike_petsc_tpu_torch.ops.cyclic import CRFactor
    data = random_band(300 * 16, 1, 1, seed=2)
    st = tsp.spike_factor(banded_from_numpy(data, 1, 1, device=CPU), K=300,
                          block_b=16)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), 1, 1), K=300, block_b=16)
    assert isinstance(st.red_fact, CRFactor)
    r = np.random.default_rng(7).standard_normal(300 * 16)
    _close(tsp.spike_solve(st, torch.from_numpy(r)),
           jsp.spike_solve(sj, jnp.asarray(r), impl="xla"))


def test_complex_hermitian_spd_transpose_still_raises():
    """Once refused: the transpose of a complex Hermitian ``spd``
    factorization is JAX's marker form (A^T = conj(A): the conjugated
    forward sweeps), and solves A^T x = r as JAX's does."""
    from spike_petsc_tpu_torch.ops.blocktri import TransposedBlockTriFactor
    n, k = 400, 3
    rng = np.random.default_rng(8)
    a = np.zeros((n, n), complex)
    for d in range(1, k + 1):
        v = rng.standard_normal(n - d) + 1j * rng.standard_normal(n - d)
        a[np.arange(n - d), np.arange(d, n)] = v
        a[np.arange(d, n), np.arange(n - d)] = v.conj()
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
    data = np.zeros((n, 2 * k + 1), complex)
    for d in range(-k, k + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        data[rows, d + k] = a[rows, rows + d]
    st = tsp.spike_factor(banded_from_numpy(data, k, k, device=CPU), 4,
                          block_b=8, method="spd")
    sj = jsp.spike_factor(JBand(jnp.asarray(data), k, k), 4, block_b=8,
                          method="spd")
    tt, tj = tsp.spike_transpose(st), jsp.spike_transpose(sj)
    assert isinstance(tt.fact, TransposedBlockTriFactor)
    r = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = t2n(tsp.spike_solve(tt, torch.from_numpy(r)))
    np.testing.assert_allclose(x, j2n(jsp.spike_solve(tj, jnp.asarray(r))),
                               atol=ATOL)
    np.testing.assert_allclose(a.T @ x, r, atol=ATOL)

"""The port's two alternate kernels' plain paths against the JAX package:
the two-pass block-Thomas sweeps (``spike_solve(impl="pallas")``, the plain
version of ``csrc/sweeps.cu``) against JAX ``blocktri_solve_batched_pallas``
and ``spike_solve(impl="pallas")`` in interpret mode, the JAX ``impl`` names
of ``spike_solve`` / ``spike_solve_many``, and the grid block-tridiagonal
matvec (the plain version of ``csrc/blocktri_matvec_grid.cu``) against JAX
``blocktri_matvec_pallas``, including nb not a multiple of kt.

Tolerances: 1e-12 in f64; 1e-5 relative in f32 and with bf16 factors or
blocks (both promote them to f32 and sum in f32 in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.blocktri import BlockTridiagonal as JBT
from spike_petsc_tpu.ops.blocktri import cast_factor as j_cast
from spike_petsc_tpu.ops.pallas.matvec import (
    blocktri_matvec_pallas as j_grid_matvec)
from spike_petsc_tpu.ops.pallas.sweeps import blocktri_solve_batched_pallas
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_factor_from_numpy,
                                           blocktri_from_numpy)
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.blocktri import cast_factor
from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec_grid as cgrid
from spike_petsc_tpu_torch.ops.cuda import sweeps as csw

from torch_parity import (CPU, j2n, jax_factor_to_numpy, random_band,
                          spd_band, t2n)

N, HW, K, B = 1200, 6, 4, 16


@pytest.fixture(scope="module")
def band():
    return random_band(N, HW, HW, seed=31)


@pytest.fixture(scope="module")
def factors(band):
    """The JAX and the port's factor of the same band (K = 4, b = 16)."""
    sj = jsp.spike_factor(JBand(jnp.asarray(band), HW, HW), K=K, block_b=B,
                          store_spikes=True)
    st = tsp.spike_factor(banded_from_numpy(band, HW, HW, device=CPU), K=K,
                          block_b=B, store_spikes=True)
    return sj, st


def _rel(got, ref):
    ref = j2n(ref)
    return np.abs(t2n(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_two_pass_sweeps_match_jax_pallas(factors, dtype):
    """The kernel's plain path on the JAX factor (carried across) against
    the JAX two-pass Pallas sweeps, f64 and f32 factors and bf16-stored
    ones with an f32 right-hand side."""
    sj, _ = factors
    jf = sj.fact
    if dtype != "f64":
        jf = j_cast(jf, {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tf = blocktri_factor_from_numpy(*jax_factor_to_numpy(jf), device=CPU)
    rdt = np.float64 if dtype == "f64" else np.float32
    rhs = np.random.default_rng(32).standard_normal(
        (K, sj.nb, B)).astype(rdt)
    ref = blocktri_solve_batched_pallas(jf, jnp.asarray(rhs))
    got = csw.blocktri_solve_batched_cuda(tf, torch.from_numpy(rhs))
    assert got.shape == (K, sj.nb, B)
    assert got.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    assert _rel(got, ref) <= (1e-12 if dtype == "f64" else 1e-5)


def test_spike_solve_pallas_matches_jax(band, factors):
    """``spike_solve(impl="pallas")`` in both packages, and the port's
    other impl names on the same factor."""
    sj, st = factors
    rhs = np.random.default_rng(33).standard_normal(N)
    ref = jsp.spike_solve(sj, jnp.asarray(rhs), impl="pallas")
    got = tsp.spike_solve(st, torch.from_numpy(rhs), impl="pallas")
    assert _rel(got, ref) <= 1e-12
    for impl in ("auto", "cuda", "plain", "xla", "pallas_fused"):
        other = tsp.spike_solve(st, torch.from_numpy(rhs), impl=impl)
        np.testing.assert_allclose(other.numpy(), got.numpy(), atol=1e-13,
                                   err_msg=impl)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_fused"])
def test_spike_solve_many_jax_impl_names(factors, impl):
    """``spike_solve_many`` takes the JAX names: 'pallas' and
    'pallas_fused' mean the multi-RHS kernel, 'xla' the plain sweep."""
    sj, st = factors
    rhs = np.random.default_rng(34).standard_normal((N, 3))
    ref = jsp.spike_solve_many(sj, jnp.asarray(rhs), impl=impl)
    got = tsp.spike_solve_many(st, torch.from_numpy(rhs), impl=impl)
    assert got.shape == (N, 3) and _rel(got, ref) <= 1e-12


def test_pallas_impl_refuses_spd_factors():
    """The two-pass sweeps take ``inv`` factors only, as in JAX; the fused
    names take ``spd`` ones too."""
    data = spd_band(1024, 8, seed=35)
    jband = JBand(jnp.asarray(data), 8, 8)
    sj = jsp.spike_factor(jband, K=2, block_b=16, method="spd")
    st = tsp.spike_factor(banded_from_numpy(data, 8, 8, device=CPU), K=2,
                          block_b=16, method="spd")
    rhs = np.random.default_rng(36).standard_normal(1024)
    with pytest.raises(ValueError, match="method='inv'"):
        jsp.spike_solve(sj, jnp.asarray(rhs), impl="pallas")
    with pytest.raises(ValueError, match="method='inv'"):
        tsp.spike_solve(st, torch.from_numpy(rhs), impl="pallas")
    with pytest.raises(ValueError, match="method='inv'"):
        tsp.spike_solve_many(st, torch.from_numpy(rhs[:, None]),
                             impl="pallas")
    with pytest.raises(ValueError, match="method='inv'"):
        csw.blocktri_solve_batched_cuda(st.fact, torch.zeros(
            (2, st.nb, 16), dtype=torch.float64))
    ref = jsp.spike_solve(sj, jnp.asarray(rhs), impl="pallas_fused")
    got = tsp.spike_solve(st, torch.from_numpy(rhs), impl="pallas_fused")
    assert _rel(got, ref) <= 1e-12


def test_sweeps_rule():
    inv = blocktri_factor_from_numpy(*(np.zeros((2, 3, 64, 64)),) * 3,
                                     device=CPU)
    assert not csw.sweeps_feasible(inv, 64)                     # f64
    f32 = cast_factor(inv, torch.float32)
    assert csw.sweeps_feasible(f32, 64)
    assert csw.sweeps_feasible(cast_factor(inv, torch.bfloat16), 64)
    assert not csw.sweeps_feasible(f32, 64, torch.float64)      # f64 rhs
    assert not csw.sweeps_feasible(f32, 32)
    spd = blocktri_factor_from_numpy(np.zeros((2, 3, 64, 64), np.float32),
                                     np.zeros((2, 3, 0, 0), np.float32),
                                     np.zeros((2, 3, 64, 64), np.float32),
                                     device=CPU, method="spd")
    assert not csw.sweeps_feasible(spd, 64)
    with pytest.raises(ValueError, match="unknown impl"):
        csw.blocktri_solve_batched_cuda(f32, torch.zeros((2, 3, 64)),
                                        impl="xla")


@pytest.mark.parametrize("nb,kt", [(11, 4), (9, 8), (3, 8), (16, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grid_matvec_matches_jax(nb, kt, dtype):
    """nb = 11 with kt = 4 and nb = 9 with kt = 8 leave a short last chunk,
    nb = 3 < kt one chunk, nb = 16 full chunks."""
    b = 32
    rng = np.random.default_rng(37 + nb)
    D, L, U = (rng.standard_normal((nb, b, b)).astype(np.float32)
               for _ in range(3))
    L[0] = 0
    U[nb - 1] = 0
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jT = JBT(D=jnp.asarray(D).astype(jdt), L=jnp.asarray(L).astype(jdt),
             U=jnp.asarray(U).astype(jdt))
    tT = blocktri_from_numpy(*(np.asarray(a) for a in (jT.D, jT.L, jT.U)),
                             device=CPU)
    x = rng.standard_normal((nb, b)).astype(np.float32)
    ref = j_grid_matvec(jT, jnp.asarray(x), kt=kt)
    got = cgrid.blocktri_matvec_pallas(tT, torch.from_numpy(x), kt=kt)
    assert got.shape == (nb, b) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


def test_grid_matvec_rule():
    assert cgrid.blocktri_matvec_grid_feasible(torch.float32, 128)
    assert cgrid.blocktri_matvec_grid_feasible(torch.bfloat16, 64, kt=32)
    assert not cgrid.blocktri_matvec_grid_feasible(torch.float64, 128)
    assert not cgrid.blocktri_matvec_grid_feasible(torch.float32, 32)
    assert not cgrid.blocktri_matvec_grid_feasible(torch.float32, 128, kt=0)
    assert not cgrid.blocktri_matvec_grid_feasible(torch.float32, 128, kt=33)

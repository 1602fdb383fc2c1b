"""PyTorch port, operator routes: the single-RHS ``blocktri`` route (the
plain version of ``csrc/blocktri_matvec.cu``) against the JAX DMA
block-tridiagonal kernel in interpret mode and against the banded matvec,
and the ``as_matvec_many`` routes against the JAX package's.

Both packages get the same BlockTridiagonal (``convert.blocktri_from_numpy``
of the JAX conversion).  Tolerances: 1e-5 of max|y| in f32 and with bf16
blocks (both promote the blocks to f32 and sum in f32 in another order);
the multi-RHS routes at rtol/atol 2e-5 in f32, as the JAX tests of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_mv
from spike_petsc_tpu.ops.pallas.matvec import blocktri_matvec_dma
from spike_petsc_tpu.solvers import operator as jop
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           blocktri_from_numpy)
from spike_petsc_tpu_torch.ops.band import BandedMatrix
from spike_petsc_tpu_torch.ops.band import banded_matvec as t_mv
from spike_petsc_tpu_torch.ops.blocktri import band_to_blocktri
from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
from spike_petsc_tpu_torch.solvers import operator as top

from torch_parity import CPU, j2n, random_band

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, ref, rel=1e-5):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k", [(1100, 100), (1024, 60)])
def test_blocktri_route_matches_jax_dma_kernel(monkeypatch, dtype, n, k):
    """n = 1100 leaves the last block row ragged (nb = 9); 1024 fills it."""
    data = random_band(n, k, k, seed=51, dtype=np.float32, dominant=False)
    jb = JBand(jnp.asarray(data).astype(JDT[dtype]), k, k)
    T = jbt.band_to_blocktri(jb, 128)
    tT = blocktri_from_numpy(*(np.asarray(a) for a in (T.D, T.L, T.U)),
                             device=CPU)
    assert tT.dtype == TDT[dtype] and tT.nb == -(-n // 128)
    x = np.random.default_rng(52).standard_normal(n).astype(np.float32)
    xb = np.zeros(tT.nb * 128, np.float32)
    xb[:n] = x
    ref = np.asarray(blocktri_matvec_dma(T, jnp.asarray(xb).reshape(-1, 128)))
    got = cbt.blocktri_matvec_cuda(tT, torch.from_numpy(x))
    assert got.shape == (n,) and got.dtype == torch.float32
    _close(got.numpy(), ref.reshape(-1)[:n])
    # the route: one conversion of the port's band, the same answer as the
    # banded matvec of the band (the CUDA rule patched, as on a card)
    monkeypatch.setattr(top, "_use_blocktri_matvec", lambda a: True)
    tb = BandedMatrix(data=torch.from_numpy(data).to(TDT[dtype]), kl=k, ku=k)
    mv, nn, dt = top.as_matvec(tb, impl="blocktri")
    assert (mv._route, nn, dt) == ("blocktri", n, TDT[dtype])
    y = mv(torch.from_numpy(x))
    _close(y.numpy(), ref.reshape(-1)[:n])
    _close(y.numpy(), j2n(j_mv(jb, jnp.asarray(x))))


@pytest.mark.parametrize("n,kl,ku,dtype", [
    (1536, 48, 48, np.float32), (1536, 48, 48, np.float64),
    (1536, 3, 3, np.float32), (400, 48, 48, np.float32),
    (4096, 129, 20, np.float32), (4096, 128, 100, np.float32)])
def test_bt_gate_matches_jax(n, kl, ku, dtype):
    data = random_band(n, kl, ku, seed=53, dtype=dtype)
    assert top._bt_gate(banded_from_numpy(data, kl, ku, device=CPU)) == \
        jop._bt_gate(JBand(jnp.asarray(data), kl, ku))


def test_blocktri_route_gate_on_the_cpu():
    """Off the card the blocktri routes are not taken (the JAX package's
    rule off the TPU); 'auto' stays on the plain version."""
    data = random_band(1536, 48, 48, seed=54, dtype=np.float32)
    tb = banded_from_numpy(data, 48, 48, device=CPU)
    for impl in ("auto", "blocktri"):
        assert top.as_matvec(tb, impl=impl)[0]._route == "xla"
        assert top.as_matvec_many(tb, impl=impl)[0]._route == "vmap_xla"
    assert top.as_matvec(band_to_blocktri(tb, 128))[0]._route == "xla"


@pytest.mark.parametrize("kl,dtype,many", [
    (48, torch.float64, True), (129, torch.float32, True),
    (48, torch.float16, False)])
def test_blocktri_route_refuses_what_it_cannot_take(monkeypatch, kl, dtype,
                                                    many):
    """On a card (the CUDA rule patched), ``impl="blocktri"`` raises where
    the conversion gate refuses the band (f64, max(kl, ku) > 128), and the
    single-RHS route also where the kernel does (f16): no plain fallback.
    'auto' still resolves."""
    monkeypatch.setattr(top, "_use_blocktri_matvec", lambda a: True)
    data = random_band(1536, kl, 20, seed=57, dtype=np.float64)
    tb = BandedMatrix(data=torch.from_numpy(data).to(dtype), kl=kl, ku=20)
    with pytest.raises(ValueError, match="blocktri does not take"):
        top.as_matvec(tb, impl="blocktri")
    if many:
        with pytest.raises(ValueError, match="blocktri does not take"):
            top.as_matvec_many(tb, impl="blocktri")
    assert top.as_matvec(tb)[0]._route == "xla"
    assert top.as_matvec_many(tb)[0]._route == "vmap_xla"


def test_as_matvec_many_routes_match_jax(monkeypatch):
    """The multi-RHS routes: blocktri_many for a wide band, forced
    blocktri on a narrow band, the narrow 'auto' column loop, the f64 gate,
    and a BlockTridiagonal operator — each the JAX package's route, with
    the same values."""
    monkeypatch.setattr(jop, "_use_blocktri_matvec", lambda: True)
    monkeypatch.setattr(top, "_use_blocktri_matvec", lambda a: True)
    n, k, r = 1024, 50, 5
    wide = random_band(n, k, k, seed=55, dtype=np.float32)
    narrow = np.ascontiguousarray(wide[:, k - 3:k + 4])
    X = np.random.default_rng(56).uniform(size=(n, r)).astype(np.float32)
    cases = [(wide, k, "auto", "blocktri_many"),
             (narrow, 3, "blocktri", "blocktri_many"),
             (narrow, 3, "auto", "vmap_xla"),
             (wide.astype(np.float64), k, "auto", "vmap_xla")]
    for data, kk, impl, route in cases:
        jb = JBand(jnp.asarray(data), kk, kk)
        tb = banded_from_numpy(data, kk, kk, device=CPU)
        mvj, _, _ = jop.as_matvec_many(jb, impl=impl)
        mvt, nn, _ = top.as_matvec_many(tb, impl=impl)
        assert nn == n and mvt._route == route
        assert mvj._route.split("_")[0] == route.split("_")[0]
        Xd = X.astype(data.dtype)
        ref = np.asarray(mvj(jnp.asarray(Xd)))
        np.testing.assert_allclose(mvt(torch.from_numpy(Xd)).numpy(), ref,
                                   rtol=2e-5, atol=2e-5, err_msg=route)
        cols = np.stack([np.asarray(t_mv(tb, torch.from_numpy(Xd[:, j])))
                         for j in range(r)], axis=1)
        np.testing.assert_allclose(cols, ref, rtol=2e-5, atol=2e-5)
    T = jbt.band_to_blocktri(JBand(jnp.asarray(wide), k, k), 128)
    tT = blocktri_from_numpy(*(np.asarray(a) for a in (T.D, T.L, T.U)),
                             device=CPU)
    mvt, nn, _ = top.as_matvec_many(tT)
    assert (mvt._route, nn) == ("blocktri_many", T.nb * 128)
    Xp = np.zeros((nn, r), np.float32)
    Xp[:n] = X
    ref = np.asarray(jop.as_matvec_many(T)[0](jnp.asarray(Xp)))
    np.testing.assert_allclose(mvt(torch.from_numpy(Xp)).numpy(), ref,
                               rtol=2e-5, atol=2e-5)
    mv1, n1, _ = top.as_matvec(tT)
    assert (mv1._route, n1) == ("blocktri", nn)
    np.testing.assert_allclose(mv1(torch.from_numpy(Xp[:, 0])).numpy(),
                               ref[:, 0], rtol=2e-5, atol=2e-5)

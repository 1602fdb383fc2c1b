"""The multi-RHS band matvec (#11) on the CPU: its plain version against
the column loop of #2's plain version, the plan of its stages, and the
rule that routes a band's batched operator (``operator._many_route``),
each card case asserted through the device argument.  The kernel itself
is held against the plain version on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from spike_petsc_tpu_torch import BandedMatrix
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
from spike_petsc_tpu_torch.ops.cuda import band_matvec_many as cbmm
from spike_petsc_tpu_torch.solvers import operator as top

from torch_parity import CPU, random_band

CUDA = torch.device("cuda")


def _band(n, kl, ku, dtype=torch.float32, seed=61):
    data = random_band(n, kl, ku, seed=seed, dtype=np.float32,
                       dominant=False)
    return BandedMatrix(data=torch.from_numpy(data).to(dtype), kl=kl, ku=ku)


@pytest.mark.parametrize("r", [1, 5, 32, 33, 64])
@pytest.mark.parametrize("kl,ku", [(1, 1), (6, 6), (16, 16), (100, 100),
                                   (5, 20)])
def test_plain_matches_the_column_loop(kl, ku, r):
    """w = 3, 13, 33, 201 and kl != ku; n = 517 is no multiple of the
    kernel's 128-row tile.  The same shifted axpys in the same order: equal
    to the bit."""
    n = 517
    prep = cbm.prepare_banded_mv(_band(n, kl, ku))
    X = torch.from_numpy(np.random.default_rng(62).standard_normal(
        (n, r)).astype(np.float32))
    Y = cbmm.banded_matvec_many_prepared(prep, X)
    cols = torch.stack([cbm.banded_matvec_prepared_plain(prep, X[:, j])
                        for j in range(r)], dim=1)
    assert Y.shape == (n, r) and Y.dtype == torch.float32
    assert torch.equal(Y, cols)


@pytest.mark.parametrize("kl,ku", [(16, 16), (100, 100), (5, 20)])
def test_plain_bf16_band_is_promoted(kl, ku):
    """bf16 storage: promoted to f32 before the products, as the kernel
    does in registers; each column is #2's plain version on it."""
    n, r = 300, 7
    prep = cbm.prepare_banded_mv(_band(n, kl, ku, torch.bfloat16))
    X = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (n, r)).astype(np.float32))
    Y = cbmm.banded_matvec_many_prepared(prep, X)
    ref = cbmm.banded_matvec_many_prepared(
        cbm.PreparedBandMV(d3=prep.d3.float(), kl=kl, ku=ku, n=n), X)
    assert Y.dtype == torch.float32 and torch.equal(Y, ref)
    assert torch.equal(Y[:, 3], cbm.banded_matvec_prepared_plain(prep,
                                                                 X[:, 3]))


def test_wrapper_checks_its_input():
    prep = cbm.prepare_banded_mv(_band(200, 3, 3))
    with pytest.raises(ValueError, match="shape"):
        cbmm.banded_matvec_many_prepared(prep, torch.zeros(200))
    with pytest.raises(ValueError, match="shape"):
        cbmm.banded_matvec_many_prepared(prep, torch.zeros((199, 2)))
    with pytest.raises(ValueError, match="unknown impl"):
        cbmm.banded_matvec_many_prepared(prep, torch.zeros((200, 2)),
                                         impl="xla")


@pytest.mark.parametrize("w", [1, 3, 13, 33, 201, 256, 1025, 4096])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fits_its_stage_in_the_fewest_chunks(w, itemsize):
    """The chunks cover the width, each stage fits the budget (the ring and
    its mbarriers within one block's 227 KB), one chunk fewer would not
    fit, and the ring is 3 deep where the whole width fits a stage, else
    2."""
    kl = (w - 1) // 2
    plan = cbmm.band_many_plan(kl, w - 1 - kl, itemsize)
    dc, chunks = plan["dc"], plan["chunks"]
    assert 1 <= dc <= w and (chunks - 1) * dc < w <= chunks * dc
    assert plan["stage_bytes"] == cbmm.stage_bytes(dc, itemsize)
    assert plan["stage_bytes"] <= cbmm.STAGE_BYTES
    assert 128 + plan["stages"] * plan["stage_bytes"] <= 232448
    assert plan["stages"] == (3 if chunks == 1 else 2)
    if chunks > 1:
        assert cbmm.stage_bytes(-(-w // (chunks - 1)),
                                itemsize) > cbmm.STAGE_BYTES


def test_plan_at_the_cells_widths():
    """The launch shapes timed best on the card at r = 32 (PERF.md)."""
    plan = cbmm.band_many_plan(16, 16, 4)                     # w = 33
    assert (plan["dc"], plan["stages"]) == (33, 3)
    plan = cbmm.band_many_plan(100, 100, 4)                   # w = 201
    assert (plan["dc"], plan["chunks"], plan["stages"]) == (34, 6, 2)
    plan = cbmm.band_many_plan(100, 100, 2)                   # bf16
    assert (plan["dc"], plan["stages"]) == (51, 2)


@pytest.mark.parametrize("dtype,kl,ku,impl,device,route", [
    # 'auto' on the card: #11 for f32 and bf16 bands of every width #2 takes
    (torch.float32, 16, 16, "auto", CUDA, "banded_cuda_many"),
    (torch.float32, 100, 100, "auto", CUDA, "banded_cuda_many"),
    (torch.float32, 1, 1, "auto", CUDA, "banded_cuda_many"),
    (torch.float32, 5, 20, "auto", CUDA, "banded_cuda_many"),
    (torch.float32, 2000, 2095, "auto", CUDA, "banded_cuda_many"),
    (torch.bfloat16, 100, 100, "auto", CUDA, "banded_cuda_many"),
    (torch.bfloat16, 16, 16, "auto", CUDA, "banded_cuda_many"),
    # explicit blocktri keeps the conversion on the card, at any width
    (torch.float32, 100, 100, "blocktri", CUDA, "blocktri_many"),
    (torch.float32, 3, 3, "blocktri", CUDA, "blocktri_many"),
    (torch.bfloat16, 16, 16, "blocktri", CUDA, "blocktri_many"),
    # f64: the column loop over #6; f16 (no band kernel): blocktri if wide
    (torch.float64, 100, 100, "auto", CUDA, "vmap"),
    (torch.float64, 16, 16, "auto", CUDA, "vmap"),
    (torch.float16, 100, 100, "auto", CUDA, "blocktri_many"),
    (torch.float16, 16, 16, "auto", CUDA, "vmap"),
    # past #2's width, nothing takes it
    (torch.float32, 2048, 2048, "auto", CUDA, "vmap"),
    # explicit band kernels: #11 wherever 'auto' takes it; xla (the plain
    # version) and f64: the column loop
    (torch.float32, 100, 100, "banded_cuda", CUDA, "banded_cuda_many"),
    (torch.float32, 100, 100, "banded_pallas", CUDA, "banded_cuda_many"),
    (torch.bfloat16, 16, 16, "banded_cuda", CUDA, "banded_cuda_many"),
    (torch.float32, 16, 16, "banded_pallas", CUDA, "banded_cuda_many"),
    (torch.float64, 100, 100, "banded_cuda", CUDA, "vmap"),
    (torch.float64, 16, 16, "banded_pallas", CUDA, "vmap"),
    (torch.float32, 2048, 2048, "banded_cuda", CUDA, "vmap"),
    (torch.float32, 100, 100, "xla", CUDA, "vmap"),
    # the CPU: today's routes
    (torch.float32, 100, 100, "auto", CPU, "vmap"),
    (torch.float32, 100, 100, "blocktri", CPU, "vmap"),
    (torch.float32, 100, 100, "banded_cuda", CPU, "vmap"),
    (torch.float32, 16, 16, "banded_pallas", CPU, "vmap"),
    (torch.bfloat16, 16, 16, "auto", CPU, "vmap"),
    (torch.float64, 100, 100, "auto", CPU, "vmap")])
def test_many_route_rule(dtype, kl, ku, impl, device, route):
    n = 4 * 1024 if max(kl, ku) < 1000 else 4096 + 1
    band = BandedMatrix(data=torch.zeros((n, kl + ku + 1), dtype=dtype),
                        kl=kl, ku=ku)
    assert top._many_route(band, impl, device) == route


@pytest.mark.parametrize("dtype,kl", [(torch.float64, 40),
                                      (torch.float32, 129)])
def test_many_route_rule_refuses_explicit_blocktri(dtype, kl):
    """``impl="blocktri"`` on the card where the conversion gate refuses
    the band (f64; max(kl, ku) > 128) raises; 'auto' takes #11 or the
    column loop."""
    band = BandedMatrix(data=torch.zeros((4096, kl + 41), dtype=dtype),
                        kl=kl, ku=40)
    with pytest.raises(ValueError, match="blocktri does not take"):
        top._many_route(band, "blocktri", CUDA)
    assert top._many_route(band, "auto", CUDA) == (
        "vmap" if dtype == torch.float64 else "banded_cuda_many")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_as_matvec_many_on_the_cpu_keeps_the_column_loop(dtype):
    """A CPU band's batched operator is the column loop of the plain
    version, as before #11, and agrees with #11's plain version."""
    n, kl, ku, r = 600, 16, 16, 6
    band = banded_from_numpy(random_band(n, kl, ku, seed=64,
                                         dtype=np.float64), kl, ku,
                             device=CPU)
    band = BandedMatrix(data=band.data.to(dtype), kl=kl, ku=ku)
    mv, nn, dt = top.as_matvec_many(band)
    assert (mv._route, nn, dt) == ("vmap_xla", n, dtype)
    X = torch.from_numpy(np.random.default_rng(65).standard_normal(
        (n, r))).to(torch.float64 if dtype == torch.float64 else
                    torch.float32)
    ref = cbmm.banded_matvec_many_prepared(cbm.prepare_banded_mv(band), X)
    torch.testing.assert_close(mv(X), ref.to(X.dtype),
                               rtol=1e-5, atol=1e-5)

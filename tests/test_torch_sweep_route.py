"""The partition sweep that ``impl='auto'`` takes on the card, and the
block an ``inv`` PC gets there, checked on the CPU through their pure
functions (``ops.spike.sweep_route``, ``solvers.pc.default_block``, which
take a device flag); then BASELINE config 1 through both testbeds.

On the card an ``inv`` factor takes #1 (the fused sweep) where its rule
admits it, else #9 (the two-pass sweeps, any nb: a long single partition),
else the plain sweep, which only f64 factors or a block outside 64 and 128
reach.  A PC that names no block gets the smallest kernel block covering
the tip on the card (64 or 128), and the tip size on the CPU, as in JAX.
Partition rows round up to a multiple of the block, so on the card the
partition boundaries of a K > 1 PC move.

Config 1: ``-problem tridiag:2000 -ksp_type gmres -pc_type lu
-ksp_monitor_true_residual``, the JAX testbed (x64, the CPU) against the
port's (f64, the CPU), line for line with ``compare_testbeds``'s
tolerances.
"""

import numpy as np
import pytest
import torch

from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu_torch import Options
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
from spike_petsc_tpu_torch.ops.spike import _partition_geometry, sweep_route
from spike_petsc_tpu_torch.solvers import pc as tpc

from torch_parity import CPU, compare_testbeds


def _fact(b, nb, dtype=torch.float32, method="inv"):
    """A factor of the shape [1, nb, b, b] (zero-stride views: the route
    reads shapes and dtypes only)."""
    z = torch.zeros((1, 1, b, b), dtype=dtype).expand(1, nb, b, b)
    return BlockTriFactor(F=z, U=z, Sinv=z, method=method)


@pytest.mark.parametrize("b,nb,dtype,route", [
    (64, 100, torch.float32, "fused"),      # #1: one partition fits smem
    (128, 100, torch.float32, "fused"),
    (64, 1600, torch.float32, "sweeps"),    # #1 refuses, #9 takes any nb
    (64, 1600, torch.bfloat16, "sweeps"),
    (1, 1600, torch.float32, "plain"),      # no kernel takes b = 1
    (1, 100, torch.float32, "plain"),
    (64, 100, torch.float64, "plain"),      # no kernel takes f64 factors
    (64, 1600, torch.float64, "plain"),
])
def test_card_route_of_inv_factors(b, nb, dtype, route):
    fact = _fact(b, nb, dtype)
    assert sweep_route(fact, b, torch.float32, on_cuda=True) == route
    assert sweep_route(fact, b, torch.float32, on_cuda=False) == "plain"


def test_card_route_of_spd_and_many():
    """spd factors take #3 on the card whatever its rule says (it raises
    there).  The multi-RHS route has no two-pass kernel and needs none:
    #4 takes any nb, so a long single partition takes it too, and only a
    block outside 64 and 128 or f64 factors take the plain sweep."""
    spd = _fact(64, 1600, method="spd")
    assert sweep_route(spd, 64, torch.float32, on_cuda=True) == "fused"
    assert sweep_route(_fact(16, 10, method="spd"), 16, torch.float32,
                       on_cuda=True) == "fused"
    long = _fact(64, 1600)
    assert sweep_route(long, 64, torch.float32, True, many=True) == "fused"
    assert sweep_route(_fact(1, 1600), 1, torch.float32, True,
                       many=True) == "plain"
    assert sweep_route(_fact(64, 100, torch.float64), 64, torch.float32,
                       True, many=True) == "plain"


@pytest.mark.parametrize("k,method,card,cpu", [
    (1, "inv", 64, None), (64, "inv", 64, None), (65, "inv", 128, None),
    (128, "inv", 128, None), (200, "inv", 200, None),
    (1, "spd", 64, None), (100, "spd", 128, None)])
def test_default_block(k, method, card, cpu):
    """None on the CPU (the tip size); on the card the smallest kernel
    block that covers the tip, or (inv) the tip itself above 128; a block
    the options name is kept on both."""
    assert tpc.default_block(None, k, method, on_cuda=True) == card
    assert tpc.default_block(None, k, method, on_cuda=False) is cpu
    for on_cuda in (False, True):
        assert tpc.default_block(32, k, method, on_cuda) == 32


@pytest.mark.parametrize("name,opts", [
    ("lu", {}), ("spike", {"pc_spike_partitions": 4}),
    ("bjacobi", {"pc_bjacobi_blocks": 4})])
def test_pcs_take_the_card_block(monkeypatch, name, opts):
    """lu, spike and bjacobi on the tridiagonal band: the tip size (1) on a
    CPU band, 64 when the band is on the card (forced here through the
    device flag).  With K = 4 on n = 600 a partition holds 150 rows on the
    CPU and 192 (three blocks of 64) on the card: the boundaries move."""
    n = 600
    data = np.tile([-1.0, 2.0, -1.0], (n, 1))
    band = banded_from_numpy(data, 1, 1, device=CPU)
    assert tpc.make_pc(name, band, Options(dict(opts))).info["block"] == 1
    real = tpc.default_block
    monkeypatch.setattr(tpc, "default_block",
                        lambda block, k, method, on_cuda:
                        real(block, k, method, True))
    assert tpc.make_pc(name, band, Options(dict(opts))).info["block"] == 64
    assert _partition_geometry(n, 4, 1, 1, None)[2] == 150
    assert _partition_geometry(n, 4, 1, 1, 64)[2] == 192


def test_config1_testbed_matches_jax(capsys):
    """BASELINE config 1 (gmres + lu on the tridiagonal Laplacian) with the
    reference's -ksp_monitor_true_residual, n = 2000, f64."""
    rc, out = compare_testbeds(
        jtb.main, ttb.main,
        "-problem tridiag:2000 -ksp_type gmres -pc_type lu -ksp_rtol 1e-10 "
        "-ksp_monitor_true_residual".split(), capsys)
    assert rc == 0 and "true resid norm" in out

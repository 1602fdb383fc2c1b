"""The reduced-system kernel's (``ops/cuda/reduced_thomas.py``) rule, plan
and route, on the CPU.

``reduced_thomas_feasible`` must admit ``inv`` factors with no leading dims
stored f32 (the SPIKE reduced system, B = 2k even, at most 256) and any
number of columns, and refuse ``lu``, ``spd`` and cyclic-reduction factors,
f64, bf16, complex, partitioned and strided factors and factors on
another device than the right-hand side.  ``reduced_thomas_plan`` must
give every admitted B a launch shape the kernel takes.  On a CPU tensor the
reduced solve of ``ops.spike`` stays the plain loop, bit for bit.  No
kernel runs here (tests/test_torch_cuda.py holds the kernel against the
plain loop on the card).
"""

import pytest
import torch

from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops import spike as sp
from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor, blocktri_solve
from spike_petsc_tpu_torch.ops.cuda import KERNELS
from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt

from torch_parity import random_band


def _factor(nb, B, dtype=torch.float32, method="inv", lead=(),
            device="cpu"):
    """A contiguous factor of shape [*lead, nb, B, B] whose memory is never
    written (so never touched)."""
    z = torch.empty((*lead, nb, B, B), dtype=dtype, device=device)
    return BlockTriFactor(F=z, U=z, Sinv=z, method=method)


def _rhs(nb, B, r=None, dtype=torch.float32):
    shape = (nb, B) if r is None else (nb, B, r)
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


@pytest.mark.parametrize("B,r", [(200, 32), (200, None), (200, 1), (200, 5),
                                 (2, 3), (12, 100), (256, 7)])
def test_rule_admits_inv_reduced_factors(B, r):
    assert crt.reduced_thomas_feasible(_factor(63, B), _rhs(63, B, r))


@pytest.mark.parametrize("case", ["lu", "spd", "f64", "bf16", "complex",
                                  "lead", "odd_B", "big_B", "rhs_f64",
                                  "rhs_nb", "rhs_B", "rhs_4d", "cr",
                                  "transposed", "strided", "unaligned",
                                  "device"])
def test_rule_refuses_what_the_kernel_does_not_take(case):
    fact, rhs = _factor(63, 200), _rhs(63, 200, 32)
    if case in ("lu", "spd"):
        fact = _factor(63, 200, method=case)
    elif case == "f64":
        fact = _factor(63, 200, torch.float64)
    elif case == "bf16":
        fact = _factor(63, 200, torch.bfloat16)
    elif case == "complex":
        fact, rhs = (_factor(63, 200, torch.complex64),
                     _rhs(63, 200, 32, torch.complex64))
    elif case == "lead":
        fact, rhs = _factor(63, 200, lead=(4,)), _rhs(4, 63, 200)
    elif case == "odd_B":
        fact, rhs = _factor(63, 201), _rhs(63, 201, 32)
    elif case == "big_B":
        fact, rhs = _factor(63, 258), _rhs(63, 258, 32)
    elif case == "rhs_f64":
        rhs = _rhs(63, 200, 32, torch.float64)
    elif case == "rhs_nb":
        rhs = _rhs(62, 200, 32)
    elif case == "rhs_B":
        rhs = _rhs(63, 198, 32)
    elif case == "rhs_4d":
        rhs = rhs[None]
    elif case == "cr":
        band = banded_from_numpy(random_band(600, 2, 2, seed=1), 2, 2,
                                 device="cpu")
        fact = sp.spike_factor(band, K=8, block_b=8, reduced="cr").red_fact
        rhs = _rhs(7, 4, 3)
    elif case == "transposed":
        base = _factor(63, 200)
        fact = sp.TransposedBlockTriFactor(base)
    elif case == "strided":
        fact = BlockTriFactor(F=fact.F.mT, U=fact.U, Sinv=fact.Sinv)
    elif case == "unaligned":
        flat = torch.empty(63 * 200 * 200 + 1)[1:].view(63, 200, 200)
        fact = BlockTriFactor(F=flat, U=fact.U, Sinv=fact.Sinv)
    elif case == "device":
        fact = _factor(63, 200, device="meta")
    assert not crt.reduced_thomas_feasible(fact, rhs)


@pytest.mark.parametrize("r", [1, 2, 5, 16, 17, 32, 100])
def test_plan_gives_every_admitted_B_a_shape_the_kernel_takes(r):
    """The checks of the kernel's entry point (csrc/reduced_thomas.cu
    ``reduced_thomas_f32``) on every plan."""
    for B in range(2, crt.MAX_B + 1, 2):
        p = crt.reduced_thomas_plan(B, r)
        c, rows, depth = p["cluster"], p["rows"], p["depth"]
        assert 1 <= c <= 16 and p["cols"] in crt.COLS
        assert 1 <= rows <= crt.MAX_ROWS and rows * B % 4 == 0
        assert (c - 1) * rows < B <= c * rows
        assert 2 <= depth <= crt.MAX_DEPTH
        slot = -(-rows * B * 4 // 128) * 128
        assert 256 + depth * slot + 2 * B * p["cols"] * 4 <= 232448
        assert p["clusters"] * p["cols"] >= r
    flagship = crt.reduced_thomas_plan(200, r)
    assert (flagship["cluster"], flagship["rows"]) == (8, 25)
    assert flagship["cols"] == (1 if r == 1 else 2 if r <= 16 else 4)


def test_plan_refuses_a_cluster_that_leaves_a_block_empty():
    with pytest.raises(ValueError, match="cluster=16"):
        crt.reduced_thomas_plan(12, 1, cluster=16)
    with pytest.raises(ValueError, match="cols=8"):
        crt.reduced_thomas_plan(200, 32, cols=8)


def test_the_kernel_is_listed_and_built_with_the_others():
    assert crt.KERNEL in KERNELS
    src = crt.KERNEL.source.read_text()
    assert "Replaces no Pallas kernel" in src and "lax.scan" in src
    assert set(crt.KERNEL.functions) == {"reduced_thomas_f32",
                                         "reduced_thomas_smem"}


def _spike(k, r, seed=3):
    """A CPU SPIKE factor (f32, K = 8, b = 2k) and the interface values of a
    partition sweep of ``r`` random columns (None: one vector)."""
    band = banded_from_numpy(
        random_band(8 * 4 * 2 * k, k, k, seed=seed).astype("float32"), k, k,
        device="cpu")
    sf = sp.spike_factor(band, K=8, block_b=2 * k)
    gen = torch.Generator().manual_seed(seed)
    shape = (sf.K, sf.nb, sf.b) + (() if r is None else (r,))
    g = torch.randn(shape, generator=gen)
    return sf, g[:, sf.nb - 1, sf.b - k:], g[:, 0, :k]


@pytest.mark.parametrize("r", [None, 1, 5])
def test_cpu_reduced_solve_stays_the_plain_loop(r):
    """On a CPU tensor both entries of the route take ``blocktri_solve``:
    the same bits as the loop, and the interfaces as the concatenations of
    the plain route give them."""
    k = 4
    sf, g_bot, g_top = _spike(k, r)
    rhs = torch.cat([g_bot[:-1], g_top[1:]], dim=1)
    assert crt.reduced_thomas_feasible(sf.red_fact, rhs)
    want = blocktri_solve(sf.red_fact, rhs)
    assert torch.equal(sp._solve_reduced_system(sf.red_fact, rhs), want)
    assert torch.equal(crt.blocktri_solve_reduced_cuda(sf.red_fact, rhs),
                       want)
    xbot_prev, xtop_next = sp._reduced_solve(sf, g_bot, g_top)
    zk = torch.zeros_like(want[:1, :k])
    assert torch.equal(xbot_prev, torch.cat([zk, want[:, :k]]))
    assert torch.equal(xtop_next, torch.cat([want[:, k:], zk]))

"""The numerics of the multi-RHS sweep kernel's tensor-core products
(``spike_petsc_tpu_torch/csrc/fused_sweep_many.cu``), on the CPU.

The kernel runs each step's matrix-vector product as TF32 ``mma`` with the
operands split into TF32 hi and lo parts: 3 products for f32 factors
(A_hi v_hi + A_hi v_lo + A_lo v_hi), 2 for bf16 factors (exact in TF32).
Here the block-Thomas solve runs with every product done that way
(``torch_parity.sweep_tf32``: TF32 rounding emulated on the f32 bit
pattern), on a real ``inv`` factor of a diagonally dominant band (the
port's ``spike_factor``, b = 64, 4 partitions of 4 blocks), against the
f64 solve of the same factor by the JAX package (``blocktri_solve``).

Tolerances, relative to max|x|: the kernel's products within 1e-6 of the
f64 solve; one TF32 pass, and two passes on f32 factors, miss 1e-5 (the
card tests' tolerance against the plain f32 sweep).  The factors scaled by
16 (F ~ 1 instead of ~0.06) are the card test's
``test_fused_sweep_many_needs_the_lo_terms``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops import blocktri as jbt
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.blocktri import (BlockTriFactor,
                                                blocktri_solve, cast_factor)

from torch_parity import (CPU, random_band, sweep_tf32, tf32_round,
                          tf32_split)

K, NB, B, R = 4, 4, 64, 8
KERNEL_REL = 1e-6        # the kernel's products against the f64 solve
CARD_TOL = 1e-5          # the card tests' kernel-against-plain tolerance
F_SCALE = 16.0           # the lo terms' case of the card test


@pytest.fixture(scope="module")
def factor():
    """The f64 ``inv`` factor of a diagonally dominant band (hw 20)."""
    band = random_band(K * NB * B, 20, 20, seed=31)
    sf = tsp.spike_factor(banded_from_numpy(band, 20, 20, device=CPU), K=K,
                          block_b=B)
    assert sf.fact.F.shape == (K, NB, B, B)
    return sf.fact


@pytest.fixture(scope="module")
def rhs():
    return torch.from_numpy(
        np.random.default_rng(32).standard_normal((K, NB, B, R)))


def _scaled(fact, scale):
    return BlockTriFactor(F=fact.F * scale, U=fact.U, Sinv=fact.Sinv,
                          method="inv")


def _stored(fact, dtype):
    """The factor as the kernel reads it (f32 or bf16) and that factor
    promoted exactly to f64, the reference's input."""
    low = cast_factor(cast_factor(fact, torch.float32), dtype)
    return low, cast_factor(low, torch.float64)


def _jax_solve(fact, rhs):
    """The JAX package's f64 block-Thomas solve, one partition at a time."""
    fj = jbt.BlockTriFactor(F=jnp.asarray(fact.F.numpy()),
                            U=jnp.asarray(fact.U.numpy()),
                            Sinv=jnp.asarray(fact.Sinv.numpy()),
                            Slu=None, piv=None, method="inv")
    x = jax.vmap(jbt.blocktri_solve)(fj, jnp.asarray(rhs.numpy()))
    return torch.from_numpy(np.array(x))


def _rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0), (1.0 + 2.0 ** -12, 1.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
    (1.0 + 2.0 ** -10 + 2.0 ** -11, 1.0 + 2.0 ** -9), (-3.0, -3.0)])
def test_tf32_round_is_round_to_nearest_ties_away(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_tf32_split_parts_sum_to_f32_within_2_to_minus_21():
    x = torch.from_numpy(np.random.default_rng(33).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    hi, lo = tf32_split(x)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("scale", [1.0, F_SCALE])
def test_f64_reference_is_the_jax_solve(factor, rhs, scale):
    fact = _scaled(factor, scale)
    np.testing.assert_allclose(blocktri_solve(fact, rhs).numpy(),
                               _jax_solve(fact, rhs).numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("scale", [1.0, F_SCALE])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3),
                                          (torch.bfloat16, 2)])
def test_kernel_products_match_the_f64_solve(factor, rhs, scale, dtype,
                                             passes):
    """3xTF32 on f32 factors, 2xTF32 on bf16 factors: within 1e-6 of the
    f64 solve of the same stored factor (the plain f32 sweep: ~3e-7)."""
    low, ref_fact = _stored(_scaled(factor, scale), dtype)
    ref = _jax_solve(ref_fact, rhs)
    x = sweep_tf32(low, rhs.float(), passes)
    assert x.dtype == torch.float32 and x.shape == rhs.shape
    assert _rel(x, ref) <= KERNEL_REL


@pytest.mark.parametrize("scale", [1.0, F_SCALE])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 1),
                                          (torch.float32, 2),
                                          (torch.bfloat16, 1)])
def test_fewer_passes_miss_the_card_tolerance(factor, rhs, scale, dtype,
                                              passes):
    """One TF32 pass keeps ~3 digits (~4e-4 here); on f32 factors, A_lo v_hi
    matters as much as A_hi v_lo (two passes ~2.5e-4): each misses 1e-5,
    so a kernel that took any of these shortcuts would fail the card tests."""
    low, ref_fact = _stored(_scaled(factor, scale), dtype)
    ref = _jax_solve(ref_fact, rhs)
    assert _rel(sweep_tf32(low, rhs.float(), passes), ref) > CARD_TOL

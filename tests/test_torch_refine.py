"""The port's f64-grade refinement path against the JAX package: the f64
banded matvec (the plain version of ``csrc/band_matvec_f64.cu``), the
``-pc_<name>_factor_dtype`` PC, ``richardson`` and ``preonly``, and
``solve(A64, b64, ksp_type="richardson", pc_type="spike",
pc_spike_factor_dtype="f32", rtol=1e-12)`` end to end on a band built as
bench.py builds the flagship band, cut to n = 4096, w = 41, K = 8, b = 32,
with the flagship's PC options.

Tolerances: the f64 matvec at 3e-13 relative to native f64 (the JAX test's
bound for its emulated kernel) and at 1e-5 to the JAX kernel's interpret
path (its own plumbing bound: XLA:CPU reassociates the pair arithmetic);
the refinement with equal iteration counts and residual histories within
1e-3 relative per entry, above a floor of 1e-13 ||b|| where an f64 residual
is its own rounding (the f32 factors of the two packages differ at f32
roundoff); the factor-dtype PC apply at 1e-5 relative (f32 solves).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.ops.band import banded_matvec as j_matvec
from spike_petsc_tpu.ops.pallas.band_matvec import (
    banded_matvec_prepared_f64 as j_prepared_f64,
    prepare_banded_mv_f64 as j_prepare_f64)
from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
from spike_petsc_tpu_torch import convert
from spike_petsc_tpu_torch.convert import (banded_from_numpy,
                                           spike_factor_from_numpy)
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.ops.cuda import band_matvec_f64 as cbm64
from spike_petsc_tpu_torch.solvers.operator import as_matvec
from spike_petsc_tpu_torch.solvers.pc import PC
from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc

from torch_parity import CPU, jax_spike_to_numpy, random_band

N, K_HALF = 4096, 20
FLAGSHIP_PC = {"pc_spike_partitions": 8, "pc_spike_block": 32,
               "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
               "pc_spike_inverter": "newton_fixed"}
REFINE_PC = {**FLAGSHIP_PC, "pc_spike_factor_dtype": "f32"}


@pytest.fixture(scope="module")
def system():
    data = random_band(N, K_HALF, K_HALF, seed=0)
    b = np.random.default_rng(1).standard_normal(N)
    return data, b


def _bands(data):
    return (JBand(jnp.asarray(data), K_HALF, K_HALF),
            banded_from_numpy(data, K_HALF, K_HALF, device=CPU))


@pytest.mark.parametrize("n,kl,ku,interp", [
    (2048, 6, 6, True), (512, 60, 60, True), (4096, 100, 100, False),
    (1500, 150, 80, False)])
def test_plain_f64_matvec_matches_jax(n, kl, ku, interp):
    """w = 13, 121, 201 (the flagship width) and 231: from w = 121 on, the
    JAX interpret path loses its compensation.  The interpret path is run
    at two widths only (its compile takes ~20 s at w = 121 on a CPU)."""
    data = random_band(n, kl, ku, seed=9, dtype=np.float64, dominant=False)
    data = data * (1 + 1e-9)                 # not representable in f32
    x = np.random.default_rng(10).standard_normal(n)
    jb = JBand(jnp.asarray(data), kl, ku)
    ref = np.asarray(j_matvec(jb, jnp.asarray(x)))
    scale = np.abs(ref).max()
    prep = cbm64.prepare_banded_mv_f64(banded_from_numpy(data, kl, ku,
                                                         device=CPU))
    assert prep.d3.dtype == torch.float64
    got = cbm64.banded_matvec_prepared_f64(prep, torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert np.abs(got.numpy() - ref).max() / scale <= 3e-13
    if interp:
        ref = np.asarray(j_prepared_f64(j_prepare_f64(jb), jnp.asarray(x)))
        assert np.abs(got.numpy() - ref).max() / scale <= 1e-5


def test_f64_matvec_rule_and_cpu_route():
    """The rule admits f64 bands up to the kernel's width; on the CPU the
    'auto' route of an f64 band is the plain version and the explicit
    kernel routes run the kernel's plain version."""
    data = random_band(600, 3, 3, seed=6)
    band = banded_from_numpy(data, 3, 3, device=CPU)
    assert cbm64.banded_mv_f64_feasible(band)
    assert not cbm64.banded_mv_f64_feasible(
        tpkg.BandedMatrix(data=band.data.float(), kl=3, ku=3))
    assert not cbm64.banded_mv_f64_feasible(
        tpkg.BandedMatrix(data=torch.zeros((9000, 4097),
                                           dtype=torch.float64),
                          kl=2048, ku=2048))
    with pytest.raises(ValueError, match="banded_mv_f64_feasible"):
        cbm64.prepare_banded_mv_f64(
            tpkg.BandedMatrix(data=band.data.float(), kl=3, ku=3))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(600))
    assert as_matvec(band)[0]._route == "xla"
    mv, _, _ = as_matvec(band, impl="banded_cuda")
    assert mv._route == "banded_cuda_f64"
    np.testing.assert_allclose(mv(x).numpy(), as_matvec(band)[0](x).numpy(),
                               rtol=1e-13)


def test_conversions_default_to_the_card():
    """Every conversion puts its tensors on the card unless told otherwise;
    read from the signatures, so nothing is allocated here."""
    for fn in (convert.to_tensor, convert.banded_from_numpy,
               convert.blocktri_from_numpy,
               convert.blocktri_factor_from_numpy,
               convert.spike_factor_from_numpy):
        dev = inspect.signature(fn).parameters["device"].default
        assert torch.device(dev).type == "cuda", fn.__name__
    assert convert.to_tensor(np.ones(3), device=CPU).device == CPU


def _check_refinement(rj, rt, bnorm):
    assert rt.its == int(rj.its) and rt.its >= 2
    assert rt.reason == int(rj.reason) == 2             # CONVERGED_RTOL
    hj = np.asarray(rj.history)[: rt.its + 1]
    np.testing.assert_allclose(rt.history.numpy()[: rt.its + 1], hj,
                               rtol=1e-3, atol=1e-13 * bnorm)
    assert np.isnan(rt.history.numpy()[rt.its + 1:]).all()
    assert float(rj.rnorm) / bnorm <= 1e-12 and rt.rnorm / bnorm <= 1e-12


@pytest.mark.parametrize("extra", [{}, {"pc_spike_store_dtype": "bf16"}])
def test_refinement_matches_jax(system, extra):
    """f32 factors (and, on the ladder's second rung, bf16-stored ones) on
    an f64 band: richardson to 1e-12 in both packages."""
    data, b = system
    opts = {**REFINE_PC, **extra}
    jb, tb = _bands(data)
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type="richardson",
                    pc_type="spike", options=jpkg.Options(dict(opts)),
                    rtol=1e-12, maxit=30)
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type="richardson",
                    pc_type="spike", options=tpkg.Options(dict(opts)),
                    rtol=1e-12, maxit=30)
    assert rt.x.dtype == torch.float64
    _check_refinement(rj, rt, np.linalg.norm(b))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-11)


def test_refinement_on_jax_factor(system):
    """Solve parity apart from factor parity: the JAX f32 factor carried
    across, the port's richardson with the cast apply around it."""
    data, b = system
    jb, tb = _bands(data)
    sj = jsp.spike_factor(JBand(jnp.asarray(data.astype(np.float32)),
                                K_HALF, K_HALF), K=8, block_b=32,
                          store_spikes=True, spike_dtype=jnp.bfloat16,
                          inverter="newton_fixed")
    st = spike_factor_from_numpy(**jax_spike_to_numpy(sj), device=CPU)
    assert st.fact.F.dtype == torch.float32
    pc = PC(name="spike",
            apply=lambda r: tsp.spike_solve(st, r.float()).double())
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type="richardson",
                    pc_type="spike", options=jpkg.Options(dict(REFINE_PC)),
                    rtol=1e-12, maxit=30)
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type="richardson", pc=pc,
                    rtol=1e-12, maxit=30)
    _check_refinement(rj, rt, np.linalg.norm(b))


def test_richardson_scale_and_x0_match_jax(system):
    """``-ksp_richardson_scale`` damps the step; a nonzero x0 starts from
    its residual."""
    data, b = system
    jb, tb = _bands(data)
    x0 = np.random.default_rng(3).standard_normal(N)
    opts = {**FLAGSHIP_PC, "ksp_richardson_scale": 0.5}
    rj = jpkg.solve(jb, jnp.asarray(b), jnp.asarray(x0),
                    ksp_type="richardson", pc_type="spike",
                    options=jpkg.Options(dict(opts)), rtol=1e-6, maxit=40)
    rt = tpkg.solve(tb, torch.from_numpy(b), torch.from_numpy(x0),
                    ksp_type="richardson", pc_type="spike",
                    options=tpkg.Options(dict(opts)), rtol=1e-6, maxit=40)
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) == 2
    assert rt.its >= 15                        # halving: about 20 steps
    np.testing.assert_allclose(rt.history.numpy()[: rt.its + 1],
                               np.asarray(rj.history)[: rt.its + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


@pytest.mark.parametrize("with_x0", [False, True])
def test_preonly_matches_jax(system, with_x0):
    """One PC application: CONVERGED_ITS, a [2] history."""
    data, b = system
    jb, tb = _bands(data)
    opts = {**FLAGSHIP_PC, "pc_spike_spike_dtype": ""}
    x0 = np.full(N, 0.5) if with_x0 else None
    rj = jpkg.solve(jb, jnp.asarray(b),
                    None if x0 is None else jnp.asarray(x0),
                    ksp_type="preonly", pc_type="spike",
                    options=jpkg.Options(dict(opts)))
    rt = tpkg.solve(tb, torch.from_numpy(b),
                    None if x0 is None else torch.from_numpy(x0),
                    ksp_type="preonly", pc_type="spike",
                    options=tpkg.Options(dict(opts)))
    assert (rt.its, rt.reason) == (int(rj.its), int(rj.reason)) == (1, 4)
    assert rt.history.shape == (2,)
    np.testing.assert_allclose(rt.history[0].item(),
                               np.asarray(rj.history)[0], rtol=1e-14)
    assert rt.rnorm <= 1e-10 * np.linalg.norm(b)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-9)


def test_factor_dtype_pc_apply_matches_jax(system):
    """The f32-factor PC on an f64 band: its info, and its single and
    multi-RHS applies (f64 in, f64 out, f32 inside) against JAX's."""
    data, _ = system
    jb, tb = _bands(data)
    pj = j_make_pc("spike", jb, jpkg.Options(dict(REFINE_PC)))
    pt = t_make_pc("spike", tb, tpkg.Options(dict(REFINE_PC)))
    assert pt.info == pj.info == dict(
        partitions=8, block=32, tip=K_HALF, method="inv", truncated=False,
        factor_dtype="float32", spike_dtype="bfloat16")
    R = np.random.default_rng(4).standard_normal((N, 3))
    got = pt.apply(torch.from_numpy(R[:, 0]))
    ref = np.asarray(pj.apply(jnp.asarray(R[:, 0])))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    got_many = pt.apply_many(torch.from_numpy(R))
    ref_many = np.asarray(pj.apply_many(jnp.asarray(R)))
    assert got_many.dtype == torch.float64
    assert (np.abs(got_many.numpy() - ref_many).max()
            <= 1e-5 * np.abs(ref_many).max())
    # a factor dtype equal to the band's is no cast
    same = t_make_pc("spike", tb, tpkg.Options(
        {**FLAGSHIP_PC, "pc_spike_factor_dtype": "f64"}))
    assert "factor_dtype" not in same.info

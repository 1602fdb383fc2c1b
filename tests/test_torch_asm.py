"""PyTorch port, PCASM (restricted or basic additive Schwarz with overlap,
one batched truncated SPIKE factorization of the concatenated windows)
against the JAX package's, on the CPU, the cases of tests/test_asm.py.

The window length rounds up to a multiple of the block.  On the CPU the
default block is the tip size, as in JAX; on the card it is the kernels'
(64 or 128), so the windows differ there.  The parity cases that name a
block hold the port against JAX at that explicit ``-pc_asm_block``.

Tolerances (f64): one apply within 1e-12 of max|JAX|; iteration counts
and ``info`` exactly; solutions to the JAX test's tolerance; the transpose
the dense adjoint to 1e-12.  The bf16-stored case (f32): the JAX test's
own bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu import BandedMatrix as JBand
from spike_petsc_tpu import Options as JOptions
from spike_petsc_tpu import solve as j_solve
from spike_petsc_tpu import sparse as jsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
from spike_petsc_tpu_torch import BandedMatrix, Options, solve
from spike_petsc_tpu_torch.solvers.pc import make_pc


def _system(n=600, dominance=0.25, seed=5):
    a = problems.nonsym_banded(n, 3, 3, seed=seed, dominance=dominance)
    data, kl, ku = jsp.csr_to_banded_arrays(a)
    u = np.ones(n)
    return (a, JBand(data=jnp.asarray(data), kl=kl, ku=ku),
            BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku), u, a @ u)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _both(argv, system, **kw):
    """(JAX's result, the port's) of gmres + asm under ``argv``."""
    _, jA, tA, _, b = system
    jr = j_solve(jA, jnp.asarray(b), pc_type="asm",
                 options=JOptions.from_argv(argv.split()), **kw)
    r = solve(tA, torch.as_tensor(b), pc_type="asm",
              options=Options.from_argv(argv.split()), **kw)
    return jr, r


def test_asm_overlap_improves_convergence():
    """More overlap, fewer iterations; each count equal to JAX's."""
    system = _system()
    its = {}
    for ovl in (0, 3, 9):
        jr, r = _both(f"-pc_asm_overlap {ovl}", system, ksp_type="gmres",
                      rtol=1e-10, maxit=300)
        assert r.reason > 0 and r.its == int(jr.its)
        assert np.linalg.norm(r.x.numpy() - system[3]) < 1e-5
        its[ovl] = r.its
    assert its[9] < its[3] < its[0], its


def test_asm_basic_variant_matches_jax():
    system = _system()
    jr, r = _both("-pc_asm_type basic", system, ksp_type="gmres",
                  rtol=1e-10, maxit=300)
    assert r.reason > 0 and r.its == int(jr.its)
    assert np.linalg.norm(r.x.numpy() - system[3]) < 1e-6


@pytest.mark.parametrize("argv", [
    "", "-pc_asm_type basic -pc_asm_overlap 9",
    "-pc_asm_blocks 8 -pc_asm_block 8",
    "-pc_asm_blocks 4 -pc_asm_overlap 20 -pc_asm_block 16 -pc_asm_type basic",
    "-pc_asm_method lu -pc_asm_overlap 5",
    "-pc_asm_inverter newton -pc_asm_blocks 6"])
def test_asm_apply_and_info_match_jax(argv):
    """One apply, its transpose's, and ``info`` (blocks, overlap, type,
    block, window) against JAX's PC; an explicit block where one is
    named."""
    _, jA, tA, _, _ = _system()
    jp = j_make_pc("asm", jA, JOptions.from_argv(argv.split()))
    tp = make_pc("asm", tA, Options.from_argv(argv.split()))
    assert tp.info == jp.info
    r = np.random.default_rng(4).standard_normal(600)
    assert _rel(tp.apply(torch.as_tensor(r)),
                jp.apply(jnp.asarray(r))) <= 1e-12
    assert _rel(tp.transpose().apply(torch.as_tensor(r)),
                jp.transpose().apply(jnp.asarray(r))) <= 1e-12


def test_asm_overlap0_matches_bjacobi_truncation():
    _, _, tA, _, _ = _system(n=512)
    pa = make_pc("asm", tA, Options.from_argv(
        "-pc_asm_blocks 8 -pc_asm_overlap 0 -pc_asm_block 8".split()))
    pb = make_pc("bjacobi", tA, Options.from_argv(
        "-pc_bjacobi_blocks 8 -pc_bjacobi_block 8".split()))
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(512))
    np.testing.assert_allclose(pa.apply(r).numpy(), pb.apply(r).numpy(),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("asm_type", ["restrict", "basic"])
def test_asm_transpose_is_exact_adjoint(asm_type):
    n = 80
    a = problems.nonsym_banded(n, 2, 2, seed=2)
    data, kl, ku = jsp.csr_to_banded_arrays(a)
    pc = make_pc("asm", BandedMatrix(data=torch.as_tensor(data), kl=kl,
                                     ku=ku),
                 Options.from_argv(f"-pc_asm_blocks 4 -pc_asm_type "
                                   f"{asm_type}".split()))
    eye = torch.eye(n, dtype=torch.float64)
    M = torch.stack([pc.apply(e) for e in eye], dim=1).numpy()
    MT = torch.stack([pc.transpose().apply(e) for e in eye], dim=1).numpy()
    np.testing.assert_allclose(MT, M.T, rtol=1e-12, atol=1e-13)
    rng = np.random.default_rng(6)
    x, y = (torch.as_tensor(rng.standard_normal(n)) for _ in range(2))
    np.testing.assert_allclose(float(torch.dot(pc.apply(x), y)),
                               float(torch.dot(x, pc.transpose().apply(y))),
                               rtol=1e-10)


def test_asm_single_block_is_direct():
    system = _system(n=300)
    jr, r = _both("-pc_asm_blocks 1", system, ksp_type="gmres", rtol=1e-10,
                  maxit=10)
    assert r.its == int(jr.its) <= 2
    assert np.linalg.norm(r.x.numpy() - system[3]) < 1e-8


def test_asm_rejects_bad_options():
    _, _, tA, _, _ = _system(n=200)
    with pytest.raises(ValueError, match="restrict or basic"):
        make_pc("asm", tA, Options.from_argv("-pc_asm_type xxx".split()))
    with pytest.raises(ValueError, match="pc_asm_overlap"):
        make_pc("asm", tA, Options.from_argv("-pc_asm_overlap -1".split()))


def test_asm_with_bicg_transpose_path():
    """bicg applies PCApplyTranspose: the count equals JAX's."""
    system = _system(n=400, dominance=0.5)
    _, jA, tA, u, b = system
    jr = j_solve(jA, jnp.asarray(b), ksp_type="bicg", pc_type="asm",
                 rtol=1e-10, maxit=200)
    r = solve(tA, torch.as_tensor(b), ksp_type="bicg", pc_type="asm",
              rtol=1e-10, maxit=200)
    assert r.reason > 0 and r.its == int(jr.its)
    assert np.linalg.norm(r.x.numpy() - u) < 1e-6


def test_asm_bf16_store_dtype_with_outer_krylov():
    """-pc_asm_store_dtype bf16 on an f32 band: the outer gmres converges
    to the JAX test's bounds, and the PC says what it stored."""
    _, _, tA, u, b = _system(n=512, dominance=1.0)
    A32 = BandedMatrix(data=tA.data.float(), kl=tA.kl, ku=tA.ku)
    opts = Options.from_argv(
        "-pc_asm_store_dtype bf16 -pc_asm_overlap 6".split())
    res = solve(A32, torch.as_tensor(b, dtype=torch.float32),
                ksp_type="gmres", pc_type="asm", options=opts, rtol=1e-6,
                maxit=100)
    assert res.reason > 0
    rel = np.linalg.norm(res.x.double().numpy() - u) / np.linalg.norm(u)
    assert rel < 1e-4, rel
    assert make_pc("asm", A32, opts).info["store_dtype"] == "bfloat16"


def test_asm_solve_many_matches_columns():
    """PCASM has no multi-RHS apply (as in JAX): ``solve_many`` applies it
    column by column, each column's answer ``solve``'s."""
    from spike_petsc_tpu_torch import solve_many
    _, _, tA, _, _ = _system(n=300, dominance=0.5)
    pc = make_pc("asm", tA, Options())
    assert pc.apply_many is None
    B = torch.as_tensor(np.random.default_rng(9).standard_normal((300, 3)))
    res = solve_many(tA, B, ksp_type="gmres", pc=pc, rtol=1e-10, maxit=200)
    for j in range(3):
        rj = solve(tA, B[:, j], ksp_type="gmres", pc=pc, rtol=1e-10,
                   maxit=200)
        assert int(res.its[j]) == rj.its
        assert np.linalg.norm(res.x[:, j].numpy() - rj.x.numpy()) < 1e-10

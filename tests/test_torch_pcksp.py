"""PyTorch port, PCKSP (an inner Krylov solve as the preconditioner, its
options under the ``ksp_`` prefix) against the JAX package's, on the CPU
in f64, the cases of tests/test_pcksp.py.

Tolerances: one apply within 1e-12 of max|JAX|; outer iteration counts
and ``info`` exactly; solutions to the JAX test's tolerance; the adjoint
identity to 1e-10 relative (with an exact inner solve, preonly + lu,
where the PC is linear).
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
from spike_petsc_tpu_torch import BandedMatrix, Options, solve, solve_many
from spike_petsc_tpu_torch.solvers.pc import make_pc

from torch_parity import CPU

INNER = "-ksp_ksp_type gmres -ksp_pc_type bjacobi -ksp_ksp_rtol 1e-3"


def _system(n=200, dominance=0.3, seed=5):
    a = problems.nonsym_banded(n, 3, 3, seed=seed, dominance=dominance)
    data, kl, ku = jsp.csr_to_banded_arrays(a)
    u = np.ones(n)
    return (a, JBand(data=jnp.asarray(data), kl=kl, ku=ku),
            BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku), u, a @ u)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("transpose", [False, True])
def test_pcksp_fgmres_matches_jax(transpose):
    """fgmres with the inner gmres + bjacobi PC: the outer iteration count
    is JAX's; the answer to JAX's tolerance (``transpose=True``: A^T x = b
    with the inner solve transposed)."""
    a, jA, tA, u, b = _system()
    kw = dict(ksp_type="fgmres", pc_type="ksp", rtol=1e-10, maxit=100,
              transpose=transpose)
    jr = j_solve(jA, jnp.asarray(b), options=JOptions.from_argv(
        INNER.split()), **kw)
    r = solve(tA, torch.as_tensor(b), options=Options.from_argv(
        INNER.split()), **kw)
    assert r.reason > 0 and r.its == int(jr.its) <= 10
    ref = np.linalg.solve(a.toarray().T, b) if transpose else u
    assert np.linalg.norm(r.x.numpy() - ref) < 1e-8


def test_pcksp_apply_and_info_match_jax():
    _, jA, tA, _, _ = _system()
    jp = j_make_pc("ksp", jA, JOptions.from_argv(INNER.split()))
    tp = make_pc("ksp", tA, Options.from_argv(INNER.split()))
    assert tp.info == jp.info == dict(ksp="gmres", rtol=1e-3, maxit=50)
    r = np.random.default_rng(3).standard_normal(200)
    assert _rel(tp.apply(torch.as_tensor(r)),
                jp.apply(jnp.asarray(r))) <= 1e-12
    assert _rel(tp.transpose().apply(torch.as_tensor(r)),
                jp.transpose().apply(jnp.asarray(r))) <= 1e-12


def test_pcksp_nested_prefix_composition():
    """-ksp_banded_pc_type: a PCBANDED inside the inner KSP, three levels
    of prefix scoping, on a host (SciPy) operator placed on the CPU."""
    a = problems.nonsym_banded(300, 4, 4, seed=2)
    u = np.ones(300)
    b = a @ u
    argv = ("-ksp_ksp_type gmres -ksp_pc_type banded -ksp_pc_banded_kmax 2 "
            "-ksp_banded_pc_type spike -ksp_banded_pc_spike_partitions 4 "
            "-ksp_ksp_rtol 1e-4").split()
    kw = dict(ksp_type="fgmres", pc_type="ksp", rtol=1e-8, maxit=200)
    jr = j_solve(a, jnp.asarray(b), options=JOptions.from_argv(argv), **kw)
    r = solve(a, torch.as_tensor(b), options=Options.from_argv(argv), **kw)
    assert r.reason > 0 and r.its == int(jr.its)
    assert r.x.device == CPU
    assert np.linalg.norm(r.x.numpy() - u) / np.linalg.norm(u) < 1e-6


def test_pcksp_view_describes_hierarchy():
    _, _, tA, _, _ = _system()
    d = make_pc("ksp", tA, Options.from_argv(["-ksp_pc_type", "bjacobi"]))
    assert "PC ksp" in d.describe() and "bjacobi" in d.describe()
    assert make_pc("ksp", tA, Options()).inner is None


def test_pcksp_exact_inner_solve_converges_outer_in_one():
    a, jA, tA, u, b = _system(dominance=2.0)
    argv = "-ksp_ksp_type gmres -ksp_ksp_rtol 1e-14 -ksp_ksp_max_it 500"
    kw = dict(ksp_type="fgmres", pc_type="ksp", rtol=1e-10, maxit=10)
    jr = j_solve(jA, jnp.asarray(b), options=JOptions.from_argv(
        argv.split()), **kw)
    r = solve(tA, torch.as_tensor(b), options=Options.from_argv(
        argv.split()), **kw)
    assert r.reason > 0 and r.its == int(jr.its) <= 2
    assert np.linalg.norm(r.x.numpy() - u) < 1e-7


def test_pcksp_adjoint_identity_with_exact_inner_solve():
    """preonly + lu inside: the PC is the linear map A^-1, and its
    transpose (the inner solve transposed) its adjoint."""
    _, _, tA, _, _ = _system(dominance=1.0)
    pc = make_pc("ksp", tA, Options.from_argv(
        "-ksp_ksp_type preonly -ksp_pc_type lu".split()))
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal(200))
    y = torch.as_tensor(rng.standard_normal(200))
    np.testing.assert_allclose(float(torch.dot(pc.apply(x), y)),
                               float(torch.dot(x, pc.transpose().apply(y))),
                               rtol=1e-10)


def test_pcksp_solve_many_matches_columns():
    """PCKSP has no multi-RHS apply (as in JAX): ``solve_many`` applies it
    column by column, and each column's answer is ``solve``'s (an exact
    inner solve, so that the PC is the same linear map every time)."""
    _, _, tA, _, _ = _system(dominance=1.0)
    pc = make_pc("ksp", tA, Options.from_argv(
        "-ksp_ksp_type preonly -ksp_pc_type lu".split()))
    assert pc.apply_many is None
    B = torch.as_tensor(np.random.default_rng(9).standard_normal((200, 3)))
    res = solve_many(tA, B, ksp_type="gmres", pc=pc, rtol=1e-10, maxit=100)
    for j in range(3):
        rj = solve(tA, B[:, j], ksp_type="gmres", pc=pc, rtol=1e-10,
                   maxit=100)
        assert int(res.its[j]) == rj.its
        assert np.linalg.norm(res.x[:, j].numpy() - rj.x.numpy()) < 1e-10


def test_pc_registry_matches_jax():
    """``make_pc`` and ``-pc_type`` reach every PC type of the JAX
    package, no more and no fewer."""
    from spike_petsc_tpu.utils.registry import PRECONDITIONERS as JPCS
    from spike_petsc_tpu_torch.utils.registry import PRECONDITIONERS as TPCS
    import spike_petsc_tpu.solvers.ksp  # noqa: F401  (registers them all)
    import spike_petsc_tpu_torch.solvers.ksp  # noqa: F401
    assert set(TPCS.names()) == set(JPCS.names())
    assert {"sor", "ksp", "asm", "composite", "fieldsplit",
            "mg"} <= set(TPCS.names())

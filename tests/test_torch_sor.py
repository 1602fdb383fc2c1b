"""PyTorch port, the block-SSOR PC (``-pc_type sor``) against the JAX
package's, on the CPU in f64, the cases of tests/test_sor.py.

The port applies every SOR sweep as one block-Thomas solve on a factor
built at set-up (``solvers/pc.py`` ``_sor_factor``), where JAX scans the
block rows; so besides the parity with JAX's PC, each sweep type is held
against a literal numpy scan of JAX's formula (JAX ``solvers/pc.py``
``pc_sor``).

Tolerances: one apply within 1e-12 of max|JAX| (the two association
orders of ω L Dinv differ by rounding); iteration counts and ``info``
exactly; solutions to the JAX test's tolerance; the adjoint identity to
1e-10 relative.
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
from spike_petsc_tpu_torch.ops.blocktri import band_to_blocktri
from spike_petsc_tpu_torch.solvers.pc import make_pc

APPLY_TOL = 1e-12


def bands(a):
    """The same host CSR as a JAX band and a port band (CPU, f64)."""
    data, kl, ku = jsp.csr_to_banded_arrays(a)
    return (JBand(data=jnp.asarray(data), kl=kl, ku=ku),
            BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def sor_scan(band, b, omega, stype, its, r):
    """JAX's block SOR written out: the two block-triangular scans over
    the blocks of ``band`` (block ``b``) and the ``its`` sweeps."""
    T = band_to_blocktri(band, b)
    D, L, U = (t.numpy() for t in (T.D, T.L, T.U))
    Dinv = np.linalg.inv(D)
    nb, n = D.shape[0], r.shape[0]

    def fwd(v):
        y = np.zeros_like(v)
        y[0] = omega * Dinv[0] @ v[0]
        for i in range(1, nb):
            y[i] = omega * Dinv[i] @ (v[i] - L[i] @ y[i - 1])
        return y

    def bwd(v):
        z = np.zeros_like(v)
        z[-1] = omega * Dinv[-1] @ v[-1]
        for i in range(nb - 2, -1, -1):
            z[i] = omega * Dinv[i] @ (v[i] - U[i] @ z[i + 1])
        return z

    def sweep(v):
        if stype == "forward":
            return fwd(v)
        if stype == "backward":
            return bwd(v)
        t = fwd(v)
        s = np.einsum("nij,nj->ni", D, t) / omega
        return (2.0 - omega) / omega * bwd(s)

    def matvec(x):
        y = np.einsum("nij,nj->ni", D, x)
        y[1:] += np.einsum("nij,nj->ni", L[1:], x[:-1])
        y[:-1] += np.einsum("nij,nj->ni", U[:-1], x[1:])
        return y

    rp = np.zeros(nb * b)
    rp[:n] = r
    rb = rp.reshape(nb, b)
    z = sweep(rb)
    for _ in range(its - 1):
        z = z + sweep(rb - matvec(z))
    return z.reshape(-1)[:n]


@pytest.mark.parametrize("its", [1, 2])
@pytest.mark.parametrize("omega", [0.8, 1.0, 1.5])
@pytest.mark.parametrize("stype", ["symmetric", "forward", "backward"])
def test_sor_pseudo_factor_matches_the_literal_scan(stype, omega, its):
    """The one-solve form of each sweep type equals JAX's scans, for
    ω in {0.8, 1.0, 1.5} and 1 or 2 sweeps (block 4: nb = 50)."""
    a = problems.nonsym_banded(200, 3, 4, seed=40)
    _, tb = bands(a)
    pc = make_pc("sor", tb, Options({"pc_sor_type": stype,
                                     "pc_sor_omega": omega,
                                     "pc_sor_its": its}))
    r = np.random.default_rng(1).standard_normal(200)
    got = pc.apply(torch.as_tensor(r)).numpy()
    assert _rel(got, sor_scan(tb, 4, omega, stype, its, r)) <= APPLY_TOL


@pytest.mark.parametrize("stype", ["symmetric", "forward", "backward"])
def test_sor_apply_matches_jax(stype):
    """One apply, its transpose and ``info`` against JAX's PC (ω = 1.3,
    2 sweeps, the default block and block 8)."""
    a = problems.nonsym_banded(256, 3, 2, seed=42)
    jb, tb = bands(a)
    r = np.random.default_rng(2).standard_normal(256)
    for block in (None, 8):
        o = {"pc_sor_type": stype, "pc_sor_omega": 1.3, "pc_sor_its": 2}
        if block:
            o["pc_sor_block"] = block
        jp = j_make_pc("sor", jb, JOptions(dict(o)))
        tp = make_pc("sor", tb, Options(dict(o)))
        assert tp.info == jp.info
        assert _rel(tp.apply(torch.as_tensor(r)),
                    jp.apply(jnp.asarray(r))) <= APPLY_TOL
        assert _rel(tp.transpose().apply(torch.as_tensor(r)),
                    jp.transpose().apply(jnp.asarray(r))) <= APPLY_TOL


def test_ssor_cg_matches_jax():
    """SSOR accelerates cg: the iteration count equals JAX's, x = 1 to
    the JAX test's tolerance."""
    a = problems.spd_banded(400, 4, seed=41)
    jb, tb = bands(a)
    b = a @ np.ones(400)
    jr = j_solve(jb, jnp.asarray(b), ksp_type="cg", pc_type="sor",
                 rtol=1e-10, maxit=800)
    r_plain = solve(tb, torch.as_tensor(b), ksp_type="cg", rtol=1e-10,
                    maxit=800)
    r = solve(tb, torch.as_tensor(b), ksp_type="cg", pc_type="sor",
              rtol=1e-10, maxit=800)
    assert r.reason > 0 and r.its == int(jr.its) < r_plain.its
    np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("stype", ["forward", "backward"])
def test_sor_forward_backward_gmres_matches_jax(stype):
    a = problems.nonsym_banded(300, 3, 3, seed=43)
    jb, tb = bands(a)
    b = a @ np.ones(300)
    o = {"ksp_type": "gmres", "pc_type": "sor", "pc_sor_type": stype,
         "ksp_rtol": "1e-10", "ksp_max_it": "400"}
    jr = j_solve(jb, jnp.asarray(b), options=JOptions(dict(o)))
    r = solve(tb, torch.as_tensor(b), options=Options(dict(o)))
    assert r.reason > 0 and r.its == int(jr.its)
    np.testing.assert_allclose(r.x.numpy(), 1.0, rtol=1e-6, atol=1e-7)


def test_sor_omega_its_options_match_jax():
    a = problems.spd_banded(300, 3, seed=44)
    jb, tb = bands(a)
    b = a @ np.ones(300)
    its = []
    for o in ({"pc_sor_omega": "1.3"}, {"pc_sor_its": "3"}, {}):
        o = dict(o, ksp_type="cg", pc_type="sor", ksp_rtol="1e-10")
        jr = j_solve(jb, jnp.asarray(b), options=JOptions(dict(o)))
        r = solve(tb, torch.as_tensor(b), options=Options(dict(o)))
        assert r.reason > 0 and r.its == int(jr.its)
        its.append(r.its)
    assert its[1] <= its[2]     # more sweeps: no more outer iterations
    with pytest.raises(ValueError, match="pc_sor_omega"):
        make_pc("sor", tb, Options({"pc_sor_omega": "2.5"}))
    with pytest.raises(ValueError, match="pc_sor_type"):
        make_pc("sor", tb, Options({"pc_sor_type": "sideways"}))


@pytest.mark.parametrize("stype", ["symmetric", "forward", "backward"])
def test_sor_transpose_adjoint_identity(stype):
    """<M^-1 x, y> = <x, M^-T y>, where M^-T is the reversed sweep on A^T.
    For the symmetric sweep that is ``pc.transpose()``.  For forward and
    backward ``pc.transpose()`` is JAX's, the same sweep type on A^T,
    which is not the adjoint; the adjoint is built as the reversed PC on
    A^T."""
    from spike_petsc_tpu_torch.ops.band import banded_transpose
    reverse = {"symmetric": "symmetric", "forward": "backward",
               "backward": "forward"}
    a = problems.nonsym_banded(200, 2, 3, seed=45)
    _, tb = bands(a)
    pc = make_pc("sor", tb, Options({"pc_sor_type": stype,
                                     "pc_sor_its": 2}))
    adj = make_pc("sor", banded_transpose(tb), Options(
        {"pc_sor_type": reverse[stype], "pc_sor_its": 2}))
    assert adj.info["block"] == pc.info["block"]
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(200))
    y = torch.as_tensor(rng.standard_normal(200))
    lhs = float(torch.dot(pc.apply(x), y))
    np.testing.assert_allclose(lhs, float(torch.dot(x, adj.apply(y))),
                               rtol=1e-10)
    if stype == "symmetric":
        np.testing.assert_allclose(
            lhs, float(torch.dot(x, pc.transpose().apply(y))), rtol=1e-10)
    assert pc.transpose().transpose() is pc


@pytest.mark.parametrize("its", [1, 2])
def test_sor_apply_many_matches_columns(its):
    """``apply_many`` (one multi-column solve a sweep) against ``apply``
    column by column, forward and transposed."""
    a = problems.spd_banded(256, 3, seed=46)
    _, tb = bands(a)
    pc = make_pc("sor", tb, Options({"pc_sor_block": "8",
                                     "pc_sor_its": its}))
    R = torch.as_tensor(np.random.default_rng(6).standard_normal((256, 4)))
    for p in (pc, pc.transpose()):
        Z1 = p.apply_many(R)
        Z2 = torch.stack([p.apply(R[:, j]) for j in range(4)], dim=1)
        np.testing.assert_allclose(Z1.numpy(), Z2.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_ssor_symmetric_pc_is_symmetric():
    a = problems.spd_banded(128, 2, seed=47)
    _, tb = bands(a)
    pc = make_pc("sor", tb, Options())
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(128))
    y = torch.as_tensor(rng.standard_normal(128))
    np.testing.assert_allclose(float(torch.dot(pc.apply(x), y)),
                               float(torch.dot(x, pc.apply(y))), rtol=1e-10)


def test_sor_factor_takes_the_kernel_route_at_block_64():
    """The pseudo-factor is an ``inv`` factor with one partition: on a CUDA
    right-hand side ``sweep_route`` gives it #1 (nb = 4) or #9 (nb = 1000)
    at block 64, and the plain sweep at block 16 (decided from the
    factor's shape; no card needed)."""
    from spike_petsc_tpu_torch.ops.spike import sweep_route
    from spike_petsc_tpu_torch.solvers.pc import _sor_factor
    for nb, b, route in ((4, 64, "fused"), (1000, 64, "sweeps"),
                         (40, 16, "plain")):
        data = torch.rand(nb * b, 33, dtype=torch.float32)
        data[:, 16] += 40.0
        T = band_to_blocktri(BandedMatrix(data=data, kl=16, ku=16), b)
        fact = _sor_factor(T, torch.linalg.inv(T.D), 1.0, "symmetric")
        assert fact.F.shape == (1, nb, b, b) and fact.method == "inv"
        assert sweep_route(fact, b, torch.float32, True) == route

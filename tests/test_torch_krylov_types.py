"""PyTorch port, the transpose-free Krylov types and the gmres options,
against the JAX package: ``solve(A, b, ksp_type=...)`` for ``fgmres``,
``lgmres``, ``gcr``, ``cgs``, ``tfqmr``, ``bcgsl``, ``chebyshev``, ``cr``,
``minres``, ``symmlq`` and ``pipecg``; gmres with a right PC, the
unpreconditioned norm, each CGS refinement and the true-residual monitor;
the restarts of fgmres and lgmres, bcgsl's ell, chebyshev's bounds from
``-ksp_chebyshev_eigenvalues`` and ``-ksp_chebyshev_esteig``, and the
``-ksp_compute_eigenvalues`` text.

Inputs: seeded numpy bands (n = 512, half-bandwidth 4) handed to both
packages, f64, on the CPU (JAX with x64 on, as its own tests run).  The
nonsymmetric types run on a diagonally dominant random band, with no PC and
with a truncated spike PC of 64 partitions (block 8, so each solve takes a
few iterations); the symmetric types run on a symmetric dominant band with
no PC and with the truncated cholesky PC.

Tolerances: iteration counts and reasons equal; the residual history within
rtol 1e-8 with an absolute floor of 1e-12 of its first entry (the same
algebra in another summation order), NaN where JAX's is NaN; the solution
within atol 1e-8.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.solvers import krylov as jkr
from spike_petsc_tpu.solvers.operator import as_matvec as j_as_matvec
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.solvers import krylov as tkr
from spike_petsc_tpu_torch.solvers import ksp as tksp
from spike_petsc_tpu_torch.solvers.operator import as_matvec as t_as_matvec
from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc

from torch_parity import CPU, random_band, spd_band

N, HW = 512, 4
SPIKE = {"pc_spike_partitions": 64, "pc_spike_block": 8,
         "pc_spike_truncated": 1}
CHOLESKY = {"pc_cholesky_partitions": 64, "pc_cholesky_block": 8,
            "pc_cholesky_truncated": 1}
NONSYM = ("fgmres", "lgmres", "gcr", "cgs", "tfqmr", "bcgsl", "chebyshev")
SYM = ("cr", "minres", "symmlq", "pipecg")
# chebyshev without a PC needs bounds on A's spectrum: estimate them
NO_PC_OPTIONS = {"chebyshev": {"ksp_chebyshev_esteig": ""}}


def _problem(symmetric):
    data = (spd_band(N, HW, seed=3) if symmetric
            else random_band(N, HW, HW, seed=3))
    b = np.random.default_rng(4).standard_normal(N)
    return data, b


def _pc_for(ksp, with_pc):
    symmetric = ksp in SYM or ksp == "cg"
    if not with_pc:
        return symmetric, "none", {}
    return symmetric, *(("cholesky", CHOLESKY) if symmetric
                        else ("spike", SPIKE))


def _both(ksp, pc, opts, symmetric, capsys=None, **kw):
    """Both packages' ``solve`` on the same band and right-hand side; with
    ``capsys``, also what each printed."""
    data, b = _problem(symmetric)
    kw = dict(dict(rtol=1e-10, maxit=200), **kw)
    rj = jpkg.solve(JBand(jnp.asarray(data), HW, HW), jnp.asarray(b),
                    ksp_type=ksp, pc_type=pc,
                    options=jpkg.Options(dict(opts)), **kw)
    out_j = capsys.readouterr().out if capsys else None
    rt = tpkg.solve(banded_from_numpy(data, HW, HW, device=CPU),
                    torch.from_numpy(b), ksp_type=ksp, pc_type=pc,
                    options=tpkg.Options(dict(opts)), **kw)
    out_t = capsys.readouterr().out if capsys else None
    return rj, rt, out_j, out_t


def _history_close(ht, hj, its):
    hj = np.asarray(hj)[:its + 1]
    np.testing.assert_allclose(ht.numpy()[:its + 1], hj, rtol=1e-8,
                               atol=1e-12 * hj[0])
    assert np.isnan(ht.numpy()[its + 1:]).all()


def _same(rj, rt, min_its=1):
    assert rt.its == int(rj.its) >= min_its
    assert rt.reason == int(rj.reason)
    _history_close(rt.history, rj.history, rt.its)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    np.testing.assert_allclose(rt.rnorm, float(rj.rnorm), rtol=1e-6,
                               atol=1e-12 * float(np.asarray(rj.history)[0]))


@pytest.mark.parametrize("with_pc", [False, True], ids=["none", "pc"])
@pytest.mark.parametrize("ksp", NONSYM + SYM)
def test_type_matches_jax(ksp, with_pc):
    symmetric, pc, opts = _pc_for(ksp, with_pc)
    if not with_pc:
        opts = NO_PC_OPTIONS.get(ksp, {})
    rj, rt, _, _ = _both(ksp, pc, opts, symmetric)
    assert rt.reason > 0
    _same(rj, rt, min_its=3)


@pytest.mark.parametrize("kw", [
    dict(side="right"),
    dict(side="right", pc=False),
    dict(norm_type="unpreconditioned"),
    dict(norm_type="preconditioned"),
    dict(cgs_refinement="never"),
    dict(cgs_refinement="ifneeded"),
    dict(cgs_refinement="never", restart=4, pc=False),
    dict(monitor_true=True),
    dict(monitor_true=True, side="right"),
    dict(monitor_true=True, norm_type="unpreconditioned", restart=3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_gmres_options_match_jax(kw):
    """gmres's options, with and without the spike PC; the true history
    where the monitor or the unpreconditioned norm records one."""
    kw = dict(kw)
    with_pc = kw.pop("pc", True)
    symmetric, pc, opts = _pc_for("gmres", with_pc)
    rj, rt, _, _ = _both("gmres", pc, opts, symmetric, **kw)
    assert rt.reason > 0
    _same(rj, rt, min_its=2)
    if rj.true_history is None:
        assert rt.true_history is None
    else:
        _history_close(rt.true_history, rj.true_history, rt.its)


@pytest.mark.parametrize("ksp,kw", [
    ("fgmres", dict(restart=4)),
    ("fgmres", dict(monitor_true=True)),
    ("lgmres", dict(restart=4)),
    ("lgmres", dict(restart=6, aug=3, cgs_refinement="ifneeded")),
    ("lgmres", dict(restart=4, aug=0)),
    ("gcr", dict(restart=4)),
    ("bcgsl", dict(ell=1)),
    ("bcgsl", dict(ell=3)),
], ids=lambda v: v if isinstance(v, str)
    else "-".join(f"{k}={x}" for k, x in v.items()))
def test_restarts_and_degrees_match_jax(ksp, kw):
    """Several restart cycles without a PC (23 iterations at restart 4 or
    6), lgmres's augmentation, and bcgsl's degree (its history is NaN
    between the cycles' ends)."""
    rj, rt, _, _ = _both(ksp, "none", {}, False, **kw)
    assert rt.reason > 0
    _same(rj, rt, min_its=5)
    if ksp == "fgmres" and kw.get("monitor_true"):
        _history_close(rt.true_history, rj.true_history, rt.its)


@pytest.mark.parametrize("opts", [
    {"ksp_lgmres_augment": 3, "ksp_gmres_restart": 5, "ksp_type": "lgmres"},
    {"ksp_bcgsl_ell": 4, "ksp_type": "bcgsl"},
    {"ksp_gmres_cgs_refinement_type": "ifneeded", "ksp_pc_side": "right",
     "ksp_type": "gmres"},
    {"ksp_norm_type": "unpreconditioned", "ksp_type": "fgmres"},
], ids=["lgmres_augment", "bcgsl_ell", "gmres_flags", "fgmres_norm"])
def test_options_reach_the_types(opts):
    """The same through the options database."""
    rj, rt, _, _ = _both(None, "none", opts, False)
    assert rt.reason > 0
    _same(rj, rt, min_its=5)


@pytest.mark.parametrize("bad", [dict(norm_type="none"),
                                 dict(side="right",
                                      norm_type="preconditioned"),
                                 dict(cgs_refinement="sometimes")])
def test_gmres_refuses_what_jax_refuses(bad):
    """``norm_type`` "none", a preconditioned norm under a right PC and an
    unknown refinement are ValueErrors in both packages."""
    for pkg, band, b in (
            (jpkg, JBand(jnp.asarray(random_band(64, 1, 1)), 1, 1),
             jnp.ones(64)),
            (tpkg, banded_from_numpy(random_band(64, 1, 1), 1, 1,
                                     device=CPU), torch.ones(64))):
        with pytest.raises(ValueError):
            pkg.solve(band, b, ksp_type="gmres", **bad)


def _matvecs(symmetric, with_pc):
    """Each package's (operator apply, PC apply) on the same problem."""
    data, b = _problem(symmetric)
    _, pc, opts = _pc_for("cr" if symmetric else "gmres", with_pc)
    jb = JBand(jnp.asarray(data), HW, HW)
    tb = banded_from_numpy(data, HW, HW, device=CPU)
    jpc = jpkg.make_pc(pc, jb, jpkg.Options(dict(opts)))
    tpc = t_make_pc(pc, tb, tpkg.Options(dict(opts)))
    return ((j_as_matvec(jb)[0], jpc.apply if with_pc else None),
            (t_as_matvec(tb)[0], tpc.apply if with_pc else None), b)


@pytest.mark.parametrize("symmetric,with_pc", [(False, False), (False, True),
                                               (True, True)],
                         ids=["nonsym", "nonsym-spike", "spd-cholesky"])
def test_ritz_values_and_bounds_match_jax(symmetric, with_pc):
    """``estimate_extreme_eigs`` (seeded start and a given one) and
    ``chebyshev_esteig_bounds`` with the default and a given transform."""
    (jmv, jpc), (tmv, tpc), b = _matvecs(symmetric, with_pc)
    # with a PC the solve converges in 5-6 steps: past 4 the Arnoldi basis
    # is roundoff, and so are its Ritz values in either package
    steps = (3, 4) if with_pc else (10, 7)
    for kw in (dict(m=steps[0]), dict(m=steps[1], seed=5)):
        ej = jkr.estimate_extreme_eigs(jmv, N, jnp.float64, pc_apply=jpc,
                                       **kw)
        et = tkr.estimate_extreme_eigs(tmv, N, torch.float64, pc_apply=tpc,
                                       device=CPU, **kw)
        np.testing.assert_allclose(np.sort_complex(et), np.sort_complex(ej),
                                   rtol=1e-8, atol=1e-10)
        for tr in (jkr.ESTEIG_DEFAULT_TRANSFORM, (0.9, 0.0, 0.0, 1.05)):
            np.testing.assert_allclose(
                tkr.chebyshev_esteig_bounds(et, tr),
                jkr.chebyshev_esteig_bounds(ej, tr), rtol=1e-8)
    ej = jkr.estimate_extreme_eigs(jmv, N, jnp.float64, m=4, pc_apply=jpc,
                                   v0=jnp.asarray(b))
    et = tkr.estimate_extreme_eigs(tmv, N, torch.float64, m=4, pc_apply=tpc,
                                   v0=torch.from_numpy(b))
    np.testing.assert_allclose(np.sort_complex(et), np.sort_complex(ej),
                               rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="no Ritz values"):
        tkr.chebyshev_esteig_bounds(np.zeros(0))


@pytest.mark.parametrize("opts", [
    {"ksp_chebyshev_eigenvalues": "0.5,1.6"},
    {"ksp_chebyshev_esteig": "", "ksp_chebyshev_esteig_steps": 2},
    {"ksp_chebyshev_esteig": "0.5,0.0,0.0,1.2",
     "ksp_chebyshev_esteig_steps": 2},
    {"ksp_chebyshev_eigenvalues": "0.5,1.6", "ksp_chebyshev_esteig": ""},
], ids=["eigenvalues", "esteig", "esteig_transform_steps", "both"])
def test_chebyshev_bounds_from_options_match_jax(opts):
    """chebyshev with the spike PC on bounds from each option; the explicit
    bounds win when both are given.  The Arnoldi runs stop at 2 steps,
    before the basis nears roundoff (the default 10 steps estimate noise
    here, in either package; the option without a PC runs in
    ``test_type_matches_jax``)."""
    rj, rt, _, _ = _both("chebyshev", "spike", dict(SPIKE, **opts), False)
    assert rt.reason > 0
    _same(rj, rt, min_its=5)


def test_chebyshev_option_errors():
    data, b = _problem(False)
    tb = banded_from_numpy(data, HW, HW, device=CPU)
    for opts, match in (({"ksp_chebyshev_eigenvalues": "1"}, "emin,emax"),
                        ({"ksp_chebyshev_esteig": "1,2"}, "a,b,c,d")):
        with pytest.raises(ValueError, match=match):
            tpkg.solve(tb, torch.from_numpy(b), ksp_type="chebyshev",
                       options=tpkg.Options(opts))


NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _eig_lines(out):
    lines = out.splitlines()
    head = lines.index("Iteratively computed eigenvalues")
    return lines[head + 1:]


@pytest.mark.parametrize("ksp,with_pc", [("gmres", True), ("gmres", False),
                                         ("cg", True), ("tfqmr", True)])
def test_compute_eigenvalues_prints_what_jax_prints(capsys, ksp, with_pc):
    """``-ksp_compute_eigenvalues``: the same header and as many lines,
    each ``re + imi`` within 1e-5 of JAX's (the lines print 6 digits).  The
    solves stop at rtol 1e-6, so that the Arnoldi run of ``its`` steps
    ends before its basis turns to roundoff."""
    symmetric, pc, opts = _pc_for(ksp, with_pc)
    rj, rt, out_j, out_t = _both(
        ksp, pc, dict(opts, ksp_compute_eigenvalues=1), symmetric, capsys,
        rtol=1e-6)
    assert rt.its == int(rj.its)
    lj, lt = _eig_lines(out_j), _eig_lines(out_t)
    assert len(lt) == len(lj) == min(N, max(rt.its, 2), 30)
    for a, c in zip(lt, lj):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", c) == "# + #i"
        va = [float(v) for v in NUMBER.findall(a)]
        vc = [float(v) for v in NUMBER.findall(c)]
        np.testing.assert_allclose(va, vc, rtol=1e-5, atol=1e-9)


def test_monitor_true_residual_prints_what_jax_prints(capsys):
    """``-ksp_monitor_true_residual`` through ``solve(monitor=True)``: the
    three-column lines, word for word, numbers within 1e-8 with a floor of
    1e-12 of the first norm."""
    rj, rt, out_j, out_t = _both(
        "gmres", "spike", dict(SPIKE, ksp_monitor_true_residual=1), False,
        capsys, monitor=True)
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert len(lt) == len(lj) == rt.its + 2
    assert lt[-1] == lj[-1]
    first = float(NUMBER.findall(lj[0])[1])
    for a, c in zip(lt[:-1], lj[:-1]):
        assert "true resid norm" in a
        assert NUMBER.sub("#", a) == NUMBER.sub("#", c)
        np.testing.assert_allclose([float(v) for v in NUMBER.findall(a)],
                                   [float(v) for v in NUMBER.findall(c)],
                                   rtol=1e-8, atol=1e-12 * first)


def test_registry_and_refused_lists():
    """Every type of the JAX registry is registered, the five that iterate
    on A^T among them (each under JAX's function: cgne, cgnr and cgls are
    one), and ``make_solver`` gives exactly those five A^T and M^-T."""
    from spike_petsc_tpu.utils.registry import SOLVERS as JSOLVERS
    from spike_petsc_tpu_torch.utils.registry import SOLVERS as TSOLVERS
    transpose_types = {"bicg", "cgne", "cgnr", "cgls", "lsqr"}
    assert set(TSOLVERS.names()) == set(JSOLVERS.names())
    assert set(tksp._TRANSPOSE_TYPES) == transpose_types
    for name in transpose_types:
        assert (TSOLVERS.get(name).__name__
                == JSOLVERS.get(name).__name__), name

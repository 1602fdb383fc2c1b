"""PyTorch port, the KSP surface, against the JAX package: ``solve(...,
monitor=True)`` and ``view=True`` print what the JAX package prints,
``make_solver`` / ``make_solver_many`` take ``jit=``, and ``KSPResult``
has ``true_history``, ``converged`` and ``history_trimmed()``.

Inputs: seeded numpy bands (n = 1600) handed to both packages as numpy
arrays; JAX on the CPU with x64 on, as its own tests run.  The PCs are
truncated and store their factors in bf16, so each method takes several
iterations (2 to 15) and the monitor prints a real history.

Tolerances: residual norms parsed from the monitor lines within 1e-6
relative, with an absolute floor of 1e-12 of the first norm (f64, the same
algebra in another summation order); iteration numbers, words and the
converged-reason line equal.  ``jit=`` changes nothing in the port, so the
results with and without it are equal to the bit.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.solvers.types import reason_str

from torch_parity import CPU, random_band, spd_band

N, HW = 1600, 4
SPIKE = {"pc_spike_partitions": 16, "pc_spike_block": 8,
         "pc_spike_truncated": 1, "pc_spike_store_dtype": "bf16"}
CHOLESKY = {"pc_cholesky_partitions": 16, "pc_cholesky_block": 8,
            "pc_cholesky_truncated": 1, "pc_cholesky_store_dtype": "bf16"}
# (ksp, pc, options, symmetric band)
CASES = [("gmres", "spike", SPIKE, False), ("bcgs", "spike", SPIKE, False),
         ("cg", "spike", SPIKE, True),
         ("richardson", "spike", SPIKE, False),
         ("cg", "cholesky", CHOLESKY, True)]
IDS = [f"{k}-{p}" for k, p, _, _ in CASES]
# keys of the PC info line that differ between the packages by design
# (none today: both print partitions, block, tip, method and truncated)
INFO_DIFFERS_BY_DESIGN = {}
NUMBER = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")


def _problem(symmetric, seed=3):
    data = (spd_band(N, HW, seed=seed) if symmetric
            else random_band(N, HW, HW, seed=seed))
    # a weaker diagonal, so that the truncated PC leaves work to do
    data[:, HW] *= 0.6
    b = np.random.default_rng(seed + 1).standard_normal(N)
    return (JBand(jnp.asarray(data), HW, HW),
            banded_from_numpy(data, HW, HW, device=CPU), b)


def _both(capsys, ksp, pc, opts, symmetric, **kw):
    """Run both packages' ``solve`` with ``kw``; return (JAX result, its
    output, port result, its output)."""
    jb, tb, b = _problem(symmetric)
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type=ksp, pc_type=pc,
                    options=jpkg.Options(dict(opts)), rtol=1e-10, maxit=200,
                    **kw)
    out_j = capsys.readouterr().out
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type=ksp, pc_type=pc,
                    options=tpkg.Options(dict(opts)), rtol=1e-10, maxit=200,
                    **kw)
    out_t = capsys.readouterr().out
    return rj, out_j, rt, out_t


@pytest.mark.parametrize("ksp,pc,opts,symmetric", CASES, ids=IDS)
def test_monitor_prints_what_jax_prints(capsys, ksp, pc, opts, symmetric):
    rj, out_j, rt, out_t = _both(capsys, ksp, pc, opts, symmetric,
                                 monitor=True)
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert rt.its == int(rj.its) >= 2 and rt.reason == int(rj.reason) > 0
    assert len(lt) == len(lj) == rt.its + 2
    assert lt[-1] == lj[-1] == (
        f"Converged reason: {reason_str(rt.reason)} after {rt.its} its")
    first = None
    for a, c in zip(lt[:-1], lj[:-1]):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", c)   # words, iteration
        (va,), (vc,) = NUMBER.findall(a), NUMBER.findall(c)
        first = first or float(vc)
        assert abs(float(va) - float(vc)) <= 1e-6 * float(vc) + 1e-12 * first


@pytest.mark.parametrize("ksp,pc,opts,symmetric", CASES, ids=IDS)
def test_view_prints_what_jax_prints(capsys, ksp, pc, opts, symmetric):
    _, out_j, _, out_t = _both(capsys, ksp, pc, opts, symmetric, view=True)
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert len(lt) == len(lj)
    split = lj.index("PC Object:")
    assert lt[:split + 1] == lj[:split + 1]       # KSP Object, PC Object
    assert lt[0] == "KSP Object:" and lt[1] == f"  type: {ksp}"
    head_t, _, kv_t = lt[split + 1].partition(": ")
    head_j, _, kv_j = lj[split + 1].partition(": ")
    assert head_t == head_j == f"  PC {pc}"
    info_t = dict(p.split("=", 1) for p in kv_t.split(", "))
    info_j = dict(p.split("=", 1) for p in kv_j.split(", "))
    assert info_t.keys() == info_j.keys()
    for key in info_j:
        if key not in INFO_DIFFERS_BY_DESIGN:
            assert info_t[key] == info_j[key], key
    assert lt[split + 2:] == lj[split + 2:]


def test_view_without_pc(capsys):
    jb, tb, b = _problem(False)
    jpkg.solve(jb, jnp.asarray(b), ksp_type="gmres", view=True, maxit=3)
    out_j = capsys.readouterr().out
    tpkg.solve(tb, torch.from_numpy(b), ksp_type="gmres", view=True, maxit=3)
    assert capsys.readouterr().out == out_j
    assert out_j.splitlines()[-2:] == ["PC Object:", "  type: none"]


@pytest.mark.parametrize("ksp", ["gmres", "bcgs", "cg", "richardson"])
def test_gmres_family_take_monitor_and_view(capsys, ksp):
    """Every ported method accepts both keywords and prints both texts."""
    _, tb, b = _problem(ksp == "cg")
    res = tpkg.solve(tb, torch.from_numpy(b), ksp_type=ksp, pc_type="spike",
                     options=tpkg.Options(dict(SPIKE)), rtol=1e-8,
                     maxit=200, monitor=True, view=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "KSP Object:" and res.converged
    assert out[-1].startswith("Converged reason: CONVERGED_")
    assert sum("KSP Residual norm" in ln for ln in out) == res.its + 1


@pytest.mark.parametrize("ksp,opts", [
    ("bicg", {}), ("gmres", {"ksp_compute_singularvalues": "1"})],
    ids=["bicg", "singularvalues"])
def test_view_and_monitor_of_the_transpose_surface(capsys, ksp, opts):
    """What ``solve`` once refused, with ``view`` and ``monitor``: the
    view, the monitor lines and the singular-value line read as JAX's (the
    numbers within 1e-6 relative)."""
    rj, out_j, rt, out_t = _both(capsys, ksp, "spike", dict(SPIKE, **opts),
                                 False, view=True, monitor=True)
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) > 0
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert len(lt) == len(lj) and lt[0] == "KSP Object:"
    assert sum("KSP Residual norm" in ln for ln in lt) == rt.its + 1
    if opts:
        assert lt[-1].startswith("Iteratively computed extreme singular")
    number = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
    for a, c in zip(lt, lj):
        assert number.sub("#", a) == number.sub("#", c)
        va = [float(v) for v in number.findall(a)]
        vc = [float(v) for v in number.findall(c)]
        np.testing.assert_allclose(va, vc, rtol=1e-6, atol=1e-12)


def _same(r1, r2):
    assert torch.equal(r1.x, r2.x)
    assert torch.equal(torch.as_tensor(r1.its), torch.as_tensor(r2.its))
    assert torch.equal(torch.as_tensor(r1.reason),
                       torch.as_tensor(r2.reason))
    np.testing.assert_array_equal(r1.history.numpy(), r2.history.numpy())


@pytest.mark.parametrize("maker,jit", [("make_solver", False),
                                       ("make_solver", True),
                                       ("make_solver_many", False)])
def test_jit_keyword_changes_nothing(maker, jit):
    _, tb, b = _problem(False)
    make = getattr(tpkg, maker)
    rhs = torch.from_numpy(b if maker == "make_solver"
                           else np.stack([b, 2 * b], axis=1))
    kw = dict(ksp_type="gmres", pc_type="spike",
              options=tpkg.Options(dict(SPIKE)), rtol=1e-10)
    _same(make(tb, jit=jit, **kw)(rhs), make(tb, **kw)(rhs))


@pytest.mark.parametrize("ksp", ["gmres", "cg"])
def test_result_members_single_match_jax(ksp):
    jb, tb, b = _problem(ksp == "cg")
    opts = SPIKE
    rj = jpkg.solve(jb, jnp.asarray(b), ksp_type=ksp, pc_type="spike",
                    options=jpkg.Options(dict(opts)), rtol=1e-10)
    rt = tpkg.solve(tb, torch.from_numpy(b), ksp_type=ksp, pc_type="spike",
                    options=tpkg.Options(dict(opts)), rtol=1e-10)
    assert rt.true_history is None and rj.true_history is None
    assert rt.converged is True and bool(rj.converged)
    hj = np.asarray(rj.history_trimmed())
    ht = rt.history_trimmed()
    assert ht.shape == hj.shape == (rt.its + 1,)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=1e-6, atol=1e-12 * hj[0])
    # not converged: DIVERGED_ITS at maxit 1
    rt1 = tpkg.solve(tb, torch.from_numpy(b), ksp_type=ksp, pc_type="spike",
                     options=tpkg.Options(dict(opts)), rtol=1e-14, maxit=1)
    rj1 = jpkg.solve(jb, jnp.asarray(b), ksp_type=ksp, pc_type="spike",
                     options=jpkg.Options(dict(opts)), rtol=1e-14, maxit=1)
    assert rt1.converged is False and not bool(rj1.converged)
    assert rt1.history_trimmed().shape == (2,)


@pytest.mark.parametrize("ksp", ["bcgs", "cg"])
def test_result_members_batched_match_jax(ksp):
    """Per-column ``converged``.  JAX's ``history_trimmed`` takes
    ``int(its)``, which refuses the ``[r]`` its of a batched result; the
    port's trims to the largest ``its`` (a column past its own ``its``
    stays NaN), held against JAX's history cut there by hand."""
    jb, tb, b = _problem(ksp == "cg")
    B = np.stack([b, np.roll(b, 7), -b], axis=1)
    for cols in (B[:, :1], B):
        rj = jpkg.solve_many(jb, jnp.asarray(cols), ksp_type=ksp,
                             pc_type="spike",
                             options=jpkg.Options(dict(SPIKE)), rtol=1e-10)
        rt = tpkg.solve_many(tb, torch.from_numpy(cols), ksp_type=ksp,
                             pc_type="spike",
                             options=tpkg.Options(dict(SPIKE)), rtol=1e-10)
        assert rt.true_history is None and rj.true_history is None
        np.testing.assert_array_equal(rt.converged.numpy(),
                                      np.asarray(rj.converged))
        assert rt.converged.all()
        hj = np.asarray(rj.history)[:int(np.max(np.asarray(rj.its))) + 1]
        ht = rt.history_trimmed().numpy()
        assert ht.shape == hj.shape
        np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
        fin = ~np.isnan(hj)
        np.testing.assert_allclose(ht[fin], hj[fin], rtol=1e-6,
                                   atol=1e-12 * np.nanmax(hj))

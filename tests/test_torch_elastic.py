"""The port's ``resilient_solve`` (``parallel/elastic.py``) on four gloo
ranks against the JAX package's (virtual CPU devices): the nine
``resilient_solve`` scenarios of the JAX package's ``tests/test_elastic.py``
with its 8-device shapes halved (1-D 4 -> 2 ranks, multislice (2, 2) ->
(1, 2)), f64; ``test_torch_elastic_serve.py`` has the four
``resilient_serve`` ones.

For every scenario ``its``, ``segments``, ``failures`` and
``meshes_used`` equal JAX's on the same shapes, and x within 1e-10 of
JAX's (relative to its largest entry).  The JAX package's factors run
under ``jax.jit`` (``jitted``).
The in-segment failure is injected on every rank.  The checkpoints cross
over: each package resumes the file the other wrote (the JAX package's
files are written here before the ranks start, in the directory named by
``torch_dist_ms_cases.CKPT_DIR_ENV``).
"""

import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import spike_petsc_tpu.parallel.elastic as jel
from spike_petsc_tpu.ops.band import BandedMatrix

import torch_dist_ms_cases as M
from test_torch_dist import close, same_on_every_rank
from torch_dist_worker import run_ranks


def jband(data, kl, ku):
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def jitted(factor):
    """JAX's mesh factor under ``jax.jit`` (an eager ``shard_map`` is ~20x
    slower); the default inverter runs no Newton probe, so the factor is
    the one ``resilient_*`` builds."""
    def fn(band, mesh, **kw):
        return jax.jit(lambda d: factor(
            BandedMatrix(data=d, kl=band.kl, ku=band.ku), mesh,
            safety_net=False, **kw))(band.data)
    return fn


@pytest.fixture(scope="module", autouse=True)
def jit_jax_factors():
    import spike_petsc_tpu.parallel.spike_dist as jsd
    mp = pytest.MonkeyPatch()
    mp.setattr(jel, "dist_spike_factor", jitted(jsd.dist_spike_factor))
    mp.setattr(jsd, "dist_spike_factor_multislice",
               jitted(jsd.dist_spike_factor_multislice))
    yield
    mp.undo()


def jax_ckpt(spec, path):
    """The JAX package's first run of a checkpoint scenario to ``path``."""
    args, first, _ = spec
    data, kl, ku, u, b = M.elastic_problem(*args)
    try:
        jel.resilient_solve(jband(data, kl, ku), jnp.asarray(b),
                            ckpt_path=path, fault_injector=None
                            if "mesh_shape" in first
                            else M._stop_after_first, **first)
    except M.Stop:
        pass


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jit_jax_factors):
    tmp = tmp_path_factory.mktemp("elastic")
    jax_ckpt(M.CKPT_SOLVE, str(tmp / "jax_1d.npz"))
    jax_ckpt(M.CKPT_MS, str(tmp / "jax_ms.npz"))
    os.environ[M.CKPT_DIR_ENV] = str(tmp)
    try:
        out = run_ranks(4, "torch_dist_ms_cases:elastic_program", tmp)
    finally:
        del os.environ[M.CKPT_DIR_ENV]
    return out, tmp


def meshes(res):
    return [list(m) for m in res.meshes_used]


def check_solve(got, res, prefix=""):
    assert int(got[prefix + "its"]) == res.its
    assert int(got[prefix + "segments"]) == res.segments
    assert int(got[prefix + "failures"]) == res.failures
    assert int(got[prefix + "reason"]) == res.reason
    assert got[prefix + "meshes"].tolist() == meshes(res)
    close(got[prefix + "x"], res.x, 1e-10)


@pytest.mark.parametrize("name", list(M.ELASTIC_SOLVE))
def test_resilient_solve(ranks, name, monkeypatch):
    got = same_on_every_rank(ranks[0], "solve_" + name)
    args, opts, inj = M.ELASTIC_SOLVE[name]
    data, kl, ku, u, b = M.elastic_problem(*args)
    if name == "in_segment":
        real = jel.make_dist_solver
        calls = []

        def flaky_make(dsf, mesh, **kw):
            solver = real(dsf, mesh, **kw)

            def wrapped(r, x0=None):
                calls.append(True)
                if len(calls) == 1:
                    raise RuntimeError("injected: in-segment "
                                       "DEVICE_UNAVAILABLE")
                return solver(r, x0)
            return wrapped
        monkeypatch.setattr(jel, "make_dist_solver", flaky_make)
    res = jel.resilient_solve(jband(data, kl, ku), jnp.asarray(b),
                              fault_injector=None if inj is None
                              else M.fail_at(*inj), **M._options(opts))
    check_solve(got, res)
    if name == "maxit_clamped":
        assert res.its <= opts["maxit"]
    else:
        assert res.reason == 2                    # CONVERGED_RTOL
        close(got["x"], u, 1e-7)


@pytest.mark.parametrize("tag", ["1d", "ms"])
def test_checkpoint_crosses_packages(ranks, tag):
    """The port resumes the JAX package's file and JAX the port's: the
    resumed runs agree with each other and with the same-package resume."""
    out, tmp = ranks
    got = same_on_every_rank(out, "ckpt_" + tag)
    spec = M.CKPT_SOLVE if tag == "1d" else M.CKPT_MS
    args, first, again = spec
    data, kl, ku, u, b = M.elastic_problem(*args)
    mine = jel.SolveCheckpoint.load(str(tmp / f"torch_{tag}.npz"))
    theirs = jel.SolveCheckpoint.load(str(tmp / f"jax_{tag}.npz"))
    assert (mine.segments, mine.its_done) == (theirs.segments,
                                               theirs.its_done)
    assert int(got["ck_segments"]) == mine.segments >= 1
    assert int(got["ck_its"]) == mine.its_done >= 1
    np.testing.assert_array_equal(got["ck_x"], mine.x)
    close(mine.x, theirs.x, 1e-10)
    if tag == "1d":
        assert bool(got["stopped"])
    else:
        assert int(got["first_its"]) == first["maxit"]
    for src in ("torch", "jax"):
        copy = tmp / f"{src}_{tag}_resumed_by_jax.npz"
        shutil.copyfile(tmp / f"{src}_{tag}.npz", copy)
        res = jel.resilient_solve(jband(data, kl, ku), jnp.asarray(b),
                                  ckpt_path=str(copy), resume=True, **again)
        assert res.reason == 2
        check_solve(got, res, prefix=src + "_")
        close(got[src + "_x"], u, 1e-5)

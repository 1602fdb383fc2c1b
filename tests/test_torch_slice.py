"""The port's main path, end to end, against the JAX package:
``solve(A, b, ksp_type="gmres", pc_type="spike", options=...)`` on a
diagonally dominant band built as bench.py builds the flagship band, cut to
n=4096, w=41, K=8, b=32, with the flagship's PC options (stored bf16
spikes, newton_fixed inverter).

Tolerances: equal iteration counts and reasons; residual histories at rtol
1e-8 and solutions at 1e-8, in f64.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu_torch.convert import banded_from_numpy

from torch_parity import CPU, random_band

N, K_HALF = 4096, 20
FLAGSHIP_PC = {"pc_spike_partitions": 8, "pc_spike_block": 32,
               "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
               "pc_spike_inverter": "newton_fixed"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def system():
    data = random_band(N, K_HALF, K_HALF, seed=0)
    b = np.random.default_rng(1).standard_normal(N)
    return data, b


def _solve_both(data, b, options, **params):
    rj = jpkg.solve(jpkg.BandedMatrix(jnp.asarray(data), K_HALF, K_HALF),
                    jnp.asarray(b), options=jpkg.Options(dict(options)),
                    **params)
    rt = tpkg.solve(banded_from_numpy(data, K_HALF, K_HALF, device=CPU),
                    torch.from_numpy(b), options=tpkg.Options(dict(options)),
                    **params)
    return rj, rt


@pytest.mark.parametrize("extra", [{}, {"mat_matvec_impl": "banded_pallas"}])
def test_gmres_spike_slice_matches_jax(system, extra):
    data, b = system
    rj, rt = _solve_both(data, b, {**FLAGSHIP_PC, **extra},
                         ksp_type="gmres", pc_type="spike", rtol=1e-8,
                         restart=30, maxit=30)
    assert rt.its == int(rj.its) and rt.its >= 1
    assert rt.reason == int(rj.reason) == 2          # CONVERGED_RTOL
    hj = np.asarray(rj.history)
    np.testing.assert_allclose(rt.history.numpy()[: rt.its + 1],
                               hj[: rt.its + 1], rtol=1e-8)
    assert np.isnan(rt.history.numpy()[rt.its + 1:]).all()
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_recompute_spike_pc_matches_jax(system):
    """Spikes not stored: the PC is an exact solve, so the second residual
    sits at roundoff, compared with an absolute floor of 1e-12 ||r_0||."""
    data, b = system
    rj, rt = _solve_both(data, b, {**FLAGSHIP_PC, "pc_spike_store_spikes": 0},
                         ksp_type="gmres", pc_type="spike", rtol=1e-8)
    assert (rt.its, rt.reason) == (int(rj.its), int(rj.reason)) == (1, 2)
    hj = np.asarray(rj.history)[:2]
    np.testing.assert_allclose(rt.history.numpy()[:2], hj, rtol=1e-8,
                               atol=1e-12 * hj[0])
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_restarted_gmres_without_pc_matches_jax(system):
    """Several restart cycles (restart 4) and the maxit stop."""
    data, b = system
    rj, rt = _solve_both(data, b, {}, ksp_type="gmres", pc_type="none",
                         rtol=1e-12, restart=4, maxit=10)
    assert rt.its == int(rj.its) == 10
    assert rt.reason == int(rj.reason) == -3         # DIVERGED_ITS
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


@pytest.mark.parametrize("kwargs,match", [
    (dict(ksp_type="gmres", pc_type="spike",
          options={"pc_spike_check": 1}), "pc 'spike'"),
])
def test_unported_surface_raises(system, kwargs, match):
    """Once unported, ``-pc_spike_check`` now raises as JAX raises: a band
    whose first rows are zero has singular Schur pivots (the ``lapack``
    inverter leaves inf/NaN), and the check fails fast with
    ``FloatingPointError`` in both packages."""
    data, b = system
    data = data.copy()
    data[:K_HALF] = 0.0
    kwargs = dict(kwargs)
    opts = dict(kwargs.pop("options", {}), pc_spike_inverter="lapack")
    with pytest.raises(FloatingPointError, match="singular Schur pivots"):
        jpkg.solve(jpkg.BandedMatrix(jnp.asarray(data), K_HALF, K_HALF),
                   jnp.asarray(b), options=jpkg.Options(dict(opts)),
                   **kwargs)
    with pytest.raises(FloatingPointError, match=match):
        tpkg.solve(banded_from_numpy(data, K_HALF, K_HALF, device=CPU),
                   torch.from_numpy(b), options=tpkg.Options(opts),
                   **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(ksp_type="bicg", pc_type="spike"),
    dict(ksp_type="gmres", pc_type="spike", transpose=True),
    dict(ksp_type="gmres", pc_type="none",
         options={"ksp_compute_singularvalues": 1}),
    dict(ksp_type="gmres", pc_type="spike",
         options={"pc_spike_store_lt": 1}),
], ids=["bicg", "transpose", "singularvalues", "store_lt"])
def test_transpose_surface_matches_jax(capsys, system, kwargs):
    """The surface the port once refused, on the slice's band with the
    flagship's PC options: the same iterations, histories and x as JAX,
    and the same printed lines."""
    data, b = system
    kwargs = dict(kwargs)
    opts = {**FLAGSHIP_PC, **kwargs.pop("options", {})}
    rj, rt = _solve_both(data, b, opts, rtol=1e-8, maxit=200, **kwargs)
    out = capsys.readouterr().out.splitlines()
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason) > 0
    hj = np.asarray(rj.history)[:rt.its + 1]
    np.testing.assert_allclose(rt.history.numpy()[:rt.its + 1], hj,
                               rtol=1e-8, atol=1e-12 * hj[0])
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    if "ksp_compute_singularvalues" in opts:
        assert len(out) == 2 and out[0].split(":")[0] == out[1].split(":")[0]
        np.testing.assert_allclose(
            [float(v) for v in out[1].split()[-5::2]],
            [float(v) for v in out[0].split()[-5::2]], rtol=1e-8)


def test_spike_pc_surface(system):
    """The PC built alone: its info, and its transpose apply (M^-T r)
    against JAX's."""
    from spike_petsc_tpu.solvers.pc import make_pc as jmake_pc
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    data, b = system
    pc = make_pc("spike", banded_from_numpy(data, K_HALF, K_HALF, device=CPU),
                 tpkg.Options(dict(FLAGSHIP_PC)))
    assert pc.info == dict(partitions=8, block=32, tip=K_HALF, method="inv",
                           truncated=False, spike_dtype="bfloat16")
    jpc = jmake_pc("spike", jpkg.BandedMatrix(jnp.asarray(data), K_HALF,
                                              K_HALF),
                   jpkg.Options(dict(FLAGSHIP_PC)))
    got = pc.transpose().apply(torch.from_numpy(b)).numpy()
    ref = np.asarray(jpc.transpose().apply(jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import spike_petsc_tpu_torch, spike_petsc_tpu_torch.convert\n"
            "import spike_petsc_tpu_torch.ops.cuda._build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'spike_petsc_tpu.')) or "
            "m == 'spike_petsc_tpu')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

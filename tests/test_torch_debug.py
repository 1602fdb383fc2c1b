"""PyTorch port, ``utils.debug`` and ``-pc_<name>_check`` against the JAX
package: the typed factor health (``OK``, ``SINGULAR``,
``ILL_CONDITIONED``) of the same factors, JAX's
``test_pc_check_detects_singular`` matrix, ``check_finite`` and the f64
shadow run.  f64 on the CPU; the health codes equal, the peak magnitudes
within 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spike_petsc_tpu as jpkg
import spike_petsc_tpu_torch as tpkg
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu.utils import debug as jdbg
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops import spike as tsp
from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc
from spike_petsc_tpu_torch.utils import debug as tdbg

from torch_parity import CPU, random_band


def _singular_laplacian(n=64):
    """JAX's test matrix: the 1-D Laplacian with its first row and column
    zeroed around the diagonal (a singular leading block)."""
    a = problems.tridiag_laplacian(n).tolil()
    a[0, 0] = 0.0
    a[0, 1] = 0.0
    a[1, 0] = 0.0
    return a.tocsr()


def test_pc_check_detects_singular():
    """JAX's case, through the port's ``make_pc``: FloatingPointError."""
    opts = {"pc_spike_check": "1", "pc_spike_partitions": "4",
            "pc_spike_block": "4"}
    with pytest.raises(FloatingPointError):
        jpkg.make_pc("spike", _singular_laplacian(), jpkg.Options(dict(opts)))
    with pytest.raises(FloatingPointError, match="singular Schur pivots"):
        t_make_pc("spike", _singular_laplacian(), tpkg.Options(dict(opts)),
                     device=CPU)


@pytest.mark.parametrize("pc", ["spike", "cholesky"])
def test_pc_check_reports_ok(pc):
    """A healthy factor: ``info["health"]`` is OK (0) in both packages, and
    the PC applies as it does without the check."""
    a = problems.tridiag_laplacian(256)
    opts = {f"pc_{pc}_check": 1, f"pc_{pc}_partitions": 4,
            f"pc_{pc}_block": 8}
    pj = jpkg.make_pc(pc, a, jpkg.Options(dict(opts)))
    pt = t_make_pc(pc, a, tpkg.Options(dict(opts)), device=CPU)
    assert pt.info["health"] == int(pj.info["health"]) == tdbg.OK


@pytest.mark.parametrize("case", ["ok", "singular", "ill"])
def test_factor_health_matches_jax(case):
    """The same factor in both packages (a random band; its first rows
    zeroed for 'singular'; a nearly singular one, whose inverses exceed the
    1e6 growth threshold given, for 'ill')."""
    data = random_band(200, 2, 2, seed=4)
    if case == "singular":
        data[:2] = 0.0
    if case == "ill":
        data[:, 2] = 1e-9
        data[:, :2] = data[:, 3:] = 0.0
    kw = dict(K=4, block_b=5, inverter="lapack")
    st = tsp.spike_factor(banded_from_numpy(data, 2, 2, device=CPU), **kw)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), 2, 2), **kw)
    ht = tdbg.factor_health(st.fact, growth_threshold=1e6)
    hj = jdbg.factor_health(sj.fact, growth_threshold=1e6)
    assert ht.status == int(hj.status) == {"ok": tdbg.OK,
                                          "singular": tdbg.SINGULAR,
                                          "ill": tdbg.ILL_CONDITIONED}[case]
    assert ht.nonfinite == bool(hj.nonfinite)
    if case != "singular":
        np.testing.assert_allclose(ht.max_inverse_norm,
                                   float(hj.max_inverse_norm), rtol=1e-12)
    # the whole SpikeFactor scans too (its tips, reduced factor, spikes)
    assert tdbg.factor_health(st, growth_threshold=1e6).status == ht.status


def test_check_finite():
    tdbg.check_finite(torch.ones(3), "ones")
    x = torch.tensor([1.0, float("nan"), float("inf"), 2.0])
    with pytest.raises(FloatingPointError, match="x: 2/4 non-finite"):
        tdbg.check_finite(x, "x")
    with pytest.raises(FloatingPointError, match="x: 2/4 non-finite"):
        jdbg.check_finite(np.asarray(x), "x")


def test_shadow_check_matches_jax():
    """The f32 solve against its f64 shadow: the same deviation, within
    f32 rounding, in both packages."""
    data = random_band(300, 3, 3, seed=6).astype(np.float32)
    rhs = np.random.default_rng(7).standard_normal(300).astype(np.float32)

    def t_fn(d, b):
        band = tpkg.BandedMatrix(data=d, kl=3, ku=3)
        return tsp.spike_solve(tsp.spike_factor(band, K=4, block_b=8), b)

    def j_fn(d, b):
        band = JBand(d, 3, 3)
        return jsp.spike_solve(jsp.spike_factor(band, K=4, block_b=8), b)

    x, dev_t = tdbg.shadow_check(t_fn, torch.from_numpy(data),
                                 torch.from_numpy(rhs))
    _, dev_j = jdbg.shadow_check(j_fn, jnp.asarray(data), jnp.asarray(rhs))
    assert x.dtype == torch.float32
    assert 0 < dev_t < 1e-5 and 0 < dev_j < 1e-5
    np.testing.assert_allclose(dev_t, dev_j, rtol=0.5)

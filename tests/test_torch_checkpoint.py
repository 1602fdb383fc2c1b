"""PyTorch port, factor checkpoints (``io.save_factorization`` and
``io.load_factorization``) in the JAX package's ``.npz`` format, in both
directions: a file JAX writes loads in the port and solves to JAX's answer
(within 1e-12 in f64), and a file the port writes loads in JAX and solves
to the port's.  The variants of JAX's ``tests/test_cheby_ckpt.py``
(block-Thomas, K = 1, truncated, CR partitions, a CR reduced system, stored
f64 and bf16 spikes, stored L blocks) plus ``spd`` and ``lu`` factors, the
round-1 layout, and the leaf order the port writes down.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spike_petsc_tpu import io as jio
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops import spike as jsp
from spike_petsc_tpu.ops.band import BandedMatrix as JBand
from spike_petsc_tpu_torch import io as tio
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.ops import spike as tsp

from torch_parity import CPU, j2n, t2n

VARIANTS = {  # name: (n, k, dominance, spike_factor keyword arguments)
    "inv": (300, 3, 1.0, dict(K=4, block_b=8)),
    "k1": (240, 2, 20.0, dict(K=1)),
    "truncated": (240, 2, 20.0, dict(K=4, block_b=8, truncated=True)),
    "cr": (560, 2, 8.0, dict(K=4, block_b=8, method="cr")),
    "bigK_cr_reduced": (560, 2, 8.0, dict(K=40, block_b=4, reduced="cr")),
    "spikes": (560, 2, 8.0, dict(K=4, block_b=8, store_spikes=True)),
    "bf16_spikes": (560, 2, 8.0, dict(K=4, block_b=8, store_spikes=True,
                                      spike_dtype="bf16")),
    "cr_cr": (560, 2, 8.0, dict(K=4, block_b=8, method="cr", reduced="cr")),
    "store_lt": (560, 2, 8.0, dict(K=4, block_b=8, store_lt=True)),
    "lu": (300, 3, 1.0, dict(K=4, block_b=8, method="lu")),
    "spd_shift": (320, 2, None, dict(K=4, block_b=8, method="spd",
                                     shift="nonzero")),
}


def _problem(name):
    n, k, dom, kw = VARIANTS[name]
    if dom is None:
        a = problems.spd_banded(n, k, seed=3).toarray()
    else:
        a = problems.nonsym_banded(n, k, k, seed=9, dominance=dom).toarray()
    data = np.zeros((n, 2 * k + 1))
    for d in range(-k, k + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        data[rows, d + k] = a[rows, rows + d]
    kw = dict(kw)
    sdt = kw.pop("spike_dtype", None)
    kw_j = dict(kw, spike_dtype=jnp.bfloat16) if sdt else kw
    kw_t = dict(kw, spike_dtype=torch.bfloat16) if sdt else kw
    rhs = np.random.default_rng(2).standard_normal(n)
    return data, k, kw_j, kw_t, rhs


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, name):
    data, k, kw_j, _, rhs = _problem(name)
    sj = jsp.spike_factor(JBand(jnp.asarray(data), k, k), **kw_j)
    path = str(tmp_path / "jax.npz")
    jio.save_factorization(path, sj)
    st = tio.load_factorization(path, device=CPU)
    x = t2n(tsp.spike_solve(st, torch.from_numpy(rhs)))
    np.testing.assert_allclose(x, j2n(jsp.spike_solve(sj, jnp.asarray(rhs))),
                               rtol=0, atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    data, k, _, kw_t, rhs = _problem(name)
    st = tsp.spike_factor(banded_from_numpy(data, k, k, device=CPU), **kw_t)
    path = str(tmp_path / "port.npz")
    tio.save_factorization(path, st)
    sj = jio.load_factorization(path)
    x = t2n(tsp.spike_solve(st, torch.from_numpy(rhs)))
    np.testing.assert_allclose(j2n(jsp.spike_solve(sj, jnp.asarray(rhs))), x,
                               rtol=0, atol=1e-12 * np.abs(x).max())
    # and back: the port's own round trip is exact
    st2 = tio.load_factorization(path, device=CPU)
    assert torch.equal(tsp.spike_solve(st2, torch.from_numpy(rhs)),
                       tsp.spike_solve(st, torch.from_numpy(rhs)))
    if name == "store_lt":
        assert torch.equal(st2.Lb, st.Lb)
    if name == "bf16_spikes":
        assert st2.V.dtype == torch.bfloat16 and torch.equal(st2.V, st.V)


def test_leaf_order_is_jax_flatten_order():
    """The port's constant leaf order against JAX's pytree flatten of a
    factor holding every optional field (the paths of its leaves)."""
    data, k, kw_j, _, _ = _problem("bf16_spikes")
    sj = jsp.spike_factor(JBand(jnp.asarray(data), k, k), K=4, block_b=8,
                          store_spikes=True, store_lt=True, shift="nonzero")
    paths = [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in jax.tree_util.tree_flatten_with_path(sj)[0]]
    expect = []
    for f in tio.SPIKE_LEAF_FIELDS:
        v = getattr(sj, f)
        if f in ("fact", "red_fact"):
            expect += [f"{f}.{g}" for g in tio.BLOCKTRI_LEAF_FIELDS
                       if getattr(v, g) is not None]
        elif v is not None:
            expect.append(f)
    assert paths == expect and "fact.nshift" in paths and "Lb" in paths
    cr = jsp.spike_factor(JBand(jnp.asarray(data), k, k), K=4, block_b=8,
                          method="cr", shift="nonzero")
    paths = [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in jax.tree_util.tree_flatten_with_path(cr.fact)[0]]
    levels = [f"levels.{i}.{g}" for i in range(len(cr.fact.levels))
              for g in tio.CRLEVEL_LEAF_FIELDS]
    assert paths == levels + ["root_Dinv", "nshift"]
    assert tio.CR_LEAF_FIELDS == ("levels", "root_Dinv", "nshift")


def test_round_one_layout_loads(tmp_path):
    """A round-1 checkpoint (``method`` in the meta, no descriptors; the
    leaves of a block-Thomas factor without nshift) loads as JAX loads it."""
    data, k, kw_j, _, rhs = _problem("inv")
    sj = jsp.spike_factor(JBand(jnp.asarray(data), k, k), **kw_j)
    leaves = jax.tree_util.tree_leaves(sj)
    meta = dict(n=sj.n, K=sj.K, m=sj.m, b=sj.b, k=sj.k, truncated=False,
                method="inv")
    path = str(tmp_path / "r1.npz")
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        **{f"leaf_{i}": np.asarray(x)
                           for i, x in enumerate(leaves)})
    st = tio.load_factorization(path, device=CPU)
    x_j = j2n(jsp.spike_solve(jio.load_factorization(path),
                              jnp.asarray(rhs)))
    np.testing.assert_allclose(t2n(tsp.spike_solve(st, torch.from_numpy(rhs))),
                               x_j, rtol=0, atol=1e-12 * np.abs(x_j).max())


def test_layout_mismatch_raises(tmp_path):
    data, k, kw_j, _, _ = _problem("inv")
    sj = jsp.spike_factor(JBand(jnp.asarray(data), k, k), **kw_j)
    path = str(tmp_path / "bad.npz")
    jio.save_factorization(path, sj)
    z = dict(np.load(path))
    z.pop(f"leaf_{len([f for f in z if f.startswith('leaf_')]) - 1}")
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="layout mismatch"):
        tio.load_factorization(path, device=CPU)


def test_port_checkpoint_is_stored_without_deflate(tmp_path):
    """The port writes its archive with ``np.savez``: every member stored,
    none deflated (JAX's loader reads it, as the cases above show)."""
    import zipfile
    data, k, _, kw_t, _ = _problem("bf16_spikes")
    st = tsp.spike_factor(banded_from_numpy(data, k, k, device=CPU), **kw_t)
    path = str(tmp_path / "raw.npz")
    tio.save_factorization(path, st)
    with zipfile.ZipFile(path) as z:
        kinds = {m.compress_type for m in z.infolist()}
    assert kinds == {zipfile.ZIP_STORED}

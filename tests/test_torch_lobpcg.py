"""PyTorch port, ``ordering/lobpcg.py`` against
``jax.experimental.sparse.linalg.lobpcg_standard`` on the same operator and
start, and the Fiedler ordering's device LOBPCG paths
(``-mat_ordering_fiedler_method lobpcg``, ``-mat_ordering_fiedler_refine
device``) against the JAX package's, on the CPU in f64.

Tolerances: eigenvalues within 1e-10, iteration counts equal, eigenvectors
equal up to sign within 1e-8 (``eigh`` fixes no sign); the Fiedler cases
of tests/test_ordering.py (``lobpcg``, multilevel with ``refine="device"``)
with lambda2 within 1e-8 of JAX's and the ordering's bandwidth equal.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import sparse as jsparse
from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg

from spike_petsc_tpu import sparse as jsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu_torch.ordering.lobpcg import lobpcg_standard

from torch_parity import CPU

# the modules (each package's ``ordering.fiedler`` is also a function)
jfiedler = importlib.import_module("spike_petsc_tpu.ordering.fiedler")
tfiedler = importlib.import_module("spike_petsc_tpu_torch.ordering.fiedler")

THETA_TOL, U_TOL, LAM2_TOL = 1e-10, 1e-8, 1e-8


def _flipped_laplacian(lap):
    """The Fiedler operator of both packages on one Laplacian: c x - L x
    with the constant vector deflated."""
    c = float(2.0 * np.abs(lap).sum(axis=1).max())
    coo = lap.tocoo()
    jl = jsparse.BCOO((jnp.asarray(coo.data), jnp.stack(
        [jnp.asarray(coo.row), jnp.asarray(coo.col)], axis=1)),
        shape=lap.shape)
    tl = torch.as_tensor(lap.toarray())

    def jop(x):
        x = x - jnp.mean(x, axis=0, keepdims=True)
        y = c * x - jl @ x
        return y - jnp.mean(y, axis=0, keepdims=True)

    def top(x):
        x = x - x.mean(dim=0, keepdim=True)
        y = c * x - tl @ x
        return y - y.mean(dim=0, keepdim=True)
    return jop, top


def _dense_pair(a):
    return (lambda x: jnp.asarray(a) @ x), (lambda x: torch.as_tensor(a) @ x)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.linspace(1.0, 50.0, n)) @ q.T


CASES = {
    "lap2d_k1": lambda: (_flipped_laplacian(jsp.as_csr(
        jfiedler.graph_laplacian(problems.laplacian_2d(20, 20)))), 400, 1),
    "path_k1": lambda: (_flipped_laplacian(jfiedler.graph_laplacian(
        problems.tridiag_laplacian(300))), 300, 1),
    "spd_k2": lambda: (_dense_pair(_spd(120, 4)), 120, 2),
    "spd_k3": lambda: (_dense_pair(_spd(200, 5)), 200, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("m,tol", [(200, 1e-8), (7, None)])
def test_lobpcg_matches_jax(case, m, tol):
    (jop, top), n, k = CASES[case]()
    x0 = np.random.default_rng(9).standard_normal((n, k))
    jt, ju, ji = j_lobpcg(jop, jnp.asarray(x0), m=m, tol=tol)
    tt, tu, ti = lobpcg_standard(top, torch.as_tensor(x0), m=m, tol=tol)
    assert ti == int(ji)
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= THETA_TOL * max(
        1.0, np.abs(np.asarray(jt)).max())
    ju, tu = np.asarray(ju), tu.numpy()
    signs = np.sign(np.sum(ju * tu, axis=0))
    assert np.all(signs != 0)
    assert np.abs(tu * signs - ju).max() <= U_TOL


def test_lobpcg_rejects_what_jax_rejects():
    op = _dense_pair(np.eye(10))[1]
    with pytest.raises(ValueError, match="search dim"):
        lobpcg_standard(op, torch.ones(10, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="search dim > 0"):
        lobpcg_standard(op, torch.ones(10, 0, dtype=torch.float64))


def _scrambled(a, seed):
    n = a.shape[0]
    p = np.random.default_rng(seed).permutation(n)
    return jsp.permute(a, p, p)


@pytest.mark.parametrize("method,refine,n,seed", [
    ("lobpcg", "auto", 200, 3),          # tests/test_ordering.py:199-210
    ("multilevel", "device", 1500, 11),  # tests/test_ordering.py:259
])
def test_fiedler_device_lobpcg_matches_jax(method, refine, n, seed):
    a = _scrambled(problems.tridiag_laplacian(n), seed)
    jres = jfiedler.fiedler(a, method=method, refine=refine)
    tres = tfiedler.fiedler(a, method=method, refine=refine, device=CPU)
    assert abs(tres.info["lambda2"] - jres.info["lambda2"]) <= LAM2_TOL
    assert tres.info["bandwidth_out"] == jres.info["bandwidth_out"]
    assert tres.info["bandwidth_out"] <= (2 if method == "lobpcg" else 5)
    assert tres.info["bandwidth_in"] > tres.info["bandwidth_out"]
    assert np.array_equal(np.sort(tres.rperm), np.arange(n))


def test_fiedler_options_route_to_the_cpu():
    """``-platform cpu`` sends the ordering's device parts to the CPU (the
    testbed's placement); the LOBPCG event records its iterations."""
    from spike_petsc_tpu_torch.ordering import get_ordering
    from spike_petsc_tpu_torch.utils import profiling
    from spike_petsc_tpu_torch.utils.options import Options
    a = _scrambled(problems.tridiag_laplacian(200), 3)
    profiling.clear()
    res = get_ordering(a, "fiedler", Options.from_argv(
        "-mat_ordering_fiedler_method lobpcg -platform cpu".split()))
    ev = [e for e in profiling.event_log() if e["event"] == "fiedler_lobpcg"]
    assert len(ev) == 1 and ev[0]["device"] == "cpu"
    assert 0 < ev[0]["iterations"] <= 200
    assert "FiedlerLOBPCG" in profiling.stage_times()
    assert res.info["bandwidth_out"] <= 2


@pytest.mark.parametrize("tol,maxit", [(1e-8, None), (1e-12, 300)])
def test_fiedler_eigensolver_options_match_jax(tol, maxit):
    """``-mat_ordering_fiedler_tol`` and ``-mat_ordering_fiedler_max_it``
    (the port's; JAX's ``fiedler_vector`` takes them as ``tol`` and
    ``maxiter``) on config 4's scrambled matrix: lambda2 and the ordering
    as JAX's with the same settings."""
    from spike_petsc_tpu_torch.ordering import get_ordering
    from spike_petsc_tpu_torch.utils.options import Options
    n = 3000
    a = _scrambled(problems.general_sparse(n, seed=6), 2)
    lap = jfiedler.graph_laplacian(a)
    jvec, jlam = jfiedler.fiedler_vector(lap, method="lobpcg", tol=tol,
                                         maxiter=maxit)
    argv = ["-mat_ordering_fiedler_method", "lobpcg", "-platform", "cpu",
            "-mat_ordering_fiedler_tol", str(tol)]
    if maxit is not None:
        argv += ["-mat_ordering_fiedler_max_it", str(maxit)]
    res = get_ordering(a, "fiedler", Options.from_argv(argv))
    assert abs(res.info["lambda2"] - jlam) <= LAM2_TOL
    jperm = np.argsort(jvec, kind="stable")
    assert res.info["bandwidth_out"] == jsp.compute_bandwidth(
        jsp.permute(a, jperm, jperm))

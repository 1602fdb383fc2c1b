"""PyTorch port, the host ordering pipeline: the port's copies of
``sparse.py``, ``ordering/`` and ``native/`` against the JAX package's.

Both packages run the same NumPy/SciPy code (and the same C++ engine,
built twice from the same sources), so every ordering must give the same
``OrderingResult`` bit for bit: permutations, scalings and info.  The one
exception is ``fiedler(method="lanczos")``: SciPy's ARPACK draws its start
vector from its own generator, which advances on every call, so the JAX
package itself does not repeat its permutation from one call to the next;
there the Fiedler vector is compared up to sign (1e-8) and lambda2 to
1e-10 relative.
"""

import subprocess
import sys

import numpy as np
import pytest

from spike_petsc_tpu import sparse as jsp
from spike_petsc_tpu.models import problems as jproblems
from spike_petsc_tpu.ordering import get_ordering as j_get
from spike_petsc_tpu.ordering import fiedler as jfied
from spike_petsc_tpu.ordering import mc64 as jmc64
from spike_petsc_tpu.ordering import spectral_partition as j_part
from spike_petsc_tpu.utils.options import Options as JOptions
from spike_petsc_tpu_torch import sparse as tsp
from spike_petsc_tpu_torch.models import problems as tproblems
from spike_petsc_tpu_torch.native import loader
from spike_petsc_tpu_torch.ordering import get_ordering as t_get
from spike_petsc_tpu_torch.ordering import fiedler as tfied
from spike_petsc_tpu_torch.ordering import mc64 as tmc64
from spike_petsc_tpu_torch.ordering import spectral_partition as t_part
from spike_petsc_tpu_torch.ordering.fiedler import fiedler_vector, \
    graph_laplacian
from spike_petsc_tpu_torch.utils.options import Options

MATRICES = {
    "illscaled": lambda p: p.illscaled_nonsym(400, 4, 4, seed=3),
    "general": lambda p: p.general_sparse(300, seed=4),
    "lap2d": lambda p: p.laplacian_2d(20, 15),
    "mc64doc": lambda p: p.mc64_doc_example(),
    "zerodiag": lambda p: p.zero_diag_tridiag(200),
}


def _same_result(got, ref):
    for f in ("rperm", "cperm", "row_scale", "col_scale"):
        g, r = getattr(got, f), getattr(ref, f)
        assert (g is None) == (r is None), f
        if r is not None:
            np.testing.assert_array_equal(g, r, err_msg=f)
    assert got.info == ref.info


def _same_csr(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_problems_are_the_same_matrices(matrix):
    _same_csr(MATRICES[matrix](tproblems).tocsr(),
              MATRICES[matrix](jproblems).tocsr())


@pytest.mark.parametrize("name,argv", [
    ("wbm", ""), ("wbm", "-mat_ordering_wbm_symmetrize 1"),
    ("wbm", "-mat_ordering_wbm_job 4"), ("awbm", ""), ("rcm", ""),
    ("natural", ""), ("fiedler", "-mat_ordering_fiedler_method dense"),
    ("fiedler", "-mat_ordering_fiedler_method multilevel"),
    ("spectral", "")])
@pytest.mark.parametrize("matrix", ["illscaled", "general", "lap2d"])
def test_ordering_results_equal(name, argv, matrix):
    a = MATRICES[matrix](jproblems)
    ref = j_get(a, name, JOptions.from_argv(argv.split()))
    got = t_get(a, name, Options.from_argv(argv.split()))
    _same_result(got, ref)
    for scale in (False, True):        # the permuted (and scaled) matrix
        _same_csr(got.apply(a, scale=scale), ref.apply(a, scale=scale))


@pytest.mark.parametrize("job", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("matrix", ["illscaled", "mc64doc", "zerodiag"])
def test_mc64_jobs_equal(job, matrix):
    a = MATRICES[matrix](jproblems)
    _same_result(tmc64(a, job=job), jmc64(a, job=job))


def test_fiedler_lanczos_vector_matches():
    """ARPACK's own start vector differs call to call (module docstring):
    the vectors agree up to sign, lambda2 to 1e-10."""
    from spike_petsc_tpu.ordering.fiedler import fiedler_vector as j_fv
    lap = graph_laplacian(jproblems.laplacian_2d(30, 40), weighted=True)
    vj, lj = j_fv(lap, method="lanczos")
    vt, lt = fiedler_vector(lap, method="lanczos")
    vt = vt * np.sign(vt @ vj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-8)
    assert abs(lt - lj) <= 1e-10 * abs(lj)


def test_spectral_partition_equal():
    a = jproblems.laplacian_2d(24, 12)
    got, ref = t_part(a, levels=2), j_part(a, levels=2)
    np.testing.assert_array_equal(got.perm, ref.perm)
    assert got.sizes == ref.sizes and got.info == ref.info


@pytest.mark.parametrize("option", [
    "-mat_ordering_fiedler_method lobpcg",
    "-mat_ordering_fiedler_method multilevel "
    "-mat_ordering_fiedler_refine device"])
def test_fiedler_device_options_raise(option):
    """The device LOBPCG options (ported: they raised NotImplementedError
    before) run, under ``-platform cpu`` on the CPU, and give JAX's
    ordering: lambda2 within 1e-8, the bandwidth and profile equal.  The
    grid is 30 x 24: a square grid's lambda2 is double, its Fiedler vector
    any vector of a plane, so two solvers' orderings need not agree."""
    a = tproblems.laplacian_2d(30, 24)
    got = t_get(a, "fiedler", Options.from_argv(option.split()
                                                + ["-platform", "cpu"]))
    ref = j_get(a, "fiedler", JOptions.from_argv(option.split()))
    assert abs(got.info["lambda2"] - ref.info["lambda2"]) <= 1e-8
    for key in ("bandwidth_in", "bandwidth_out", "profile_in",
                "profile_out"):
        assert got.info[key] == ref.info[key], key


def test_fiedler_direct_call_equal():
    a = jproblems.nonsym_banded(500, 3, 2, seed=6)
    for kw in (dict(method="dense"), dict(method="dense", weighted=True),
               dict(method="multilevel")):
        _same_result(tfied(a, **kw), jfied(a, **kw))


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_sparse_diagnostics_equal(matrix):
    a = MATRICES[matrix](jproblems)
    for fn in ("compute_bandwidth", "compute_half_bandwidths",
               "diagonal_norm1", "count_zero_diagonals",
               "diagonal_weight_product", "matrix_profile"):
        assert getattr(tsp, fn)(a) == getattr(jsp, fn)(a), fn


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_sparse_transforms_equal(matrix):
    a = MATRICES[matrix](jproblems)
    n = a.shape[0]
    rng = np.random.default_rng(5)
    p, q = rng.permutation(n), rng.permutation(n)
    dr, dc = rng.uniform(0.5, 2, n), rng.uniform(0.5, 2, n)
    _same_csr(tsp.permute(a, p, q), jsp.permute(a, p, q))
    _same_csr(tsp.diagonal_scale(a, dr, dc), jsp.diagonal_scale(a, dr, dc))
    for kmax, frac in ((50, 0.95), (2, 0.9999), (50, 0.9999)):
        got = tsp.extract_banded(a, kmax=kmax, frac=frac)
        ref = jsp.extract_banded(a, kmax=kmax, frac=frac)
        assert (got.k, got.frac) == (ref.k, ref.frac)
        _same_csr(got.matrix.tocsr(), ref.matrix.tocsr())
        dg, klg, kug = tsp.csr_to_banded_arrays(got.matrix)
        dj, klj, kuj = jsp.csr_to_banded_arrays(ref.matrix)
        assert (klg, kug) == (klj, kuj)
        np.testing.assert_array_equal(dg, dj)


def test_native_engine_loads():
    """g++ builds the engine into build/torch_native (hash-named), and the
    matchings run through it."""
    assert loader.engine() == "native"
    assert loader._lib_path().exists()
    assert loader._lib_path().parent == loader.BUILD_DIR


def test_native_build_is_atomic(tmp_path):
    """Two processes building into an empty directory at once both load a
    whole library, and no temporary file is left behind."""
    code = ("import sys; from pathlib import Path; "
            "from spike_petsc_tpu_torch.native import loader; "
            "loader.BUILD_DIR = Path(sys.argv[1]); "
            "print(loader.engine())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert outs == ["native", "native"]
    assert [f.name for f in tmp_path.iterdir()] == [loader._lib_path().name]

"""PyTorch port, the PCs and operators of the testbed pipeline against
the JAX package's, on the CPU: the testbed on argv that drive the
``jacobi``, ``lu``, ``bjacobi``, ``spike`` and ``banded`` PCs and the split
operator (compared as in ``tests/test_torch_testbed.py``); each PC's
``apply`` built from a host (SciPy) pmat; and the host operator routes
(band+outliers split, sparse CSR, dense) against JAX's ``as_matvec``.

Tolerances: in f64 a PC apply within 1e-10 of max|JAX|, an operator
within 1e-12; the f32 port against JAX's f64 within 1e-4 (PC) and 1e-5
(operator) of max|JAX|.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.operator import as_matvec as j_as_matvec
from spike_petsc_tpu.solvers.pc import make_pc as j_make_pc
from spike_petsc_tpu.utils.options import Options as JOptions
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch.ops.band import BandedMatrix
from spike_petsc_tpu_torch.solvers.operator import as_matvec as t_as_matvec
from spike_petsc_tpu_torch.solvers.pc import make_pc as t_make_pc
from spike_petsc_tpu_torch.utils.options import Options

from torch_parity import CPU, compare_testbeds

CASES = {
    # the other PCs and operators the slice ports
    "awbm_random_sol_bcgs_lu": "-problem nonsym:500:3:3 "
                                "-mat_ordering_type awbm "
                                "-mat_ordering_scale 1 "
                                "-mat_ordering_type2 rcm -random_exact_sol 1 "
                                "-ksp_type bcgs -pc_type lu "
                                "-ksp_rtol 1e-12",
    "bjacobi_bcgs": "-problem nonsym:2000:3:3 -ksp_type bcgs "
                     "-pc_type bjacobi -pc_bjacobi_blocks 4 -ksp_rtol 1e-10",
    "split_operator_jacobi": "-problem general:2000 -ksp_type bcgs "
                             "-pc_type jacobi -pc_jacobi_type rowsum "
                             "-ksp_rtol 1e-10",
    "banded_pre_mat_spike": "-problem nonsym:1000:4:4 -banded_pre_mat 1 "
                            "-pc_banded_kmax 3 -pc_banded_frac 0.5 "
                            "-ksp_type bcgs -pc_type spike "
                            "-pc_spike_partitions 4 -ksp_rtol 1e-10",
    "diverged_its": "-problem tridiag:100 -ksp_type cg -ksp_max_it 2",
    "view_mat_wbm_lu": "-problem mc64doc -view_mat 1 "
                       "-mat_ordering_type wbm -mat_ordering_scale 1 "
                       "-ksp_type gmres -pc_type lu",
    # the factor methods and the pivot shift (tests/test_testbed.py:142)
    "spike_method_lu": "-problem nonsym:1000:4:4 -ksp_type gmres "
                       "-pc_type spike -pc_spike_partitions 4 "
                       "-pc_spike_method lu -ksp_rtol 1e-10 -ksp_view",
    "spike_method_cr": "-problem nonsym:1000:4:4 -ksp_type gmres "
                       "-pc_type spike -pc_spike_partitions 4 "
                       "-pc_spike_method cr -ksp_rtol 1e-10",
    "lu_method_lu": "-problem nonsym:500:3:3 -ksp_type bcgs -pc_type lu "
                    "-pc_lu_method lu -ksp_rtol 1e-12",
    "zerodiag_shift_spike": "-problem zerodiag:400 -ksp_type gmres "
                            "-pc_type spike -pc_spike_partitions 4 "
                            "-pc_spike_block 4 -pc_factor_shift_type nonzero "
                            "-ksp_rtol 1e-9 -ksp_view",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_testbed_matches_jax(case, capsys):
    rc, out = compare_testbeds(jtb.main, ttb.main, CASES[case].split(),
                               capsys)
    assert rc == (2 if case == "diverged_its" else 0)
    if "-ksp_view" in CASES[case]:
        # the PC line of -ksp_view, the shifted-pivot count included
        jtb.main(CASES[case].split())
        pc_line = [ln for ln in capsys.readouterr().out.splitlines()
                   if ln.strip().startswith("PC spike:")]
        assert pc_line and pc_line[0] in out.splitlines()
        assert ("shifted_pivots=" in pc_line[0]) == ("shift" in case)


PCS = {
    "jacobi": "", "jacobi_rowmax": "-pc_jacobi_type rowmax",
    "jacobi_rowsum": "-pc_jacobi_type rowsum", "jacobi_abs": "-pc_jacobi_abs 1",
    "lu": "", "bjacobi": "-pc_bjacobi_blocks 4",
    "bjacobi_block": "-pc_bjacobi_blocks 3 -pc_bjacobi_block 8",
    "banded": "-pc_banded_frac 0.9 -banded_pc_spike_partitions 4",
    "banded_lu": "-pc_banded_kmax 2 -banded_pc_type lu",
    "banded_bjacobi": "-banded_pc_type bjacobi -banded_pc_bjacobi_blocks 2",
    "spike": "-pc_spike_partitions 3",
}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(PCS))
def test_pc_apply_on_host_pmat(case, dtype):
    """The PC built from a host matrix lands on the given device and dtype
    and applies as JAX's does."""
    name = case.split("_")[0]
    a = problems.nonsym_banded(600, 3, 2, seed=12)
    if name == "banded":                    # out-of-band weight to drop
        a = (a + sp.random(600, 600, density=2e-3, random_state=3)).tocsr()
    argv = PCS[case].split()
    r = np.random.default_rng(13).standard_normal(600)
    ref = np.asarray(j_make_pc(name, a, JOptions.from_argv(argv))
                     .apply(jnp.asarray(r)))
    tdt = torch.float64 if dtype == "f64" else torch.float32
    pc = t_make_pc(name, a, Options.from_argv(argv), device=CPU, dtype=tdt)
    got = pc.apply(torch.as_tensor(r, dtype=tdt))
    assert got.dtype == tdt and got.device == CPU
    tol = 1e-10 if dtype == "f64" else 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_banded_pc_refuses_a_band():
    band = BandedMatrix(data=torch.ones((50, 3), dtype=torch.float64),
                        kl=1, ku=1)
    with pytest.raises(TypeError, match="already banded"):
        t_make_pc("banded", band, Options())


def test_host_pmat_defaults_to_the_card():
    from spike_petsc_tpu_torch.solvers.pc import _place
    placed = _place(problems.tridiag_laplacian(10))
    assert placed.device == torch.device("cuda")
    assert placed.dtype == torch.float64


OPERATORS = {
    # general_sparse: the split wins the cost model
    "split": lambda: problems.general_sparse(1500, seed=14),
    # far entries and no diagonal: the sparse CSR product wins
    "sparse_csr": lambda: sp.random(2000, 2000, density=1e-3,
                                    random_state=15).tocsr(),
    "dense": lambda: problems.nonsym_banded(300, 5, 5, seed=16).toarray(),
}
ROUTES = {"split": "split_xla", "sparse_csr": "sparse_csr", "dense": "dense"}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(OPERATORS))
def test_host_operator_routes(case, dtype):
    a = OPERATORS[case]()
    n = a.shape[0]
    x = np.random.default_rng(17).standard_normal(n)
    jmv, _, _ = j_as_matvec(a)
    ref = np.asarray(jmv(jnp.asarray(x)))
    tdt = torch.float64 if dtype == "f64" else torch.float32
    mv, m, dt = t_as_matvec(a, device=CPU, dtype=tdt)
    assert mv._route == ROUTES[case] and m == n and dt == tdt
    got = mv(torch.as_tensor(x, dtype=tdt))
    assert got.dtype == tdt
    tol = 1e-12 if dtype == "f64" else 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())

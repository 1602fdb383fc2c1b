"""PyTorch port, the testbed pipeline: ``spike_petsc_tpu_torch.testbed``
and ``testbed2`` against the JAX package's on the argv of
``tests/test_testbed.py`` and the verify recipe, on the CPU, and the
port's own rules (exit codes, ``-platform``, ``-x64``, unported options).

The JAX testbed runs under ``tests/conftest.py`` (x64 on, the CPU); the
port's gets the same argv plus ``-x64 1 -platform cpu``, so both solve in
f64 on the CPU.  ``torch_parity.compare_testbeds`` compares what they
print: exactly the exit code, the diagnostic lines (``Matrix:``,
``Reordered matrix using``, ``Reduced/Increased bandwidth``, ``Norm of
diagonal``, ``Zeros on the permuted diagonal``, ``Bandwidth of``,
``Device operator:``, ``Matrix is``, ``Converged reason``), the iteration
count and the reason; to 1e-8 of the initial residual norm the residual
history and ``rnorm``; to 1e-8 of ||u|| the ``Error in solution``.
"""

import numpy as np
import pytest
import torch

from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu import testbed2 as jtb2
from spike_petsc_tpu.io import write_mat
from spike_petsc_tpu.models import problems
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch import testbed2 as ttb2

from torch_parity import CPU, TESTBED_PORT_FLAGS, compare_testbeds

CASES = {
    # tests/test_testbed.py's argv
    "tridiag_preonly_lu": "-problem tridiag:500 -ksp_type preonly "
                          "-pc_type lu",
    "illscaled_config3": "-problem illscaled:400:4:4 -mat_ordering_type wbm "
                         "-mat_ordering_scale 1 -mat_ordering_type2 rcm "
                         "-banded_pre_mat 1 -pc_banded_frac 0.9999 "
                         "-ksp_type bcgs -pc_type banded -ksp_rtol 1e-10 "
                         "-banded_pc_spike_partitions 4",
    "petsc_binary_cg_jacobi": "-mat {mat} -ksp_type cg -pc_type jacobi "
                              "-ksp_rtol 1e-10",
    "lap2d_rcm_cg_lu": "-problem lap2d:20:10 -mat_ordering_type2 rcm "
                       "-ksp_type cg -pc_type lu -ksp_rtol 1e-10",
    # the verify recipe's flagship pipeline, at its size
    "illscaled_verify": "-problem illscaled:1500:6:6 -mat_ordering_type wbm "
                        "-mat_ordering_scale 1 -mat_ordering_type2 rcm "
                        "-banded_pre_mat 1 -pc_banded_frac 0.9999 "
                        "-ksp_type bcgs -pc_type banded -ksp_rtol 1e-10 "
                        "-banded_pc_spike_partitions 8",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_testbed_matches_jax(case, tmp_path, capsys):
    path = str(tmp_path / "mat.bin")
    write_mat(path, problems.spd_banded(300, 3, seed=5))
    argv = CASES[case].format(mat=path).split()
    rc, out = compare_testbeds(jtb.main, ttb.main, argv, capsys)
    assert rc == (2 if case == "diverged_its" else 0)


def test_testbed2_reports_symmetry(capsys):
    rc, out = compare_testbeds(jtb2.main, ttb2.main,
                       "-problem spd:300:2 -ksp_type cg -pc_type jacobi "
                       "-ksp_rtol 1e-10".split(), capsys)
    assert rc == 0 and "Matrix is symmetric" in out


@pytest.mark.parametrize("argv", [
    "-ksp_type gmres",                              # no matrix
    "-problem nosuch:10",                           # unknown problem
    "-problem tridiag:50 -pc_type nosuch",          # unknown PC
])
def test_bad_usage_exits_1(argv, capsys):
    assert ttb.main(argv.split() + TESTBED_PORT_FLAGS) == 1
    assert jtb.main(argv.split()) == 1


def test_platform_rules(monkeypatch, capsys):
    """No flag means the card, and no card is an error, never a quiet CPU
    run; -platform tpu is bad usage."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttb.main("-problem tridiag:50 -pc_type lu".split())
    assert ttb.main("-problem tridiag:50 -platform tpu".split()) == 1
    assert "-platform 'tpu'" in capsys.readouterr().err


def test_nullspace_and_singularvalue_options_match_jax(capsys):
    """-ksp_nullspace_constant runs: the Neumann Laplacian (singular, A 1 =
    0) with a random manufactured solution, gmres + jacobi, line by line
    against JAX's (the error compared up to the constant).  So does
    -ksp_compute_singularvalues: its line's numbers within 1e-8 relative
    of JAX's.  Its right-hand side is A u for a random u: with b = A 1 on
    the Dirichlet Laplacian (b = e_0 + e_{n-1}) the Krylov space of the
    symmetric vectors is invariant after ~n/2 steps, and the 60-step
    estimate past that is rounding noise in either package (a 1e-15
    perturbation of b moves JAX's own smallest value by 25%)."""
    rc, out = compare_testbeds(
        jtb.main, ttb.main,
        "-problem neumann:100 -ksp_type gmres -pc_type jacobi -ksp_rtol 1e-10 "
        "-ksp_nullspace_constant 1 -random_exact_sol 1".split(), capsys)
    assert rc == 0 and "CONVERGED_RTOL" in out
    argv = ("-problem tridiag:100 -ksp_type gmres -random_exact_sol 1 "
            "-ksp_compute_singularvalues 1").split()
    rc, out_t = compare_testbeds(jtb.main, ttb.main, argv, capsys)
    jtb.main(argv + ["-ksp_converged_reason"])
    out_j = capsys.readouterr().out

    def line(out):
        (got,) = [ln for ln in out.splitlines()
                  if ln.startswith("Iteratively computed extreme singular")]
        return [float(v) for v in got.split()[-5::2]]
    assert rc == 0
    np.testing.assert_allclose(line(out_t), line(out_j), rtol=1e-8)


def test_record_and_f32_placement(capsys):
    """Without -x64 the operator, b and the solution are f32 (here on the
    CPU); the record hands back the run's objects."""
    rec = {}
    rc = ttb.main("-problem illscaled:400:4:4 -mat_ordering_type wbm "
                  "-mat_ordering_scale 1 -mat_ordering_type2 rcm "
                  "-banded_pre_mat 1 -pc_banded_frac 0.9999 -ksp_type bcgs "
                  "-pc_type banded -ksp_rtol 1e-6 -platform cpu".split(),
                  record=rec)
    assert rc == 0
    assert rec["operator"].data.dtype == torch.float32
    assert rec["operator"].data.device == CPU
    assert rec["b"].dtype == rec["result"].x.dtype == torch.float32
    np.testing.assert_allclose(rec["result"].x.numpy(), rec["u"], atol=1e-4)

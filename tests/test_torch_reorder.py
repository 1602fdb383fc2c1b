"""PyTorch port, the host tools of the testbed pipeline against the JAX
package's, on the CPU: ``solve_reordered`` (KSPREORDER) on the three cases
of ``tests/test_testbed.py``, ``tools.wbm``'s printed lines and its
MatrixMarket export (and the export fed back to the testbed), and the
testbed's modules importing no JAX.

``solve_reordered``: the same iteration count and reason, the solution
within 1e-9 of max|x| (both in f64 on the CPU).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from spike_petsc_tpu import testbed as jtb
from spike_petsc_tpu.io import write_mat
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.tools import wbm as jwbm
from spike_petsc_tpu_torch import testbed as ttb
from spike_petsc_tpu_torch.tools import wbm as twbm

from torch_parity import CPU, compare_testbeds


# ---------------------------------------------------------------------------
# solve_reordered (KSPREORDER): tests/test_testbed.py's three cases
# ---------------------------------------------------------------------------

def _reorder_cases():
    from spike_petsc_tpu.sparse import permute
    a1 = problems.illscaled_nonsym(300, 3, 3, seed=7)
    a2 = problems.general_sparse(200, seed=9)
    rng = np.random.default_rng(1)
    p = rng.permutation(200)
    a2 = permute(a2, p, p)
    u2 = rng.uniform(size=200)
    a3 = problems.nonsym_banded(150, 2, 2, seed=11)
    u3 = np.random.default_rng(2).standard_normal(150)
    return {
        "wbm_scaled": (a1, a1 @ np.ones(300), dict(
            ordering="wbm", scale=True, ksp_type="gmres", pc_type="lu",
            rtol=1e-12), ""),
        "options_prefix": (a2, a2 @ u2, {},
                           "-mat_ordering_type rcm -reorder_ksp_type gmres "
                           "-reorder_pc_type banded "
                           "-reorder_pc_banded_frac 0.9999 "
                           "-reorder_ksp_rtol 1e-11"),
        "identity_consistency": (a3, a3 @ u3, dict(
            ordering="rcm", ksp_type="gmres", pc_type="lu", rtol=1e-12), ""),
    }


@pytest.mark.parametrize("case", ["wbm_scaled", "options_prefix",
                                  "identity_consistency"])
def test_solve_reordered_matches_jax(case):
    from spike_petsc_tpu.solvers.reorder import solve_reordered as j_sr
    from spike_petsc_tpu.utils.options import Options as JOptions
    from spike_petsc_tpu_torch.solvers.reorder import solve_reordered as t_sr
    from spike_petsc_tpu_torch.utils.options import Options
    a, b, kw, argv = _reorder_cases()[case]
    ref = j_sr(a, b, options=JOptions.from_argv(argv.split()), **kw)
    got = t_sr(a, b, options=Options.from_argv(argv.split()), device=CPU,
               dtype=torch.float64, **kw)
    assert int(got.its) == int(ref.its) and int(got.reason) == int(ref.reason)
    assert int(got.reason) > 0
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(got.x.numpy(), x_ref, rtol=0,
                               atol=1e-9 * np.abs(x_ref).max())
    r = np.linalg.norm(a @ got.x.numpy() - b) / np.linalg.norm(b)
    assert r < 1e-9


# ---------------------------------------------------------------------------
# tools.wbm: the printed lines and the MatrixMarket export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    "-matching mc64 -scale 1", "-matching mc64 -mc64_job 4",
    "-matching awbm -scale 1", "-matching awbm",
    "-matching mc64 -scale 1 -filename {mat}"])
def test_wbm_tool_matches_jax(argv, tmp_path, capsys):
    mat = str(tmp_path / "a.bin")
    write_mat(mat, problems.illscaled_nonsym(120, 2, 2, seed=8))
    outs, files = [], []
    for tag, main in (("jax", jwbm.main), ("torch", twbm.main)):
        path = str(tmp_path / f"{tag}.mtx")
        assert main(argv.format(mat=mat).split()
                    + ["-outfilename", path]) == 0
        outs.append(capsys.readouterr().out.replace(path, "OUT"))
        files.append(open(path).read())
    assert outs[0] == outs[1]
    assert files[0] == files[1]


def test_wbm_export_feeds_lu(tmp_path, capsys):
    """The verify recipe: the mc64 export fed back to the testbed."""
    path = str(tmp_path / "p.mtx")
    assert twbm.main(f"-matching mc64 -scale 1 -outfilename {path}".split()) \
        == 0
    capsys.readouterr()
    compare_testbeds(jtb.main, ttb.main,
             f"-mat {path} -ksp_type gmres -pc_type lu".split(), capsys)


def test_wbm_auction_raises(capsys):
    """``-matching auction`` (ported: it raised NotImplementedError before)
    runs the device auction, under ``-platform cpu`` on the CPU, and prints
    the JAX tool's lines."""
    assert jwbm.main("-matching auction -scale 1".split()) == 0
    ref = capsys.readouterr().out
    assert twbm.main("-matching auction -scale 1 -platform cpu".split()) == 0
    assert capsys.readouterr().out == ref
    assert "'type': 'auction'" in ref


def test_testbed_imports_no_jax():
    code = ("import sys, spike_petsc_tpu_torch.testbed, "
            "spike_petsc_tpu_torch.testbed2, spike_petsc_tpu_torch.tools.wbm, "
            "spike_petsc_tpu_torch.solvers.reorder; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

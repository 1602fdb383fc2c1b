"""Recipes of the PCs ``sor``, ``asm``, ``ksp``, ``composite``,
``fieldsplit`` and ``mg`` on config 2's matrix family (an SPD band of
half-bandwidth 16) at a small size, and one solve of a recipe on a device
in f32 beside the CPU in f64.  This is the card-against-CPU check that the
card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import numpy as np
import torch

# (pc_type, options, ksp_type); composite and fieldsplit slice the host CSR,
# the others take the band; the fieldsplit sizes sum to the default n
PC_RECIPES = (
    ("sor", "-pc_sor_block 64", "cg"),
    ("sor", "-pc_sor_type forward", "gmres"),
    ("asm", "-pc_asm_block 64 -pc_asm_overlap 32", "gmres"),
    ("ksp", "-ksp_ksp_type gmres -ksp_pc_type spike "
     "-ksp_pc_spike_partitions 8 -ksp_pc_spike_block 64", "fgmres"),
    ("composite", "-pc_composite_pcs jacobi,bjacobi "
     "-sub_1_pc_bjacobi_block 64", "gmres"),
    ("composite", "-pc_composite_pcs jacobi,bjacobi "
     "-pc_composite_type multiplicative -sub_1_pc_bjacobi_block 64",
     "gmres"),
    ("fieldsplit", "-pc_fieldsplit_type schur", "fgmres"),
    ("fieldsplit", "-pc_fieldsplit_type multiplicative "
     "-pc_fieldsplit_sizes 5000,7000,8000", "gmres"),
    ("mg", "", "cg"),
    ("mg", "-pc_mg_smoother sor -mg_smoother_pc_sor_block 64", "cg"))

RTOL = 1e-6          # near f32's floor for a solve of this size
ITS_SLACK = 1        # iteration counts within 1 (f32 rounding)
X_TOL = 1e-4         # max|x_device - x_cpu| / max|x_cpu|


def solve_recipe(pc_type: str, argv: str, ksp: str, device, n: int = 20000,
                 k: int = 16, seed: int = 37):
    """Solve ``problems.spd_banded(n, k, seed)`` (right-hand side from
    ``seed + 1``) with the recipe at RTOL on ``device`` in f32 and on the
    CPU in f64.  Returns (device result, CPU result, max|dx| / max|x|)."""
    from .. import sparse as hsp
    from ..convert import banded_from_numpy
    from ..solvers import solve
    from ..utils.options import Options
    from . import problems
    a = problems.spd_banded(n, k, seed=seed)
    b = a @ np.random.default_rng(seed + 1).standard_normal(n)
    opts = Options.from_argv(argv.split() + [
        "-ksp_type", ksp, "-pc_type", pc_type, "-ksp_rtol", str(RTOL)])
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    res = []
    for dev, npdt, dt in ((device, np.float32, torch.float32),
                          ("cpu", np.float64, torch.float64)):
        op = (a if pc_type in ("composite", "fieldsplit") else
              banded_from_numpy(data.astype(npdt), kl, ku, device=dev))
        res.append(solve(op, torch.as_tensor(b, dtype=dt, device=dev),
                         options=opts, maxit=500))
    dev_res, cpu = res
    err = float((dev_res.x.cpu().double() - cpu.x).abs().max()
                / cpu.x.abs().max())
    return dev_res, cpu, err


def recipe_agrees(dev_res, cpu, err: float) -> bool:
    """Both converged, the counts within ITS_SLACK, the answers within
    X_TOL."""
    return (dev_res.reason > 0 and cpu.reason > 0
            and abs(dev_res.its - cpu.its) <= ITS_SLACK and err <= X_TOL)

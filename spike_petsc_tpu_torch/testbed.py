"""End-to-end testbed (reference testbed.c / testbed2.c equivalent).

Reproduces the reference harness flow (reference/src/testbed.c:180-330):
load matrix -> (up to two) reorderings with bandwidth/diagonal diagnostics ->
optional banded preconditioner matrix -> manufactured solution u=1 (or
random) -> b = A u -> KSP solve -> report ||x - u||_2.  All reference flags
are honored (-mat, -mat_ordering_type, -mat_ordering_type2, -banded_pre_mat,
-random_exact_sol, -ksp_*, -pc_*), plus synthetic problem sources since the
reference's SuiteSparse fixtures are external
(reference/src/HOWTO:2,5):

    python -m spike_petsc_tpu_torch.testbed -problem illscaled:2000:8:8 \\
        -mat_ordering_type wbm -mat_ordering_scale 1 \\
        -mat_ordering_type2 rcm -banded_pre_mat 1 \\
        -ksp_type gmres -ksp_rtol 1e-8 -pc_type banded -ksp_monitor

The orderings, scalings and the banded extraction run on the host; the
operator, the right-hand side and the preconditioner live on the card in
float32 unless ``-x64 1`` (float64) or ``-platform cpu`` (the CPU) says
otherwise.  Without a CUDA device and without ``-platform cpu`` it stops
with an error.  Exit codes: 0 converged, 1 bad usage, 2 diverged.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from . import sparse as hsp
from .io import load_matrix
from .models import problems
from .ops.band import BandedMatrix
from .ordering import get_ordering
from .solvers.ksp import print_monitor, solve
from .solvers.types import reason_str
from .utils.options import Options
from .utils.profiling import scope, stage_report


def make_problem(spec: str):
    """Synthetic matrix source: name:arg1:arg2..."""
    parts = spec.split(":")
    name, args = parts[0], [int(x) for x in parts[1:]]
    if name == "tridiag":
        return problems.tridiag_laplacian(*(args or [100000]))
    if name == "spd":
        return problems.spd_banded(*(args or [100000, 16]))
    if name == "nonsym":
        return problems.nonsym_banded(*(args or [100000, 8, 8]))
    if name == "illscaled":
        return problems.illscaled_nonsym(*(args or [10000, 8, 8]))
    if name == "lap2d":
        return problems.laplacian_2d(*(args or [100, 100]))
    if name == "general":
        return problems.general_sparse(*(args or [5000]))
    if name == "mc64doc":
        return problems.mc64_doc_example()
    if name == "zerodiag":
        return problems.zero_diag_tridiag(*(args or [1000]))
    if name == "neumann":
        return problems.neumann_laplacian_1d(*(args or [1000]))
    raise ValueError(f"unknown problem {spec!r}")


def placement(opts: Options):
    """(device, dtype) from ``-platform`` and ``-x64``: the card unless
    ``-platform cpu``; float64 under ``-x64 1``, else float32."""
    platform = opts.get_string("platform", "cuda")
    dtype = torch.float64 if opts.get_bool("x64", False) else torch.float32
    if platform == "cpu":
        return torch.device("cpu"), dtype
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"-platform {platform!r}: expected cuda, gpu or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the testbed runs on the card "
                           "(pass -platform cpu to run on the CPU)")
    return torch.device("cuda"), dtype


def _reorder_pass(a, ordtype: str, opts: Options, scale: bool, second: bool):
    """One reordering pass with the reference's diagnostics
    (reference/src/testbed.c:200-284)."""
    ores = get_ordering(a, ordtype, opts)
    use_scale = scale and ores.row_scale is not None
    pa = ores.apply(a, scale=use_scale)
    bw, pbw = hsp.compute_bandwidth(a), hsp.compute_bandwidth(pa)
    print(f"Reordered matrix using {ordtype}"
          + (" (scaled)" if use_scale else ""))
    verb = "Reduced" if pbw < bw else "Increased"
    print(f"{verb} bandwidth from {bw} to {pbw}")
    dnorm, pdnorm = hsp.diagonal_norm1(a), hsp.diagonal_norm1(pa)
    print(f"Norm of diagonal {dnorm:g} perm diagonal {pdnorm:g}")
    if second:
        nz = hsp.count_zero_diagonals(pa)
        if nz:
            print(f"Zeros on the permuted diagonal: {nz}")
    return pa, ores


def main(argv=None, record: Optional[dict] = None) -> int:
    """Run the testbed on ``argv`` (default ``sys.argv[1:]``); return the
    exit code.  ``record``, when given, receives the run's objects for a
    caller that checks them: ``operator`` (the device operator), ``pmat``
    (the PC's matrix: a host matrix or the operator), ``b``, ``u`` (the
    manufactured solution, host), ``pc`` (the PC the solve built),
    ``result`` (the KSPResult)."""
    try:
        return _main(argv, {} if record is None else record)
    except (KeyError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _main(argv, record: dict) -> int:
    opts = Options.from_argv(sys.argv[1:] if argv is None else argv)
    device, dtype = placement(opts)

    matfile = opts.get_string("mat")
    problem = opts.get_string("problem")
    if matfile:
        with scope("MatLoad"):
            a = load_matrix(matfile)
    elif problem:
        a = make_problem(problem)
    else:
        print("Must provide an input matrix using -mat <file> or "
              "-problem <spec>", file=sys.stderr)
        return 1
    a = hsp.as_csr(a)
    print(f"Matrix: n={a.shape[0]}, nnz={a.nnz}")
    if opts.get_bool("view_mat", False):
        # -view_mat (MatView of the loaded matrix,
        # reference/src/testbed.c:52): entries for small matrices,
        # a structural summary otherwise
        if a.shape[0] <= 64:
            with np.printoptions(precision=4, suppress=True, linewidth=120):
                print(a.toarray())
        else:
            vkl, vku = hsp.compute_half_bandwidths(a)
            print(f"  type: csr, rows={a.shape[0]}, cols={a.shape[1]}, "
                  f"nnz={a.nnz}, half-bandwidths kl={vkl} ku={vku}")

    scale = opts.get_bool("mat_ordering_scale", False)
    ord1 = opts.get_string("mat_ordering_type", "natural")
    ord2 = opts.get_string("mat_ordering_type2", "natural")
    if ord1 != "natural":
        with scope(f"MatOrdering:{ord1}"):
            a, _ = _reorder_pass(a, ord1, opts, scale, second=False)
    if ord2 != "natural":
        with scope(f"MatOrdering:{ord2}"):
            a, _ = _reorder_pass(a, ord2, opts, scale=False, second=True)

    # preconditioning matrix (testbed.c:286-296)
    pmat = a
    pre_mat_built = opts.get_bool("banded_pre_mat", False)
    if pre_mat_built:
        kmax = opts.get_int("pc_banded_kmax", 50)
        frac = opts.get_real("pc_banded_frac", 0.95)
        with scope("MatCreateSubMatrixBanded"):
            ext = hsp.extract_banded(a, kmax=kmax, frac=frac)
        pmat = ext.matrix
        print(f"Bandwidth of {frac:.0%} band: {ext.k} "
              f"norm fraction: {ext.frac:g}")

    # operator to the device: band storage when the matrix is banded enough
    n = a.shape[0]
    kl, ku = hsp.compute_half_bandwidths(a)
    operator = a
    if kl + ku + 1 <= max(256, n // 4):
        data, kl, ku = hsp.csr_to_banded_arrays(a, kl=kl, ku=ku)
        operator = BandedMatrix(
            data=torch.as_tensor(data).to(device=device, dtype=dtype),
            kl=kl, ku=ku)
        print(f"Device operator: band storage kl={kl} ku={ku}")
    else:
        # the plan (histogram only) decides; as_matvec builds it once inside
        # solve() when profitable — no duplicate construction here
        from .ops.split import split_plan
        sk, s_out, s_prof = split_plan(a)
        if s_prof:
            print(f"Device operator: band+outliers split "
                  f"(k={sk}, nnz_out={s_out} of {a.nnz})")
        else:
            print("Device operator: sparse CSR")

    # manufactured solution (testbed.c:297-311)
    if opts.get_bool("random_exact_sol", False):
        u = np.random.default_rng(0).uniform(size=n)
    else:
        u = np.ones(n)
    b_host = a @ u
    b = torch.as_tensor(b_host).to(device=device, dtype=dtype)
    if opts.get_bool("view_exact_sol", False):
        print("Exact solution:", u)

    if opts.get_bool("report_symmetry", False):
        # symmetry check, as testbed2 performs
        # (reference/src/testbed2.c:97-99)
        d = abs(a - a.T)
        dev = float(d.max()) if d.nnz else 0.0
        print("Matrix is " + ("symmetric" if dev == 0.0
                              else f"non-symmetric (max |A-A^T| = {dev:g})"))

    pc_type = opts.get_string("pc_type", "none")
    # The extracted -banded_pre_mat matrix preconditions ANY PC, matching
    # KSPSetOperators(A, B) semantics (reference/src/testbed.c:314);
    # PCs whose setup is host-side sparse analysis also get the host matrix.
    host_setup_pcs = {"banded", "fieldsplit", "composite"}
    if not (pre_mat_built or pc_type in host_setup_pcs):
        pmat = operator
    record.update(operator=operator, pmat=pmat, b=b, u=u)
    with scope("KSPSolve"):
        res = solve(operator, b, pmat=pmat,
                    options=opts,
                    view=opts.get_bool("ksp_view", False), record=record)
    record["result"] = res
    if opts.get_bool("ksp_monitor", False) or \
            opts.get_bool("ksp_monitor_true_residual", False) or \
            opts.get_bool("ksp_converged_reason", False):
        print_monitor(res, bnorm=float(np.linalg.norm(b_host)))

    diff = res.x.cpu().double().numpy() - u
    if opts.get_bool("ksp_nullspace_constant", False):
        # a singular solve returns the minimal-norm (zero-mean)
        # representative, and u is defined up to the constant null vector:
        # compare the classes
        diff = diff - diff.mean()
    err = float(np.linalg.norm(diff))
    print(f"Error in solution: {err:g}")
    print(f"KSP iterations: {int(res.its)}  "
          f"reason: {reason_str(res.reason)}  rnorm: {float(res.rnorm):g}")

    if opts.get_bool("log_view", False):
        # PETSc -log_view / -log_summary stage table (SURVEY.md §5)
        print(stage_report())

    left = opts.options_left()
    if left:
        print("WARNING: unused options:", left, file=sys.stderr)
    return 0 if int(res.reason) > 0 else 2


if __name__ == "__main__":
    raise SystemExit(main())

"""Spectral partitioning tool — the reference's ``spectralPartition``
executable (reference/src/spectralPartition.c:247-444) re-designed:

load matrix -> graph Laplacian with drop tolerance -> validate L*1 = 0 and
lambda_0 ~ 0 with constant eigenvector (the reference's hard invariants,
:264-272, :314-319) -> Fiedler bisection into 2^levels blocks -> per-block
RCM -> stitched global permutation -> compare the norm-fraction banded
extraction before/after (:429-437).

    python -m spike_petsc_tpu_torch.tools.spectral -problem lap2d:30:30 -levels 2
"""

from __future__ import annotations

import sys

import numpy as np

from .. import sparse as hsp
from ..io import load_matrix
from ..ordering.fiedler import fiedler_vector, graph_laplacian
from ..ordering.partition import spectral_partition
from ..utils.options import Options


def main(argv=None) -> int:
    opts = Options.from_argv(sys.argv[1:] if argv is None else argv)
    fname = opts.get_string("mat") or opts.get_string("filename")
    if fname:
        a = load_matrix(fname)
    else:
        from ..testbed import make_problem
        a = make_problem(opts.get_string("problem", "lap2d:20:20"))
    a = hsp.as_csr(a)
    n = a.shape[0]
    print(f"Matrix: n={n}, nnz={a.nnz}")

    tol = opts.get_real("laplacian_tol", 1e-12)
    lap = graph_laplacian(a, tol=tol)

    # invariant: zero row sums (spectralPartition.c:264-272)
    rowsum = np.abs(np.asarray(lap.sum(axis=1))).max()
    if rowsum > 1e-10:
        print(f"ERROR: Laplacian row sums nonzero: {rowsum:g}",
              file=sys.stderr)
        return 2
    print(f"Laplacian row-sum check: max |L*1| = {rowsum:g}")

    # invariant: lambda_0 ~ 0, constant eigenvector (:314-319)
    if n <= 2000:
        evals, evecs = np.linalg.eigh(lap.toarray())
        lam0, lam1 = float(evals[0]), float(evals[1])
        v0 = evecs[:, 0]
        const_dev = float(np.abs(v0 - v0.mean()).max() / max(abs(v0.mean()), 1e-300))
        print(f"lambda_0 = {lam0:g}  lambda_1 = {lam1:g}  "
              f"constant-eigenvector deviation = {const_dev:g}")
        if abs(lam0) > 1e-8:
            print("ERROR: lambda_0 not ~ 0", file=sys.stderr)
            return 2
    else:
        vec, lam2 = fiedler_vector(lap, method="lanczos")
        print(f"lambda_2 (Lanczos) = {lam2:g}")

    levels = opts.get_int("levels", 1)
    res = spectral_partition(a, levels=levels,
                             balanced=opts.get_bool("balanced", True))
    print(f"Partitions: {len(res.sizes)} sizes={res.sizes} "
          f"edge_cut={res.info['edge_cut']}")
    print(f"Bandwidth: {res.info['bandwidth_in']} -> "
          f"{res.info['bandwidth_out']}")

    # banded extraction comparison (:429-437)
    kmax = opts.get_int("kmax", 50)
    frac = opts.get_real("frac", 0.95)
    before = hsp.extract_banded(a, kmax=kmax, frac=frac)
    after = hsp.extract_banded(hsp.permute(a, res.perm, res.perm),
                               kmax=kmax, frac=frac)
    print(f"Banded extraction before: k={before.k} frac={before.frac:g}")
    print(f"Banded extraction after:  k={after.k} frac={after.frac:g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""MC64-equivalent weighted bipartite matching orderings (jobs 1-5).

Functional parity with the HSL MC64 routine the reference wraps
(`HSLmc64AD`, reference/src/hslmc64.c:305; adapter
reference/src/petsc_mat_wbm.c:13):

  job=1  maximum-cardinality matching
  job=2  bottleneck: maximize the smallest |a_ij| on the matched diagonal
         (threshold bisection with from-scratch feasibility probes, the
         HSLmc64BD strategy reference/src/hslmc64.c:1002)
  job=3  same objective, second algorithm: sorted-threshold bisection with
         repeated-max-matching reuse (HSLmc64SD/mc64RD/HSLmc64UD
         reference/src/hslmc64.c:1432,4294,1698)
  job=4  maximize the sum of |a_ij| on the diagonal (assignment problem)
  job=5  maximize the product of |a_ij|, with row/column scaling vectors
         making the permuted scaled diagonal 1 and off-diagonals <= 1

``symmetrize=True`` applies an mc34AD-style symmetric expansion first
(mirroring reference/src/petsc_mat_wbm.c:29's symmetrized MatGetRowIJ
and hslmc64.c:2680), so triangular-stored symmetric inputs match correctly.

Jobs 4/5 use the shortest-augmenting-path engine in ``matching.py`` (native
C++ version used automatically when built); jobs 1-3 use cardinality /
threshold matchings.  Unlike the reference adapter, the job-5 scalings are
returned instead of discarded (reference/src/petsc_mat_wbm.c:56).

Structurally singular matrices are completed deterministically (unmatched
columns take the remaining rows in order), mirroring HSLmc64XD
(reference/src/hslmc64.c:2555), and reported via info["structurally_singular"].
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.registry import register_ordering
from .base import OrderingResult
from . import matching


def _complete_match(match: np.ndarray) -> tuple:
    """Assign remaining rows to unmatched columns in order (HSLmc64XD)."""
    n = len(match)
    used = np.zeros(n, dtype=bool)
    valid = match >= 0
    used[match[valid]] = True
    free_rows = np.flatnonzero(~used)
    out = match.copy()
    out[~valid] = free_rows[: (~valid).sum()]
    return out, int((~valid).sum())


def _result_from_match(match: np.ndarray, info: dict,
                       row_scale=None, col_scale=None) -> OrderingResult:
    match, n_unmatched = _complete_match(match)
    if n_unmatched:
        info = dict(info, structurally_singular=True, unmatched=n_unmatched)
    n = len(match)
    return OrderingResult(rperm=match, cperm=np.arange(n),
                          row_scale=row_scale, col_scale=col_scale, info=info)


def mc64(a, job: int = 5, symmetrize: bool = False) -> OrderingResult:
    """Compute the MC64-family ordering for host sparse matrix ``a``."""
    if symmetrize:
        a = matching.symmetric_expand(a)
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    n = csc.shape[0]
    if csc.shape[0] != csc.shape[1]:
        raise ValueError("mc64 requires a square matrix")

    if job == 1:
        match, card = matching.max_cardinality_match(csc)
        return _result_from_match(match, dict(type="mc64", job=1,
                                              cardinality=card))

    if job == 2:
        match, t = matching.bottleneck_match(csc)
        return _result_from_match(match, dict(type="mc64", job=2,
                                              bottleneck=t))

    if job == 3:
        match, t = matching.bottleneck_match_sorted(csc)
        return _result_from_match(match, dict(type="mc64", job=3,
                                              bottleneck=t))

    if job in (4, 5):
        ptr = csc.indptr.astype(np.int64)
        rows = csc.indices.astype(np.int64)
        absval = np.abs(csc.data.astype(np.float64))
        # drop explicit zeros from the graph (cost would be infinite)
        if (absval == 0).any():
            coo = csc.tocoo()
            keep = np.abs(coo.data) > 0
            csc = sp.csc_matrix(
                (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n))
            ptr = csc.indptr.astype(np.int64)
            rows = csc.indices.astype(np.int64)
            absval = np.abs(csc.data.astype(np.float64))

        colmax = np.zeros(n)
        np.maximum.at(colmax, np.repeat(np.arange(n), np.diff(ptr)), absval)
        logmax = np.zeros(n)
        np.log(colmax, out=logmax, where=colmax > 0)
        if job == 4:
            # maximize sum: cost = colmax_j - |a_ij|  (Duff-Koster additive)
            cost = np.repeat(colmax, np.diff(ptr)) - absval
        else:
            # maximize product: cost = log(colmax_j) - log|a_ij|
            cost = np.repeat(logmax, np.diff(ptr)) - np.log(
                np.where(absval > 0, absval, 1.0))
        cost = np.maximum(cost, 0.0)

        match, u, v, feasible = _assign(n, ptr, rows, cost)
        info = dict(type="mc64", job=job)
        if job == 5:
            # scalings: dr_i = exp(u_i), dc_j = exp(v_j - log colmax_j) give
            # |dr_i a_ij dc_j| = exp(u_i + v_j - cost_ij) <= 1, == 1 matched
            # (the dw convention of reference/src/hslmc64.c:822-832).
            with np.errstate(over="raise"):
                try:
                    row_scale = np.exp(u)
                    col_scale = np.exp(v - logmax)
                except FloatingPointError:
                    info["scaling_overflow"] = True      # MC64 INFO(1)=+2
                    row_scale = np.exp(np.clip(u, -700, 700))
                    col_scale = np.exp(np.clip(v - logmax, -700, 700))
            return _result_from_match(match, info, row_scale, col_scale)
        return _result_from_match(match, info)

    raise ValueError(f"mc64 job must be 1..5, got {job}")


def _assign(n, ptr, rows, cost):
    """Dispatch to the native C++ engine when available."""
    try:
        from ..native import loader
        fn = loader.get_assignment()
    except Exception:
        fn = None
    if fn is not None:
        return fn(n, ptr, rows, cost)
    return matching.sparse_assignment(n, ptr, rows, cost)


@register_ordering("wbm")
def ordering_wbm(a, options=None) -> OrderingResult:
    """'wbm' MatOrdering: MC64 job 5, the reference's default choice
    (reference/src/petsc_mat_wbm.c:34-52).

    -mat_ordering_wbm_symmetrize 1 applies the mc34-style symmetric expand
    first (the reference adapter's symmetrized MatGetRowIJ, :29)."""
    job = 5
    symmetrize = False
    if options is not None:
        job = options.get_int("mat_ordering_wbm_job", 5)
        symmetrize = options.get_bool("mat_ordering_wbm_symmetrize", False)
    return mc64(a, job=job, symmetrize=symmetrize)

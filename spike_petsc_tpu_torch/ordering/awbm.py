"""Approximate weighted bipartite matching (AWBM) ordering.

The parallelizable approximate matching of Duff & Koster (2001) that the
reference implements by hand as its accelerator-friendly alternative to exact
MC64 (`MatGetOrdering_AWBM`, reference/src/petsc_mat_awbm.c:42-225).
Re-implemented here as vectorized NumPy phases (the natural stepping stone to
the jittable device version in ``parallel/matching_dev.py``):

  0. weights  c_ij = log(colmax_j / |a_ij|)                        (:73-80)
  1. dual init u_i = min_j c_ij,  v_j = min_i (c_ij - u_i)         (:82-94)
  2. greedy matching on tight edges (reduced cost <= eps)          (:98-112)
  3. one-step augmentation through tight edges                     (:115-140)
  4. greedy matching ignoring optimality                           (:143-153)
  5. one-step augmentation ignoring optimality                     (:156-178)
  6. deterministic completion with leftover rows                   (:181-193)

Returns the scaling vectors the reference computes and then destroys
(:208-223): row_scale = exp(v_j)/colmax, col_scale = exp(u_i) in the
reference's column-major view; in our row-major convention
row_scale_i = exp(u_i), col_scale_j = exp(v_j - log colmax_j).

Approximation guarantee: the matched weight is within a factor ~2 of optimal
(1/2-approximation), usually much closer; phases count toward
info["matched_per_phase"] like the reference's CheckUnmatched prints (:9-21).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.registry import register_ordering
from .base import OrderingResult


def awbm(a, eps: float = None) -> OrderingResult:
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    n = csc.shape[0]
    ptr, rows = csc.indptr, csc.indices
    absval = np.abs(csc.data.astype(np.float64))
    eps = np.sqrt(np.finfo(np.float64).eps) if eps is None else eps

    ncol = np.diff(ptr)
    colmax = np.zeros(n)
    np.maximum.at(colmax, np.repeat(np.arange(n), ncol), absval)
    safe_max = np.where(colmax > 0, colmax, 1.0)
    with np.errstate(divide="ignore"):
        w = np.where(absval > 0,
                     np.log(np.repeat(safe_max, ncol) /
                            np.where(absval > 0, absval, 1.0)),
                     np.inf)

    col_of = np.repeat(np.arange(n), ncol)

    # dual init (vectorized min-reductions — this is the piece that maps to
    # segment-min on device)
    u = np.full(n, np.inf)
    np.minimum.at(u, rows, w)
    u[~np.isfinite(u)] = 0.0
    v = np.full(n, np.inf)
    np.minimum.at(v, col_of, w - u[rows])
    v[~np.isfinite(v)] = 0.0

    tight = (w - u[rows] - v[col_of]) <= eps

    match = np.full(n, -1, dtype=np.int64)    # column -> row
    matchR = np.full(n, -1, dtype=np.int64)   # row -> column
    phases = []

    def greedy(require_tight: bool):
        for j in range(n):
            if match[j] >= 0:
                continue
            for t in range(ptr[j], ptr[j + 1]):
                if require_tight and not tight[t]:
                    continue
                i = rows[t]
                if matchR[i] < 0:
                    match[j] = i
                    matchR[i] = j
                    break

    def augment_once(require_tight: bool):
        for j in range(n):
            if match[j] >= 0:
                continue
            done = False
            for t in range(ptr[j], ptr[j + 1]):
                if require_tight and not tight[t]:
                    continue
                i = rows[t]
                j1 = matchR[i]           # row i is taken by column j1
                if j1 < 0:
                    match[j] = i
                    matchR[i] = j
                    done = True
                    break
                for t1 in range(ptr[j1], ptr[j1 + 1]):
                    if require_tight and not tight[t1]:
                        continue
                    i1 = rows[t1]
                    if matchR[i1] < 0:
                        # steal i for j; re-match j1 to i1
                        match[j] = i
                        matchR[i] = j
                        match[j1] = i1
                        matchR[i1] = j1
                        done = True
                        break
                if done:
                    break

    greedy(True)
    phases.append(int((match >= 0).sum()))
    augment_once(True)
    phases.append(int((match >= 0).sum()))
    greedy(False)
    phases.append(int((match >= 0).sum()))
    augment_once(False)
    phases.append(int((match >= 0).sum()))

    # deterministic completion (reference :181-193)
    free_rows = np.flatnonzero(matchR < 0)
    unmatched_cols = np.flatnonzero(match < 0)
    match[unmatched_cols] = free_rows[: len(unmatched_cols)]

    with np.errstate(over="ignore"):
        row_scale = np.exp(np.clip(u, -700, 700))
        col_scale = np.exp(np.clip(v - np.log(safe_max), -700, 700))

    return OrderingResult(
        rperm=match, cperm=np.arange(n),
        row_scale=row_scale, col_scale=col_scale,
        info=dict(type="awbm", matched_per_phase=phases,
                  completed=int(len(unmatched_cols))))


@register_ordering("awbm")
def ordering_awbm(a, options=None) -> OrderingResult:
    return awbm(a)


@register_ordering("natural")
def ordering_natural(a, options=None) -> OrderingResult:
    from .base import identity_ordering
    return identity_ordering(sp.csr_matrix(a).shape[0])

"""Ordering results and shared conventions.

An ordering maps a host CSR matrix to row/column permutations (plus optional
scalings).  Convention used throughout this framework:

    PA = A[rperm, :][:, cperm]        (sparse.permute)

puts the ordering's target structure (heavy diagonal / small bandwidth) on PA.
For matchings this means ``rperm[i]`` is the row matched to column ``i`` so
that ``PA[i, i] = A[rperm[i], i]`` is the matched entry.

The reference computes WBM scaling vectors and then discards them
(reference/src/petsc_mat_wbm.c:56, reference/src/petsc_mat_awbm.c:
222-223) — a noted deficiency, since no-pivot banded factorization depends on
them (SURVEY.md §7 hard-part 2).  Here scalings are first-class outputs:
``diag(row_scale) @ A @ diag(col_scale)`` permuted by (rperm, cperm) has unit
matched diagonal and off-diagonal magnitudes <= 1 (for mc64 job 5 / awbm).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class OrderingResult:
    rperm: np.ndarray                      # row permutation (len n)
    cperm: np.ndarray                      # column permutation (len n)
    row_scale: Optional[np.ndarray] = None
    col_scale: Optional[np.ndarray] = None
    info: dict = field(default_factory=dict)

    def apply(self, a, scale: bool = False):
        """Permute (and optionally scale) a host CSR matrix."""
        from .. import sparse as hsp
        m = hsp.as_csr(a)
        if scale and self.row_scale is not None:
            m = hsp.diagonal_scale(m, self.row_scale, self.col_scale)
        return hsp.permute(m, self.rperm, self.cperm)


def identity_ordering(n: int) -> OrderingResult:
    p = np.arange(n)
    return OrderingResult(rperm=p, cperm=p.copy(), info=dict(type="natural"))


def invert_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv

"""Band + outliers split operator: the band part streams, the rest scatters.

The reference's production workloads are general AIJ matrices (SuiteSparse
fixtures, reference/src/testbed.c:3-8) whose MatMult is the Krylov
hot loop (reference/src/testbed.c:310).  After the WBM/RCM pipeline
most of the weight sits in a central band, but scattered outliers keep the
matrix from being strictly banded.  Split

    A  =  B (band, diagonal-offset storage)  +  R (outlier remainder, COO)

and the n*(2k+1) band entries stream through the band route (the banded
CUDA kernel on the card) while only the outliers take a gather and a sorted
``index_add_``.  The split is EXACT — unlike ``-banded_pre_mat`` (which
truncates to build a preconditioner), the remainder keeps every out-of-band
entry, so this is an operator representation, not an approximation.

The plan (``split_plan``) and its cost model are the JAX package's,
unchanged, so both packages pick the same split of the same matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .band import BandedMatrix

# the JAX package's cost ratio of scalar gather/scatter elements against
# streamed band elements, kept so the split bandwidth matches its choice
_SCALAR_COST = 256


@dataclass(frozen=True)
class SplitBandedMatrix:
    """Exact A = band + outliers; outlier triplets sorted by row."""

    band: BandedMatrix
    rows: torch.Tensor       # [nnz_out] int64 (sorted, ascending)
    cols: torch.Tensor       # [nnz_out] int64
    vals: torch.Tensor       # [nnz_out]

    @property
    def n(self) -> int:
        return self.band.n

    @property
    def dtype(self) -> torch.dtype:
        return self.band.dtype

    @property
    def nnz_out(self) -> int:
        return self.vals.shape[0]


def split_cost(n: int, k: int, nnz_out: int) -> float:
    """Relative matvec cost model: streamed band elements + scalar-weighted
    outliers.  Comparable across k and against the all-scalar sparse cost
    ``_SCALAR_COST * nnz``."""
    return n * (2 * k + 1) + _SCALAR_COST * nnz_out


def split_plan(a, kmax: int = 255):
    """(k, nnz_out, profitable): the cost-optimal split bandwidth, its
    outlier count, and whether the split beats an all-scalar sparse matvec —
    computed from the |i-j| entry-count histogram alone (no arrays built,
    no device transfers).  ``kmax`` caps the band at w = 2k+1 <= 511."""
    import scipy.sparse as sp
    coo = sp.csr_matrix(a).tocoo()
    n = coo.shape[0]
    if coo.shape[1] != n:
        # band storage is square-only; rectangular operators take the
        # sparse route
        return 0, coo.nnz, False
    dist = np.abs(coo.row - coo.col)
    counts = np.bincount(dist, minlength=n)
    kcap = int(min(kmax, n - 1))
    # outliers remaining beyond each candidate k, and the cost curve
    out_beyond = counts.sum() - np.cumsum(counts)          # nnz with d > k
    ks = np.arange(kcap + 1)
    cost = n * (2 * ks + 1) + _SCALAR_COST * out_beyond[:kcap + 1]
    k = int(np.argmin(cost))
    nnz_out = int(out_beyond[k])
    profitable = bool(split_cost(n, k, nnz_out)
                      < 0.7 * _SCALAR_COST * coo.nnz)
    return k, nnz_out, profitable


def split_from_csr(a, kmax: int = 255, dtype: Optional[torch.dtype] = None,
                   device="cuda") -> SplitBandedMatrix:
    """Build the split operator at the cost-optimal bandwidth (see
    split_plan) on ``device`` (the card unless the caller names another),
    in ``dtype`` (default: the matrix's own)."""
    import scipy.sparse as sp
    k, _, _ = split_plan(a, kmax=kmax)
    coo = sp.csr_matrix(a).tocoo()
    n = coo.shape[0]
    dist = np.abs(coo.row - coo.col)
    keep = dist <= k
    data = np.zeros((n, 2 * k + 1), dtype=coo.data.dtype)
    np.add.at(data, (coo.row[keep], coo.col[keep] - coo.row[keep] + k),
              coo.data[keep])
    r, c, v = coo.row[~keep], coo.col[~keep], coo.data[~keep]
    order = np.argsort(r, kind="stable")

    def dev(arr, dt=dtype):
        return torch.as_tensor(arr).to(device=device, dtype=dt)
    return SplitBandedMatrix(
        band=BandedMatrix(data=dev(data), kl=k, ku=k),
        rows=dev(r[order], torch.int64), cols=dev(c[order], torch.int64),
        vals=dev(v[order]))


def split_if_profitable(a, kmax: int = 255,
                        dtype: Optional[torch.dtype] = None, device="cuda"):
    """The routing entry: None when the sparse product wins the cost model
    (nothing is built or transferred in that case), else the built
    SplitBandedMatrix."""
    _, _, profitable = split_plan(a, kmax=kmax)
    return (split_from_csr(a, kmax=kmax, dtype=dtype, device=device)
            if profitable else None)


def split_matvec(sm: SplitBandedMatrix, x: torch.Tensor,
                 band_mv: Callable) -> torch.Tensor:
    """y = A @ x: the band part through ``band_mv`` (the operator's band
    route, e.g. ``as_matvec(sm.band)``) plus the outliers, gathered from x
    and added into their rows by ``index_add``."""
    y = band_mv(x)
    if sm.nnz_out:
        y = y.index_add(0, sm.rows, sm.vals * x[sm.cols])
    return y

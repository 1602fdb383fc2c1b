"""Host-side sparse matrix utilities (setup path).

The combinatorial/setup phase of the pipeline (load -> reorder -> scale ->
extract band) operates on host CSR matrices, mirroring the reference's use of
PETSc SeqAIJ on each rank; the accelerated solve phase then works on device
band storage.  This module is the host half: bandwidth/diagnostic queries
(MatComputeBandwidth, MatGetDiagonal norms — reference/src/testbed.c:
209-231, 266-276), permutation/scaling application (MatPermute,
MatDiagonalScale — reference/src/wbm.c:567-573), and the norm-fraction
banded extraction (MatCreateSubMatrixBanded,
reference/src/matbanded.c:22-107).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def as_csr(a) -> sp.csr_matrix:
    if sp.issparse(a):
        return a.tocsr()
    return sp.csr_matrix(np.asarray(a))


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def compute_bandwidth(a, tol: float = 0.0) -> int:
    """Max |i - j| over entries with |a_ij| > tol; PETSc MatComputeBandwidth
    equivalent (reference/src/testbed.c:209)."""
    coo = as_csr(a).tocoo()
    mask = np.abs(coo.data) > tol
    if not mask.any():
        return 0
    return int(np.max(np.abs(coo.row[mask] - coo.col[mask])))


def compute_half_bandwidths(a, tol: float = 0.0) -> Tuple[int, int]:
    """(kl, ku): max sub/super-diagonal offsets with entries > tol."""
    coo = as_csr(a).tocoo()
    mask = np.abs(coo.data) > tol
    if not mask.any():
        return 0, 0
    d = coo.col[mask] - coo.row[mask]
    return int(max(0, -d.min())), int(max(0, d.max()))


def diagonal_norm1(a) -> float:
    """1-norm of the diagonal (reference/src/testbed.c:225-227)."""
    return float(np.abs(as_csr(a).diagonal()).sum())


def count_zero_diagonals(a) -> int:
    """Zeros on the diagonal (reference/src/testbed.c:266-272)."""
    return int(np.count_nonzero(as_csr(a).diagonal() == 0.0))


def diagonal_weight_product(a) -> float:
    """Product over ranks of sum_r |diag_r| — the matching-quality metric of
    CheckDiagonalWeight (reference/src/wbm.c:530-551).  Single-host, so
    the MPI_PROD reduces to the local sum."""
    return float(np.abs(as_csr(a).diagonal()).sum())


def matrix_profile(a) -> int:
    """Profile = sum_i (i - min{j : a_ij != 0}) for rows with entries below
    the diagonal, the quantity MC73 reports (reference/src/hslmc73f.F90:33-36)."""
    csr = as_csr(a)
    n = csr.shape[0]
    prof = 0
    indptr, indices = csr.indptr, csr.indices
    for i in range(n):
        row = indices[indptr[i]:indptr[i + 1]]
        if row.size:
            prof += max(0, i - int(row.min()))
    return int(prof)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def permute(a, rperm: np.ndarray, cperm: Optional[np.ndarray] = None) -> sp.csr_matrix:
    """B = A[rperm, :][:, cperm] — MatPermute semantics: ``rperm[k]`` is the
    original row placed at position k (reference/src/testbed.c:206)."""
    csr = as_csr(a)
    if cperm is None:
        cperm = rperm
    return csr[rperm, :][:, cperm].tocsr()


def diagonal_scale(a, dr: Optional[np.ndarray], dc: Optional[np.ndarray]) -> sp.csr_matrix:
    """B = diag(dr) A diag(dc) — MatDiagonalScale
    (reference/src/wbm.c:570)."""
    csr = as_csr(a)
    if dr is not None:
        csr = sp.diags(dr) @ csr
    if dc is not None:
        csr = csr @ sp.diags(dc)
    return csr.tocsr()


# ---------------------------------------------------------------------------
# Banded extraction (norm-fraction band selection)
# ---------------------------------------------------------------------------

@dataclass
class BandExtraction:
    matrix: sp.csr_matrix   # the banded submatrix B
    k: int                  # chosen half-bandwidth
    frac: float             # achieved fraction ||B||_sum / ||A||_sum


def extract_banded(a, kmax: int = 50, frac: float = 0.95) -> BandExtraction:
    """Extract the banded subset B with ||vec(B)||_1 >= frac * ||vec(A)||_1.

    Re-implements MatCreateSubMatrixBanded
    (reference/src/matbanded.c:22-107) as vectorized NumPy:
    1. per-|offset| weight histogram w[k] = sum |a_ij| over |i-j| = k,
    2. the smallest k (< kmax) whose cumulative weight reaches frac * ||A||,
       falling back to kmax when the fraction is never reached (matching the
       reference's loop exit at k == kmax),
    3. drop all entries with |i-j| > k.
    """
    coo = as_csr(a).tocoo()
    n = coo.shape[0]
    dist = np.abs(coo.row - coo.col)
    absval = np.abs(coo.data)
    w = np.bincount(dist, weights=absval, minlength=n)
    norm_a = float(absval.sum())
    cum = np.cumsum(w)
    hit = np.nonzero(cum >= frac * norm_a)[0]
    k = int(hit[0]) if hit.size and hit[0] < kmax else int(kmax)
    norm_b = float(cum[min(k, n - 1)])
    keep = dist <= k
    b = sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=coo.shape)
    return BandExtraction(matrix=b, k=k,
                          frac=norm_b / norm_a if norm_a > 0 else 1.0)


def csr_to_banded_arrays(a, kl: Optional[int] = None, ku: Optional[int] = None,
                         dtype=None) -> Tuple[np.ndarray, int, int]:
    """Pack a (banded) CSR matrix into diagonal-offset storage [n, kl+ku+1].

    Host-side twin of ``ops.band.banded_from_coo``; returns (data, kl, ku).
    Out-of-band entries are dropped (caller should extract_banded first when
    that loss matters).
    """
    csr = as_csr(a)
    n = csr.shape[0]
    if kl is None or ku is None:
        akl, aku = compute_half_bandwidths(csr)
        kl = akl if kl is None else kl
        ku = aku if ku is None else ku
    coo = csr.tocoo()
    off = coo.col - coo.row + kl
    inb = (off >= 0) & (off <= kl + ku)
    data = np.zeros((n, kl + ku + 1), dtype=dtype or csr.dtype)
    np.add.at(data, (coo.row[inb], off[inb]), coo.data[inb])
    return data, int(kl), int(ku)

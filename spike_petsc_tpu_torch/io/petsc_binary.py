"""PETSc binary viewer format reader/writer.

The reference loads its test matrices with MatLoad from PETSc binary files
(reference/src/testbed.c:195-198) converted from MatrixMarket by
PETSc's ex72 (reference/src/testbed.c:3-8).  This module implements the
on-disk format directly (big-endian, classid-tagged) so the same fixture
files drive this framework:

  Mat:  int32 [MAT_FILE_CLASSID=1211216, M, N, nnz],
        int32 row_lengths[M], int32 col_indices[nnz], float64 values[nnz]
  Vec:  int32 [VEC_FILE_CLASSID=1211214, n], float64 values[n]
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214

_i = np.dtype(">i4")
_d = np.dtype(">f8")


def write_mat(path: str, a) -> None:
    csr = sp.csr_matrix(a)
    csr.sort_indices()
    m, n = csr.shape
    nnz = csr.nnz
    with open(path, "wb") as f:
        np.array([MAT_FILE_CLASSID, m, n, nnz], dtype=_i).tofile(f)
        np.diff(csr.indptr).astype(_i).tofile(f)
        csr.indices.astype(_i).tofile(f)
        csr.data.astype(_d).tofile(f)


def read_mat(path: str) -> sp.csr_matrix:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_i, count=4)
        if header[0] != MAT_FILE_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary Mat "
                             f"(classid {header[0]})")
        m, n, nnz = (int(x) for x in header[1:])
        rowlens = np.fromfile(f, dtype=_i, count=m)
        indices = np.fromfile(f, dtype=_i, count=nnz)
        data = np.fromfile(f, dtype=_d, count=nnz)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(rowlens, out=indptr[1:])
    return sp.csr_matrix((data.astype(np.float64),
                          indices.astype(np.int64), indptr), shape=(m, n))


def write_vec(path: str, v: np.ndarray) -> None:
    v = np.asarray(v).ravel()
    with open(path, "wb") as f:
        np.array([VEC_FILE_CLASSID, v.size], dtype=_i).tofile(f)
        v.astype(_d).tofile(f)


def read_vec(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_i, count=2)
        if header[0] != VEC_FILE_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary Vec "
                             f"(classid {header[0]})")
        return np.fromfile(f, dtype=_d, count=int(header[1])).astype(np.float64)

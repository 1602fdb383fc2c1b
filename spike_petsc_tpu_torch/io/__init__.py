"""Matrix/vector persistence: PETSc binary, MatrixMarket, npz band snapshots.

Covers the reference's persistence surface (SURVEY.md §5 checkpoint/resume):
PETSc binary MatLoad (reference/src/testbed.c:195-198) and
MatrixMarket export of reordered matrices (reference/src/wbm.c:516-524,
reference/src/HOWTO:4-5), plus native .npz snapshots of band storage.
Factorization save/load is not yet ported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .petsc_binary import read_mat, read_vec, write_mat, write_vec


def read_matrix_market(path: str) -> sp.csr_matrix:
    from scipy.io import mmread
    return sp.csr_matrix(mmread(path))


def write_matrix_market(path: str, a) -> None:
    from scipy.io import mmwrite
    mmwrite(path, sp.coo_matrix(a))


def load_matrix(path: str) -> sp.csr_matrix:
    """Format-sniffing loader: .mtx / .mm -> MatrixMarket, .npz -> scipy
    sparse npz, anything else -> PETSc binary."""
    lower = path.lower()
    if lower.endswith((".mtx", ".mm", ".mtx.gz")):
        return read_matrix_market(path)
    if lower.endswith(".npz"):
        return sp.csr_matrix(sp.load_npz(path))
    return read_mat(path)


def save_banded(path: str, band) -> None:
    """Snapshot band storage to .npz (the data comes to the host)."""
    np.savez_compressed(path, data=band.data.cpu().numpy(), kl=band.kl,
                        ku=band.ku)


def load_banded(path: str, device="cuda", dtype=None):
    """A band snapshot as a ``BandedMatrix`` on ``device`` (the card unless
    the caller names another), in ``dtype`` (default: the stored one)."""
    import torch

    from ..ops.band import BandedMatrix
    z = np.load(path)
    data = torch.as_tensor(z["data"]).to(device=device, dtype=dtype)
    return BandedMatrix(data=data, kl=int(z["kl"]), ku=int(z["ku"]))


__all__ = ["read_mat", "read_vec", "write_mat", "write_vec",
           "read_matrix_market", "write_matrix_market", "load_matrix",
           "save_banded", "load_banded"]

"""Banded matrix storage and the plain banded matvec (PyTorch).

Same diagonal-offset layout as ``spike_petsc_tpu.ops.band``:

    data[i, d] == A[i, i + d - kl]   for d in [0, kl + ku],

so row ``i`` of ``data`` holds the in-band entries of row ``i`` of ``A``
left-aligned at offset ``-kl``.  Entries whose column falls outside
``[0, n)`` may be nonzero in storage; every consumer treats them as
multiplying zero (the matvec reads ``x`` zero-padded by ``kl``/``ku``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BandedMatrix:
    """Banded matrix in diagonal-offset storage.

    Attributes:
      data: ``[n, kl + ku + 1]`` tensor; ``data[i, d] = A[i, i + d - kl]``.
      kl:   number of subdiagonals.
      ku:   number of superdiagonals.
    """

    data: torch.Tensor
    kl: int
    ku: int

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.kl + self.ku + 1

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device


def _band_index(n: int, kl: int, ku: int, device) -> tuple:
    """(cols, valid): column index of every band slot and its in-range mask."""
    rows = torch.arange(n, device=device)[:, None]
    offs = torch.arange(-kl, ku + 1, device=device)[None, :]
    cols = rows + offs
    return cols, (cols >= 0) & (cols < n)


def banded_from_dense(a: torch.Tensor, kl: int, ku: int) -> BandedMatrix:
    """Extract the [-kl, ku] band of a dense matrix into offset storage."""
    n = a.shape[0]
    cols, valid = _band_index(n, kl, ku, a.device)
    rows = torch.arange(n, device=a.device)[:, None].expand_as(cols)
    data = torch.where(valid, a[rows, cols.clamp(0, n - 1)],
                       torch.zeros((), dtype=a.dtype, device=a.device))
    return BandedMatrix(data=data, kl=kl, ku=ku)


def banded_to_dense(b: BandedMatrix) -> torch.Tensor:
    """Dense ``[n, n]`` copy of the band (out-of-range slots dropped)."""
    n = b.n
    cols, valid = _band_index(n, b.kl, b.ku, b.device)
    rows = torch.arange(n, device=b.device)[:, None].expand_as(cols)
    a = torch.zeros((n, n), dtype=b.dtype, device=b.device)
    a[rows[valid], cols[valid]] = b.data[valid]
    return a


def banded_matvec(b: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for band storage as ``w`` shifted axpys:
    y[i] = sum_d data[i, d] * x[i + d - kl], x zero outside [0, n).

    The plain version of the banded matvec kernel
    (``ops/cuda/band_matvec.py``).  Accumulates in the promoted type of the
    band and ``x``.  Supports x of shape [n] or [n, nrhs].
    """
    n, kl, ku = b.n, b.kl, b.ku
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    dtype = torch.promote_types(b.dtype, x.dtype)
    xp = torch.nn.functional.pad(x.to(dtype).T, (kl, ku)).T
    data = b.data.to(dtype)
    y = torch.zeros((n, x.shape[1]), dtype=dtype, device=x.device)
    for d in range(b.width):
        y += data[:, d:d + 1] * xp[d:d + n]
    return y[:, 0] if squeeze else y


def banded_diagonal(b: BandedMatrix) -> torch.Tensor:
    """Main diagonal of A (MatGetDiagonal equivalent,
    reference/src/testbed.c:223)."""
    return b.data[:, b.kl]


def pad_banded(b: BandedMatrix, n_pad: int,
               unit_diagonal: bool = True) -> BandedMatrix:
    """Pad to ``n_pad`` rows; padding rows get a unit diagonal so the padded
    operator stays nonsingular (identity on the padding subspace)."""
    if n_pad == b.n:
        return b
    pad = torch.zeros((n_pad - b.n, b.width), dtype=b.dtype, device=b.device)
    if unit_diagonal:
        pad[:, b.kl] = 1
    return BandedMatrix(data=torch.cat([b.data, pad], dim=0), kl=b.kl,
                        ku=b.ku)


def banded_transpose(b: BandedMatrix) -> BandedMatrix:
    """Transpose in band storage: A^T[i, i + d] = A[i + d, i], so ``kl``
    and ``ku`` swap.

    ``dataT[i, j] = data[i + j - ku, (w - 1) - j]``: each transposed
    diagonal is a row-shifted copy of the mirrored source diagonal, built
    as ``w`` shifted slices for ``w <= 512`` and as one gather for wider
    bands (:func:`_transpose_gather`), as in the JAX package.  Slots whose
    source row leaves ``[0, n)`` are zero."""
    if b.width <= 512:
        return _transpose_shifted(b)
    return _transpose_gather(b)


def _transpose_shifted(b: BandedMatrix) -> BandedMatrix:
    """The shifted-slice form of :func:`banded_transpose`."""
    n, w = b.n, b.width
    data = torch.zeros_like(b.data)
    for j in range(w):
        s = j - b.ku                            # the row shift
        lo, hi = max(0, -s), min(n, n - s)
        if lo < hi:
            data[lo:hi, j] = b.data[lo + s:hi + s, w - 1 - j]
    return BandedMatrix(data=data, kl=b.ku, ku=b.kl)


def _transpose_gather(b: BandedMatrix) -> BandedMatrix:
    """The gather form of :func:`banded_transpose`: source row ``i + d``,
    source slot ``kl - d`` for the transposed offset ``d``."""
    n, kl, ku, dev = b.n, b.kl, b.ku, b.device
    offs = torch.arange(-ku, kl + 1, device=dev)[None, :]
    src_row = torch.arange(n, device=dev)[:, None] + offs
    valid = (src_row >= 0) & (src_row < n)
    data = torch.where(valid, b.data[src_row.clamp(0, n - 1), kl - offs],
                       torch.zeros((), dtype=b.dtype, device=dev))
    return BandedMatrix(data=data, kl=ku, ku=kl)


def banded_matvec_t(b: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A^T @ x."""
    return banded_matvec(banded_transpose(b), x)


def banded_diagonal_scale(b: BandedMatrix, dr=None, dc=None) -> BandedMatrix:
    """diag(dr) @ A @ diag(dc) in band storage, either factor optional
    (MatDiagonalScale).  Row scaling multiplies each row; column scaling
    multiplies stored slot ``d`` of row ``i`` by ``dc[i + d - kl]`` (zero
    outside ``[0, n)``).  Returns a new matrix; the input is not mutated."""
    data, n, kl, ku = b.data, b.n, b.kl, b.ku
    if dr is not None:
        data = data * torch.as_tensor(dr, dtype=data.dtype,
                                      device=data.device)[:, None]
    if dc is not None:
        dcp = torch.nn.functional.pad(
            torch.as_tensor(dc, dtype=data.dtype, device=data.device),
            (kl, ku))
        data = torch.stack([data[:, d] * dcp[d:d + n]
                            for d in range(b.width)], dim=1)
    return BandedMatrix(data=data, kl=kl, ku=ku)

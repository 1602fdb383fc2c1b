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

"""Banded matrix storage, the plain banded matvec and the band helpers
(PyTorch).

Same diagonal-offset layout as ``spike_petsc_tpu.ops.band``:

    data[i, d] == A[i, i + d - kl]   for d in [0, kl + ku],

so row ``i`` of ``data`` holds the in-band entries of row ``i`` of ``A``
left-aligned at offset ``-kl``.  Entries whose column falls outside
``[0, n)`` may be nonzero in storage; every consumer treats them as
multiplying zero (the matvec reads ``x`` zero-padded by ``kl``/``ku``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


# ---------------------------------------------------------------------------
# Construction from triplets, arithmetic and diagnostics (JAX
# ``ops/band.py:84-103``, ``:218-301``)
# ---------------------------------------------------------------------------

def _to_device(a, dtype=None, device=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor keeps its device unless ``device`` names
    one; anything else (numpy, lists) goes to ``device``, default the
    card."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype or a.dtype)
    t = torch.as_tensor(np.asarray(a))
    return t.to(device=device or "cuda", dtype=dtype or t.dtype)


def banded_from_coo(rows, cols, vals, n: int, kl: int, ku: int,
                    dtype=None, device=None) -> BandedMatrix:
    """Scatter COO triplets into band storage; out-of-band entries are
    dropped and duplicates summed (the copy loop of the reference's banded
    extraction, reference/src/matbanded.c:84-99).  Tensors stay on their
    device; numpy input goes to ``device`` (default the card)."""
    vals = _to_device(vals, dtype, device)
    rows = _to_device(rows, device=vals.device).long()
    cols = _to_device(cols, device=vals.device).long()
    off = cols - rows + kl
    inband = (off >= 0) & (off <= kl + ku)
    # out-of-band entries land on a scratch row that is dropped
    r = torch.where(inband, rows, n)
    d = torch.where(inband, off, 0)
    data = vals.new_zeros((n + 1, kl + ku + 1))
    data.index_put_((r, d), vals, accumulate=True)
    return BandedMatrix(data=data[:n], kl=kl, ku=ku)


def banded_shift(b: BandedMatrix, alpha) -> BandedMatrix:
    """A + alpha I in band storage (MatShift; the role of PETSc's
    ``-pc_factor_shift_*`` pre-shifts, reference/src/makefile:17-18)."""
    data = b.data.clone()
    data[:, b.kl] += alpha
    return BandedMatrix(data=data, kl=b.kl, ku=b.ku)


def banded_scale(b: BandedMatrix, alpha) -> BandedMatrix:
    """alpha A (MatScale)."""
    return BandedMatrix(data=b.data * alpha, kl=b.kl, ku=b.ku)


def banded_axpy(y: BandedMatrix, alpha, x: BandedMatrix) -> BandedMatrix:
    """Y + alpha X in band storage (MatAXPY).  The result's band is the
    union of the operands'; widening is a zero pad of the offset axis."""
    if y.n != x.n:
        raise ValueError(f"banded_axpy: size mismatch {y.n} vs {x.n}")
    kl, ku = max(y.kl, x.kl), max(y.ku, x.ku)

    def expand(m: BandedMatrix) -> torch.Tensor:
        return torch.nn.functional.pad(m.data, (kl - m.kl, ku - m.ku))

    return BandedMatrix(data=expand(y) + alpha * expand(x), kl=kl, ku=ku)


def banded_bandwidth(b: BandedMatrix, tol: float = 0.0) -> tuple:
    """Effective (kl, ku) of the stored band, the largest offsets holding
    an entry of magnitude > tol (MatComputeBandwidth,
    reference/src/testbed.c:209), as two 0-dim int64 tensors on the band's
    device."""
    any_off = (b.data.abs() > tol).any(dim=0)                # [w]
    offs = torch.arange(-b.kl, b.ku + 1, device=b.device)
    zero = torch.zeros_like(offs)
    return (torch.where(any_off, -offs, zero).max(),
            torch.where(any_off, offs, zero).max())


def banded_from_numpy_dense(a: np.ndarray, kl: int, ku: int,
                            device="cuda") -> BandedMatrix:
    """The [-kl, ku] band of a dense numpy matrix, on ``device``."""
    return banded_from_dense(torch.as_tensor(np.asarray(a), device=device),
                             kl, ku)


def extract_banded_device(rows, cols, vals, n: int, kmax: int = 50,
                          frac: float = 0.95, device=None):
    """Norm-fraction band selection and extraction on the device, the twin
    of ``sparse.extract_banded`` (MatCreateSubMatrixBanded,
    reference/src/matbanded.c:38-103): a histogram of |a_ij| by distance
    from the diagonal, the smallest k < kmax whose cumulative sum reaches
    ``frac`` of the 1-norm (else kmax), then a masked scatter into band
    storage of half-width kmax (entries beyond k zeroed).  Returns
    ``(BandedMatrix, k, achieved_frac)``, k and the fraction as 0-dim
    tensors; kl = ku = kmax (slice on the host for a tight band).  Tensors
    stay on their device; numpy input goes to ``device`` (default the
    card)."""
    vals = _to_device(vals, device=device)
    rows = _to_device(rows, device=vals.device).long()
    cols = _to_device(cols, device=vals.device).long()
    dist = (rows - cols).abs()
    absval = vals.abs()
    hist = absval.new_zeros(n).index_add_(0, dist.clamp_max(n - 1), absval)
    norm_a = absval.sum()
    cum = torch.cumsum(hist, dim=0)
    reached = cum >= frac * norm_a
    first = reached.int().argmax()
    k = torch.where(reached[:kmax].any(), first,
                    torch.full_like(first, kmax)).to(torch.int32)
    norm_b = cum[k.clamp_max(n - 1).long()]
    bm = banded_from_coo(rows, cols,
                         torch.where(dist <= k, vals, torch.zeros_like(vals)),
                         n, kmax, kmax)
    achieved = torch.where(norm_a > 0, norm_b / norm_a,
                           torch.ones_like(norm_a))
    return bm, k, achieved

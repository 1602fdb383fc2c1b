"""Operator normalization: a matrix-like object -> a matvec closure.

The KSP layer only ever sees ``matvec: [n] -> [n]`` (or, for the batched
engines, ``matvec_many: [n, r] -> [n, r]``).  Ported: BandedMatrix (plain
shifted-axpy route, the banded CUDA kernel and its f64 form, or a one-time
block-tridiagonal conversion with the blocktri CUDA kernel; for r columns
the multi-RHS band kernel),
BlockTridiagonal, callables, host SciPy sparse matrices (a band+outliers
split whose band part takes the band route, or a ``torch.sparse_csr_tensor``
product) and dense 2-D matrices (a dense product); ``transpose_operator``
transposes each of these but a callable on the host, for the KSPs that
iterate on A^T and for ``transpose=True``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.band import BandedMatrix, banded_matvec, banded_transpose
from ..ops.blocktri import BlockTridiagonal, band_to_blocktri, blocktri_matvec
from ..ops.cuda.band_matvec import (banded_matvec_prepared, banded_mv_feasible,
                                    prepare_banded_mv)
from ..ops.cuda.band_matvec_f64 import (banded_matvec_prepared_f64,
                                        banded_mv_f64_feasible,
                                        prepare_banded_mv_f64)
from ..ops.cuda.band_matvec_many import banded_matvec_many_prepared
from ..ops.cuda.blocktri_matvec import (blocktri_matvec_cuda,
                                        blocktri_matvec_feasible)
from ..ops.split import split_if_profitable, split_matvec

_IMPLS = ("auto", "banded_pallas", "banded_cuda", "blocktri", "xla")
_BT_BLOCK = 128          # block size of the band -> blocktri conversion


def _use_blocktri_matvec(device: torch.device) -> bool:
    """Whether the blocktri routes may run for an operator (a band or a
    BlockTridiagonal) on ``device``: a CUDA device (the JAX package's rule
    is "the backend is a TPU")."""
    return device.type == "cuda"


def _tag(mv, route: str):
    """Annotate a matvec closure with the route that built it."""
    mv._route = route
    return mv


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown matvec impl {impl!r}: expected auto, banded_pallas, "
            f"banded_cuda, blocktri, or xla (-mat_matvec_impl)")


def _bt_gate(a: BandedMatrix) -> Tuple[bool, bool]:
    """The band->blocktri conversion gate shared by the single- and
    multi-RHS routes: (feasible, wide).

    ``feasible``: the 128-blocked conversion needs max(kl, ku) <= 128, a
    few blocks of rows, and storage of at most 4 bytes per entry.
    ``wide``: the conversion stores 3 * 128 entries per row against w in
    band form, so 'auto' takes it only where that blowup is modest
    (w >= 96, under ~4x)."""
    bt_ok = (max(a.kl, a.ku) <= _BT_BLOCK and a.n >= 4 * _BT_BLOCK
             and a.data.element_size() <= 4)
    return bt_ok, bt_ok and a.width >= 96


def _bt_refused(a: BandedMatrix) -> ValueError:
    """The error for ``impl="blocktri"`` on a CUDA band the route refuses."""
    return ValueError(
        f"-mat_matvec_impl blocktri does not take this band (n={a.n}, "
        f"kl={a.kl}, ku={a.ku}, {a.dtype}): the conversion gate needs "
        f"max(kl, ku) <= {_BT_BLOCK}, n >= {4 * _BT_BLOCK} and at most 4 "
        "bytes per entry, and the single-RHS kernel f32 or bf16 storage")


def blocktri_feasible(a: BandedMatrix) -> bool:
    """Whether the blocktri route takes this band: the conversion gate and
    the single-RHS kernel (f32 or bf16 storage) admit it."""
    return _bt_gate(a)[0] and blocktri_matvec_feasible(a.dtype, _BT_BLOCK)


def _band_route(a: BandedMatrix, impl: str) -> str:
    """Resolve ``-mat_matvec_impl`` for a band.

    * ``auto``: on a CUDA band, the f64 band kernel (#6) for an f64 band
      ``banded_mv_f64_feasible`` admits, the banded CUDA kernel (#2)
      whenever ``banded_mv_feasible`` admits the band, else the plain
      version; on the CPU the plain version.  (The JAX package's 'auto'
      keeps f64 bands on XLA because its TPU kernel for them emulates f64;
      the card has FP64, so its f64 kernel is the route.  The JAX TPU
      order also has the blocktri route between the band kernel and XLA
      for wide bands, and follows ``utils.tuning`` records; here the band
      kernel admits every band the blocktri kernel does and beat it at
      every shape ``tools/tune.py`` measured on the card, so 'auto'
      follows no record and takes no blocktri branch.)
    * ``banded_pallas`` / ``banded_cuda``: the banded kernel's wrapper, #6
      for an f64 band and #2 otherwise (on the CPU the wrapper runs the
      kernel's plain version);
    * ``blocktri``: on a CUDA band, the blocktri kernel, raising where the
      gate or the kernel refuses the band; on the CPU the plain version
      (as the JAX package off the TPU);
    * ``xla``: the plain shifted-axpy version.
    """
    f64 = a.dtype == torch.float64
    if impl in ("banded_pallas", "banded_cuda"):
        return "banded_cuda_f64" if f64 else "banded_cuda"
    if impl == "auto" and a.data.is_cuda:
        if f64 and banded_mv_f64_feasible(a):
            return "banded_cuda_f64"
        if banded_mv_feasible(a):
            return "banded_cuda"
    if impl == "blocktri" and _use_blocktri_matvec(a.device):
        if not blocktri_feasible(a):
            raise _bt_refused(a)
        return "blocktri"
    return "xla"


def transpose_operator(a):
    """Host-side operator transpose (pure transpose, no conjugation): a
    band in band storage (``banded_transpose``, kl and ku swapped), a
    block-tridiagonal matrix block by block, a SciPy sparse matrix as CSR
    (``as_matvec`` then plans the band+outliers split of A^T as it plans
    A's), a dense matrix.  A callable cannot be transposed."""
    if isinstance(a, BandedMatrix):
        return banded_transpose(a)
    if isinstance(a, BlockTridiagonal):
        def tT(x):
            return x.transpose(-1, -2)
        zb = torch.zeros_like(a.D[:1])
        return BlockTridiagonal(
            D=tT(a.D).contiguous(),
            L=torch.cat([zb, tT(a.U[:-1])], dim=0),
            U=torch.cat([tT(a.L[1:]), zb], dim=0))
    if callable(a):
        raise TypeError(
            "cannot transpose a bare matvec callable; pass an explicit "
            "operator (BandedMatrix / BlockTridiagonal / sparse / dense) "
            "or supply matvec_transpose yourself")
    if sp.issparse(a):
        return a.T.tocsr()
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        return a.T.contiguous()
    if isinstance(a, np.ndarray) and a.ndim == 2:
        return np.ascontiguousarray(a.T)
    raise TypeError(f"cannot transpose operator of type {type(a)!r}")


def as_matvec(a, n_hint: int = None, impl: str = "auto", device=None,
              dtype=None) -> Tuple[Callable, int, object]:
    """Return (matvec, n, dtype) for a BandedMatrix, a BlockTridiagonal, a
    callable, a host SciPy sparse matrix or a dense 2-D matrix.  ``impl``
    selects the band route (``_band_route``), also of a split's band part.
    A host or dense matrix is placed on ``device`` (default the card) in
    ``dtype`` (default its own)."""
    _check_impl(impl)
    if isinstance(a, BandedMatrix):
        route = _band_route(a, impl)
        if route == "banded_cuda":
            prep = prepare_banded_mv(a)
            return (_tag(lambda x: banded_matvec_prepared(prep, x), route),
                    a.n, a.dtype)
        if route == "banded_cuda_f64":
            prep = prepare_banded_mv_f64(a)
            return (_tag(lambda x: banded_matvec_prepared_f64(prep, x),
                         route), a.n, a.dtype)
        if route == "blocktri":
            # one conversion, held for the operator's lifetime; the kernel
            # takes the unpadded blocks and reads x as zero beyond n
            T = band_to_blocktri(a, _BT_BLOCK)
            return (_tag(lambda x: blocktri_matvec_cuda(T, x), route),
                    a.n, a.dtype)
        return _tag(lambda x: banded_matvec(a, x), route), a.n, a.dtype
    if isinstance(a, BlockTridiagonal):
        nb, b = a.nb, a.b
        if _use_blocktri_matvec(a.D.device) \
                and blocktri_matvec_feasible(a.dtype, b):
            return (_tag(lambda x: blocktri_matvec_cuda(a, x), "blocktri"),
                    nb * b, a.dtype)
        return (_tag(lambda x: blocktri_matvec(a, x.reshape(nb, b))
                     .reshape(-1), "xla"), nb * b, a.dtype)
    if callable(a):
        if n_hint is None:
            raise ValueError("callable operator requires n_hint (vector size)")
        return a, n_hint, None
    return _as_matvec_other(a, impl, torch.device(device or "cuda"), dtype)


def _as_matvec_other(a, impl, device, dtype) -> Tuple[Callable, int, object]:
    """A host SciPy sparse matrix: the band+outliers split where
    ``split_plan`` finds it profitable (its band part on the band route,
    the outliers by ``index_add_``), else a sparse CSR product; a dense
    2-D matrix: a dense product."""
    if sp.issparse(a):
        n = a.shape[0]
        sm = split_if_profitable(a, dtype=dtype, device=device)
        if sm is not None:
            band_mv, _, _ = as_matvec(sm.band, impl=impl)
            return (_tag(lambda x: split_matvec(sm, x, band_mv),
                         f"split_{band_mv._route}"), n, sm.dtype)
        csr = a.tocsr()
        mat = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data), size=csr.shape).to(
                device=device, dtype=dtype)
        return _tag(lambda x: mat @ x, "sparse_csr"), n, mat.dtype
    if isinstance(a, (np.ndarray, torch.Tensor)) and a.ndim == 2:
        arr = torch.as_tensor(a).to(device=device, dtype=dtype)
        return _tag(lambda x: arr @ x, "dense"), arr.shape[0], arr.dtype
    raise NotImplementedError(
        f"operators of type {type(a).__name__} are not yet ported to "
        "spike_petsc_tpu_torch")


def _many_route(a: BandedMatrix, impl: str, device: torch.device) -> str:
    """The multi-RHS route of a band lying on ``device`` under
    ``-mat_matvec_impl impl``: the single source of that choice.

    * ``banded_cuda_many``: 'auto', ``banded_cuda`` and ``banded_pallas``
      on a CUDA device, for every band the banded kernel's rule admits
      (``banded_mv_feasible``: f32 or bf16 storage, any width it takes):
      the multi-RHS band kernel (#11) reads the band once for all r
      columns.  Its tiles adapt to kl, ku and r; no width takes another
      route;
    * ``blocktri_many``: ``impl="blocktri"`` where the blocktri routes may
      run (raising where the conversion gate refuses the band), and 'auto'
      there for a wide band no banded kernel takes (f16 storage);
    * ``vmap``: the column loop over the single-RHS route: f64 bands (#6 a
      column), ``xla`` (the plain version), and every band on the CPU.
    """
    if impl in ("auto", "banded_cuda", "banded_pallas") \
            and device.type == "cuda" and banded_mv_feasible(a):
        return "banded_cuda_many"
    if impl in ("auto", "blocktri") and _use_blocktri_matvec(device):
        bt_ok, wide = _bt_gate(a)
        if impl == "blocktri" and not bt_ok:
            raise _bt_refused(a)
        if bt_ok and (impl == "blocktri" or wide):
            return "blocktri_many"
    return "vmap"


def as_matvec_many(a, n_hint: int = None, impl: str = "auto", device=None,
                   dtype=None) -> Tuple[Callable, int, object]:
    """Return (matvec_many: [n, r] -> [n, r], n, dtype): a true multi-RHS
    operator apply for the batched Krylov engines (``krylov_many``).

    Routes, tagged on the closure:
      * a band takes ``_many_route``'s: ``banded_cuda_many``, one launch of
        the multi-RHS band kernel on the layout ``prepare_banded_mv``
        builds once; ``blocktri_many``, one band->blocktri conversion, held
        beside the band (3 * 128 entries a row), then ``blocktri_matvec``
        on ``[nb, b, r]`` as batched products; or the column loop below;
      * a BlockTridiagonal operator takes ``blocktri_many``'s product;
      * ``dense_many``: a dense 2-D matrix, ``A @ X``;
      * ``vmap_<route>``: everything else applies the single-RHS route
        column by column.
    """
    _check_impl(impl)
    route = (_many_route(a, impl, a.device) if isinstance(a, BandedMatrix)
             else None)
    if route == "banded_cuda_many":
        prep = prepare_banded_mv(a)
        return (_tag(lambda X: banded_matvec_many_prepared(prep, X), route),
                a.n, a.dtype)
    if route == "blocktri_many":
        T = band_to_blocktri(a, _BT_BLOCK)
        nb, b, n = T.nb, T.b, a.n

        def mv_many(X):
            Xb = torch.nn.functional.pad(X, (0, 0, 0, nb * b - n))
            return blocktri_matvec(T, Xb.reshape(nb, b, -1)).reshape(
                nb * b, -1)[:n]
        return _tag(mv_many, route), n, a.dtype
    if isinstance(a, BlockTridiagonal):
        nb, b = a.nb, a.b

        def mv_bt(X):
            return blocktri_matvec(a, X.reshape(nb, b, -1)).reshape(nb * b, -1)
        return _tag(mv_bt, "blocktri_many"), nb * b, a.dtype
    if isinstance(a, (np.ndarray, torch.Tensor)) and a.ndim == 2:
        mv, n, dt = as_matvec(a, impl=impl, device=device, dtype=dtype)
        return _tag(mv, "dense_many"), n, dt
    mv, n, dt = as_matvec(a, n_hint=n_hint, impl=impl, device=device,
                          dtype=dtype)

    def mv_cols(X):
        return torch.stack([mv(X[:, j]) for j in range(X.shape[1])], dim=1)
    return _tag(mv_cols, f"vmap_{getattr(mv, '_route', 'op')}"), n, dt

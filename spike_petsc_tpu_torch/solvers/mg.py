"""Geometric multigrid preconditioner for banded operators (PCMG role),
PyTorch.

The port of ``spike_petsc_tpu.solvers.mg``:

* **Hierarchy**: 1-D factor-2 coarsening with linear interpolation P and
  full-weighting restriction R = P^T; the coarse operators are Galerkin
  products A_c = P^T A P, formed once at set-up on the host in f64 (SciPy)
  and placed as bands on the fine band's device in its dtype.
* **Smoothers**: weighted Jacobi (default omega 2/3) or block SSOR (the
  ``sor`` PC, whose sweeps take the sweep kernels on the card where its
  block is 64 or 128).
* **Coarse solve**: one exact partition (K = 1) of ``spike_factor``.  On
  the card its block is the kernels' (``default_block``: 64 for a tip of at
  most 64), not the tip size of JAX ``mg.py:139``, so the coarse solve is
  the fused sweep #1 over a block row or two rather than a plain loop over
  up to 128 block rows; the answer changes only by rounding.  Its inverter
  is 'auto', which is 'lapack' on every device here (the JAX package takes
  Newton on the TPU).
* **Apply**: a V(pre, post)-cycle; every level's operator is applied by
  ``as_matvec`` (the band kernel #2 on the card), ``apply_many`` runs the
  cycle on ``[n, r]`` blocks through ``as_matvec_many``, and the transpose
  is the exact adjoint of the cycle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import sparse as hsp
from ..ops.band import BandedMatrix, banded_diagonal, banded_transpose
from ..ops.spike import (spike_factor, spike_solve, spike_solve_many,
                         spike_transpose)
from ..utils.options import Options
from .operator import as_matvec, as_matvec_many
from .pc import PC, _as_banded, default_block, make_pc, register_pc


def _band_to_csr(band: BandedMatrix) -> sp.csr_matrix:
    """Host f64 CSR from diagonal-offset band storage
    (data[i, d] = A[i, i + d - kl])."""
    n, kl, ku = band.n, band.kl, band.ku
    data = band.data.detach().cpu().double().numpy()
    diags, offs = [], []
    for j in range(kl + ku + 1):
        d = j - kl
        v = data[max(0, -d):n - max(0, d), j]
        if v.size:
            diags.append(v)
            offs.append(d)
    return sp.diags(diags, offs, shape=(n, n), format="csr")


def _interp(n_f: int) -> sp.csr_matrix:
    """1-D linear interpolation P: [n_f, n_c], the coarse points at the
    even fine indices."""
    n_c = (n_f + 1) // 2
    even = np.arange(0, n_f, 2)
    odd = np.arange(1, n_f, 2)
    rows = [even, odd]
    cols = [even // 2, odd // 2]
    vals = [np.ones(even.size), np.full(odd.size, 0.5)]
    right = odd // 2 + 1
    keep = right < n_c
    rows.append(odd[keep])
    cols.append(right[keep])
    vals.append(np.full(keep.sum(), 0.5))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_f, n_c))


def _prolong(xc: torch.Tensor, n_f: int) -> torch.Tensor:
    """P @ xc (matrix-free interleave); xc ``[n_c]`` or ``[n_c, r]``."""
    xc_next = torch.cat([xc[1:], torch.zeros_like(xc[:1])])
    xf = torch.stack([xc, 0.5 * (xc + xc_next)], dim=1)
    return xf.reshape(-1, *xc.shape[1:])[:n_f]


def _restrict(rf: torch.Tensor, n_c: int) -> torch.Tensor:
    """P^T @ rf (matrix-free fold); rf ``[n_f]`` or ``[n_f, r]``."""
    rfp = rf.new_zeros((2 * n_c, *rf.shape[1:]))
    rfp[:rf.shape[0]] = rf
    pairs = rfp.reshape(n_c, 2, *rf.shape[1:])
    even, odd = pairs[:, 0], pairs[:, 1]
    odd_prev = torch.cat([torch.zeros_like(odd[:1]), odd[:-1]])
    return even + 0.5 * (odd + odd_prev)


class _Level:
    """One level: its band, its smoother (built at set-up), and per
    direction (forward, transposed) the operator apply and the smoother,
    single- and multi-column."""

    def __init__(self, band: BandedMatrix, kind: str, opts: Options):
        self.band = band
        self.n = band.n
        if kind == "jacobi":
            omega = float(opts.get_real("pc_mg_jacobi_omega", 2.0 / 3.0))
            d = banded_diagonal(band)
            one = torch.ones_like(d)
            self.dinv = omega * torch.where(
                d != 0, 1.0 / torch.where(d != 0, d, one), one)
            self.sor = None
        elif kind == "sor":
            self.sor = make_pc("sor", band, opts.scoped("mg_smoother_"))
        else:
            raise ValueError(f"unknown -pc_mg_smoother {kind!r} "
                             "(jacobi | sor)")
        self._ops = {}
        self.ops(False)

    def ops(self, transposed: bool):
        """(matvec, matvec_many, smooth, smooth_many) for A, or for A^T
        where ``transposed`` (built on first use).  The smoother is an
        approximate inverse used as x += smooth(r - A x); Jacobi's is its
        own transpose."""
        if transposed not in self._ops:
            op = banded_transpose(self.band) if transposed else self.band
            if self.sor is None:
                dinv = self.dinv
                smooth = (lambda r: dinv * r,
                          lambda R: dinv[:, None] * R)
            else:
                pc = self.sor.transpose() if transposed else self.sor
                smooth = (pc.apply, pc.apply_many)
            self._ops[transposed] = (as_matvec(op)[0], as_matvec_many(op)[0],
                                     *smooth)
        return self._ops[transposed]


def _build_hierarchy(band: BandedMatrix, opts: Options):
    """The Galerkin hierarchy (a list of ``_Level``) and the coarse
    factor."""
    kind = opts.get_string("pc_mg_smoother", "jacobi")
    coarse_size = opts.get_int("pc_mg_coarse_size", 64)
    max_levels = opts.get_int("pc_mg_levels", 0)       # 0: automatic
    levels = [_Level(band, kind, opts)]
    a = _band_to_csr(band)
    while levels[-1].n > max(2 * coarse_size, 4) and (
            max_levels <= 0 or len(levels) < max_levels):
        P = _interp(a.shape[0])
        a = (P.T @ a @ P).tocsr()
        a.eliminate_zeros()
        data, kl, ku = hsp.csr_to_banded_arrays(a)
        cband = BandedMatrix(
            data=torch.as_tensor(data).to(device=band.device,
                                          dtype=band.dtype), kl=kl, ku=ku)
        levels.append(_Level(cband, kind, opts))
    cb = levels[-1].band
    block = default_block(None, max(cb.kl, cb.ku, 1), "inv",
                          cb.data.is_cuda)
    return levels, spike_factor(cb, K=1, block_b=block, inverter="auto")


def _make_vcycle(levels, fact, pre: int, post: int, transposed: bool,
                 many: bool):
    """The V(pre, post)-cycle ``r -> x`` (``[n]``, or ``[n, r]`` with
    ``many``).  ``transposed`` applies the exact transpose of the forward
    cycle: A^T, the transposed smoothers with pre and post swapped, the
    transposed coarse solve; P and R = P^T swap into each other, so the
    grid transfers are reused as they are."""
    npre, npost = (post, pre) if transposed else (pre, post)
    coarse = spike_solve_many if many else spike_solve
    last = len(levels) - 1

    def cycle(lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == last:
            return coarse(fact, r)
        L = levels[lvl]
        mv, mv_many, smooth, smooth_many = L.ops(transposed)
        mv, smooth = (mv_many, smooth_many) if many else (mv, smooth)
        if npre > 0:
            x = smooth(r)
            for _ in range(npre - 1):
                x = x + smooth(r - mv(x))
        else:
            x = torch.zeros_like(r)
        xc = cycle(lvl + 1, _restrict(r - mv(x), levels[lvl + 1].n))
        x = x + _prolong(xc, L.n)
        for _ in range(npost):
            x = x + smooth(r - mv(x))
        return x

    return lambda r: cycle(0, r)


@register_pc("mg")
def pc_mg(pmat, opts: Options) -> PC:
    """Geometric multigrid V-cycle preconditioner (``-pc_type mg``, JAX
    ``solvers/mg.py``).  Options: ``-pc_mg_levels`` (0: coarsen until
    ``-pc_mg_coarse_size``, default 64), ``-pc_mg_smoother jacobi|sor``
    (jacobi), ``-pc_mg_jacobi_omega`` (2/3), ``-pc_mg_smooth_down`` and
    ``-pc_mg_smooth_up`` (1 and 1), the smoother's options under the
    ``mg_smoother_`` prefix (``-mg_smoother_pc_sor_omega``, ...).  Suits
    bands whose graph is 1-D elliptic (BASELINE config 1's Laplacian)."""
    band = _as_banded(pmat, opts)
    pre = opts.get_int("pc_mg_smooth_down", 1)
    post = opts.get_int("pc_mg_smooth_up", 1)
    levels, fact = _build_hierarchy(band, opts)
    info = dict(levels=len(levels), coarse_n=levels[-1].n,
                smoother=opts.get_string("pc_mg_smoother", "jacobi"),
                smooth=(pre, post))

    def make_transpose():
        fact_t = spike_transpose(fact, band=levels[-1].band)
        for L in levels[:-1]:
            L.ops(True)
        return PC(name="mg_transpose",
                  apply=_make_vcycle(levels, fact_t, pre, post, True, False),
                  apply_many=_make_vcycle(levels, fact_t, pre, post, True,
                                          True),
                  info=info)

    return PC(name="mg", apply=_make_vcycle(levels, fact, pre, post, False,
                                            False),
              apply_many=_make_vcycle(levels, fact, pre, post, False, True),
              info=info, make_transpose=make_transpose)

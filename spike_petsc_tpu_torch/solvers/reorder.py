"""Reordered solve wrapper (KSPREORDER equivalent).

The reference registers a KSP type that solves the non-symmetrically permuted
system: setup computes an ordering of the preconditioning matrix, permutes the
operators, and configures an inner KSP under the ``reorder_`` prefix; solve
permutes rhs/solution in and back out (reference/src/kspreorder.c:11-28,
112-129, 197-223).

``solve_reordered`` is the functional re-design, extended with the scaling
step the reference's orderings compute but never apply (MC64/AWBM row/column
scalings — SURVEY.md §7 hard-part 2): with ``scale=True`` the system solved is

    (R Dr A Dc C) z = (Dr b)[rperm],        x = Dc * scatter(z, cperm)

which is exactly the permuted-residual identity the reference's `#if 0` debug
harness cross-checks (reference/src/kspreorder.c:34-111).  The ordering,
the permutation, the scaling and the back-permutation run on the host; the
permuted operator and right-hand side go to ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import sparse as hsp
from ..ops.band import BandedMatrix
from ..ordering import get_ordering
from ..utils.options import Options
from .ksp import solve
from .types import KSPResult


def _to_numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def solve_reordered(A, b, x0=None, *, options: Optional[Options] = None,
                    ordering: Optional[str] = None, scale: Optional[bool] = None,
                    pmat=None, to_banded: bool = True, device=None,
                    dtype=None, **params) -> KSPResult:
    """Solve A x = b on the reordered (optionally scaled) system.

    Args:
      A: host sparse/dense matrix (orderings are host-side setup work).
      ordering: registry name; default from ``-mat_ordering_type``
        (reference/src/kspreorder.c:146).
      scale: apply the ordering's row/col scalings when it provides them.
      to_banded: ship the permuted operator to the device as band storage
        when its bandwidth is moderate (else the host operator routes of
        ``as_matvec``: a band+outliers split or a sparse CSR product).
      device, dtype: where the solve runs: default ``b``'s device and dtype
        when ``b`` is a tensor, else the card in float64.
      params/options: forwarded to the inner solve under the ``reorder_``
        prefix (e.g. -reorder_ksp_type, -reorder_pc_type).
    """
    opts = options or Options()
    ordering = ordering or opts.get_string("mat_ordering_type", "natural")
    if scale is None:
        scale = opts.get_bool("mat_ordering_scale", False)
    if isinstance(b, torch.Tensor):
        device = device or b.device
        dtype = dtype or b.dtype
    device = torch.device(device or "cuda")
    dtype = dtype or torch.float64

    acsr = hsp.as_csr(A)
    n = acsr.shape[0]
    ores = get_ordering(acsr if pmat is None else hsp.as_csr(pmat),
                        ordering, opts)
    use_scale = scale and ores.row_scale is not None
    pa = ores.apply(acsr, scale=use_scale)

    b = _to_numpy(b)
    bp = (ores.row_scale * b) if use_scale else b
    bp = bp[ores.rperm]

    def dev(v):
        return torch.as_tensor(v).to(device=device, dtype=dtype)

    x0p = None
    if x0 is not None:
        x0arr = _to_numpy(x0)
        y0 = x0arr / ores.col_scale if use_scale else x0arr
        x0p = dev(y0[ores.cperm])

    inner_opts = opts.scoped("reorder_")
    operator = pa
    if to_banded:
        kl, ku = hsp.compute_half_bandwidths(pa)
        if kl + ku + 1 <= max(64, n // 4):
            data, kl, ku = hsp.csr_to_banded_arrays(pa, kl=kl, ku=ku)
            operator = BandedMatrix(data=dev(data), kl=kl, ku=ku)

    res = solve(operator, dev(bp), x0p, options=inner_opts, **params)

    # back-permute: z solves the permuted system; x = Dc * scatter(z, cperm)
    z = res.x.cpu().numpy()
    y = np.empty_like(z)
    y[ores.cperm] = z
    x = ores.col_scale * y if use_scale else y
    return KSPResult(x=dev(x), its=res.its, reason=res.reason,
                     rnorm=res.rnorm, history=res.history,
                     true_history=res.true_history)

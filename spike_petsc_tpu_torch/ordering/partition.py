"""Spectral partitioning for multi-device SPIKE decomposition.

Re-design of the reference's standalone partitioner
(reference/src/spectralPartition.c:247-444): build the Laplacian, take
the Fiedler vector, split by sign (or by sorted median for balanced halves —
the fIS/fIS2 pair at :326-348), reorder each block with RCM (:379-388), and
stitch the block orderings into one global permutation (:393-417) whose
banded extraction is compared before/after (:429-437).

Generalized to 2^levels partitions by recursive bisection — the feed-in for
K-partition SPIKE where the reference stops at 2 blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import scipy.sparse as sp

from .. import sparse as hsp
from ..utils.registry import register_ordering
from .base import OrderingResult
from .fiedler import fiedler_vector, graph_laplacian
from .rcm import rcm


@dataclass
class PartitionResult:
    perm: np.ndarray              # global stitched permutation
    parts: List[np.ndarray]       # original indices per partition (in order)
    sizes: List[int]
    info: dict = field(default_factory=dict)

    def as_ordering(self) -> OrderingResult:
        return OrderingResult(rperm=self.perm, cperm=self.perm.copy(),
                              info=dict(self.info, type="spectral"))


def _bisect(indices: np.ndarray, sub: sp.csr_matrix, balanced: bool,
            tol: float, method: str):
    lap = graph_laplacian(sub, tol=tol)
    vec, _ = fiedler_vector(lap, method=method)
    if balanced:
        # sorted-median split (the fIS2 variant, spectralPartition.c:337-348)
        order = np.argsort(vec, kind="stable")
        half = len(order) // 2
        neg, pos = order[:half], order[half:]
    else:
        neg = np.flatnonzero(vec < 0)
        pos = np.flatnonzero(vec >= 0)
        if len(neg) == 0 or len(pos) == 0:       # degenerate: force a split
            order = np.argsort(vec, kind="stable")
            half = len(order) // 2
            neg, pos = order[:half], order[half:]
    return indices[neg], indices[pos]


def spectral_partition(a, levels: int = 1, balanced: bool = True,
                       tol: float = 1e-12, block_reorder: str = "rcm",
                       method: str = "auto") -> PartitionResult:
    """Recursive spectral bisection into 2^levels blocks with per-block
    bandwidth-reducing reordering and a stitched global permutation."""
    csr = hsp.as_csr(a)
    n = csr.shape[0]
    parts = [np.arange(n)]
    for _ in range(levels):
        nxt = []
        for idx in parts:
            if len(idx) <= 2:
                nxt.append(idx)
                continue
            sub = csr[idx, :][:, idx]
            left, right = _bisect(idx, sub, balanced, tol, method)
            nxt.extend([left, right])
        parts = nxt

    # per-block reorder + stitch (spectralPartition.c:379-417)
    stitched = []
    for idx in parts:
        if block_reorder == "rcm" and len(idx) > 1:
            sub = csr[idx, :][:, idx]
            local = rcm(sub).rperm
            stitched.append(idx[local])
        else:
            stitched.append(idx)
    perm = np.concatenate(stitched) if stitched else np.arange(n)

    bw_in = hsp.compute_bandwidth(csr)
    pa = hsp.permute(csr, perm, perm)
    bw_out = hsp.compute_bandwidth(pa)
    # interface edge count: couplings crossing partition boundaries
    bounds = np.cumsum([0] + [len(p) for p in stitched])
    owner = np.empty(n, dtype=np.int64)
    for pi in range(len(stitched)):
        owner[bounds[pi]:bounds[pi + 1]] = pi
    coo = pa.tocoo()
    cut = int((owner[coo.row] != owner[coo.col]).sum())

    return PartitionResult(
        perm=perm, parts=stitched, sizes=[len(p) for p in stitched],
        info=dict(levels=levels, balanced=balanced,
                  bandwidth_in=bw_in, bandwidth_out=bw_out, edge_cut=cut))


@register_ordering("spectral")
def ordering_spectral(a, options=None) -> OrderingResult:
    levels = options.get_int("mat_ordering_spectral_levels", 1) \
        if options is not None else 1
    balanced = options.get_bool("mat_ordering_spectral_balanced", True) \
        if options is not None else True
    return spectral_partition(a, levels=levels,
                              balanced=balanced).as_ordering()

"""Reverse Cuthill-McKee bandwidth-reducing ordering.

The reference reaches RCM through PETSc's built-in MatOrdering registry
(``-mat_ordering_type2 rcm`` recipes, reference/src/HOWTO:2) and uses it
per-partition inside the spectral partitioner
(reference/src/spectralPartition.c:379-388).  Engine: SciPy's
compiled reverse_cuthill_mckee on the symmetrized pattern, with a pure-NumPy
BFS fallback kept for environments without scipy.sparse.csgraph.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.registry import register_ordering
from .base import OrderingResult


def _rcm_bfs(adj: sp.csr_matrix) -> np.ndarray:
    """Plain BFS Cuthill-McKee (reversed) — fallback oracle."""
    n = adj.shape[0]
    deg = np.diff(adj.indptr)
    visited = np.zeros(n, dtype=bool)
    order = []
    for start in np.argsort(deg):
        if visited[start]:
            continue
        queue = [int(start)]
        visited[start] = True
        while queue:
            node = queue.pop(0)
            order.append(node)
            nbrs = adj.indices[adj.indptr[node]:adj.indptr[node + 1]]
            nbrs = [int(x) for x in nbrs[np.argsort(deg[nbrs])]
                    if not visited[x]]
            for x in nbrs:
                visited[x] = True
            queue.extend(nbrs)
    return np.asarray(order[::-1], dtype=np.int64)


def rcm(a, use_scipy: bool = True) -> OrderingResult:
    csr = sp.csr_matrix(a)
    pattern = csr + csr.T  # symmetrize, as PETSc's RCM does for ordering
    pattern = sp.csr_matrix(
        (np.ones_like(pattern.data), pattern.indices, pattern.indptr),
        shape=pattern.shape)
    if use_scipy:
        perm = sp.csgraph.reverse_cuthill_mckee(pattern, symmetric_mode=True)
        perm = perm.astype(np.int64)
    else:
        perm = _rcm_bfs(pattern)
    return OrderingResult(rperm=perm, cperm=perm.copy(),
                          info=dict(type="rcm"))


@register_ordering("rcm")
def ordering_rcm(a, options=None) -> OrderingResult:
    return rcm(a)

"""Bipartite matching engines for the MC64-equivalent ordering suite.

The reference's engine is the f2c'd HSL MC64 (5791 lines,
reference/src/hslmc64.c): max-cardinality DFS matching, bottleneck
matchings, and shortest-augmenting-path assignment with dual variables.
These algorithms are inherently sequential graph traversals (SURVEY.md §7
hard-part 1), so they run host-side at setup time — implemented here from the
algorithm literature (Duff & Koster 2001; Jonker & Volgenant 1987), *not*
translated from the HSL source.  A C++ native engine with the same API plugs
in via the package's ``native`` module when built; this module is the reference
Python/NumPy implementation and the fallback.

All engines speak CSC-of-|A| form: (n, col_ptr, row_ind, weights).
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def _to_csc_abs(a) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    return (csc.shape[0], csc.indptr.astype(np.int64),
            csc.indices.astype(np.int64), np.abs(csc.data.astype(np.float64)))


# ---------------------------------------------------------------------------
# Maximum-cardinality matching (MC64 job 1 equivalent)
# ---------------------------------------------------------------------------

def _native_hk():
    try:
        from ..native import loader
        return loader.get_hopcroft_karp()
    except Exception:
        return None


def max_cardinality_match(a) -> Tuple[np.ndarray, int]:
    """match[j] = row matched to column j (-1 if unmatched); returns
    (match, cardinality).  Engine: native C++ Hopcroft-Karp
    (native/src/hopcroft_karp.cpp) with SciPy fallback."""
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    hk = _native_hk()
    if hk is not None:
        match, card = hk(csc.shape[0], csc.indptr.astype(np.int64),
                         csc.indices.astype(np.int64))
        return match, card
    match = sp.csgraph.maximum_bipartite_matching(csc.tocsr(), perm_type="row")
    card = int((match >= 0).sum())
    return match.astype(np.int64), card


# ---------------------------------------------------------------------------
# Bottleneck matching (MC64 jobs 2/3 equivalent)
# ---------------------------------------------------------------------------

def bottleneck_match(a) -> Tuple[np.ndarray, float]:
    """Perfect matching maximizing min |a_ij| over matched entries.

    Binary search over the sorted magnitude values; feasibility = perfect
    matching in the graph restricted to |a_ij| >= threshold.  Functionally
    equivalent to HSLmc64BD/SD threshold strategies
    (reference/src/hslmc64.c:1002,1432) without their specific
    data structures.
    """
    n, ptr, rows, w = _to_csc_abs(a)
    vals = np.unique(w)
    lo, hi = 0, len(vals) - 1
    best_match, best_t = None, 0.0
    hk = _native_hk()

    if hk is not None:
        def feasible(t):
            m, card = hk(n, ptr, rows, weights=w, threshold=t)
            return card == n, m
    else:
        coo = sp.csc_matrix((w, rows, ptr), shape=(n, n)).tocoo()

        def feasible(t):
            keep = coo.data >= t
            g = sp.csr_matrix((coo.data[keep],
                               (coo.row[keep], coo.col[keep])), shape=(n, n))
            m = sp.csgraph.maximum_bipartite_matching(g, perm_type="row")
            return (m >= 0).all(), m

    ok, m = feasible(vals[0])
    if not ok:
        # structurally singular: best effort at the smallest threshold
        return m.astype(np.int64), 0.0
    best_match, best_t = m, float(vals[0])
    while lo <= hi:
        mid = (lo + hi) // 2
        ok, m = feasible(vals[mid])
        if ok:
            best_match, best_t = m, float(vals[mid])
            lo = mid + 1
        else:
            hi = mid - 1
    return best_match.astype(np.int64), best_t


def bottleneck_match_sorted(a) -> Tuple[np.ndarray, float]:
    """Bottleneck matching via the MC64 job-3 strategy: sort + threshold
    bisection with REPEATED MAX-MATCHING REUSE.

    Same objective as ``bottleneck_match`` (job 2), different algorithm —
    mirroring the reference's two strategies (HSLmc64BD
    reference/src/hslmc64.c:1002 vs the sort (mc64RD :4294) +
    bisection (HSLmc64SD :1432) + repeated-max-matching (HSLmc64UD :1698)
    family).  Each bisection probe warm-starts from the best feasible
    matching found at a lower threshold: matched edges whose weight survives
    the new threshold are kept and only the broken columns are re-augmented
    (Kuhn augmenting DFS over per-column weight-sorted adjacency prefixes),
    instead of recomputing a maximum matching from scratch per probe.

    Engine: native C++ (native/src/bottleneck_sorted.cpp) with this module's
    pure-Python implementation as the fallback; the warm-start reuse is what
    lets job 3 beat the from-scratch job-2 oracle at large n.
    """
    n, ptr, rows, w = _to_csc_abs(a)
    if n == 0:
        return np.empty(0, np.int64), 0.0

    try:
        from ..native import loader
        native = loader.get_bottleneck_sorted()
    except Exception:
        native = None
    if native is not None:
        match, t, _feasible = native(n, ptr, rows, w)
        return match, t

    # per-column adjacency sorted by weight descending: the admissible edges
    # at threshold t are then a prefix of each column's list (mc64RD's sort)
    rows_s = np.empty_like(rows)
    w_s = np.empty_like(w)
    for j in range(n):
        s, e = ptr[j], ptr[j + 1]
        idx = np.argsort(-w[s:e], kind="stable")
        rows_s[s:e] = rows[s:e][idx]
        w_s[s:e] = w[s:e][idx]

    vals = np.unique(w)                       # ascending distinct weights
    col_match = np.full(n, -1, np.int64)
    row_match = np.full(n, -1, np.int64)
    matched_w = np.zeros(n)                   # weight of column j's edge
    visited = np.full(n, -1, np.int64)        # row visit stamps
    stamp = 0

    def active_ends(t: float) -> np.ndarray:
        ends = np.empty(n, np.int64)
        for j in range(n):
            s, e = ptr[j], ptr[j + 1]
            # w_s[s:e] is descending; admissible prefix = entries >= t
            ends[j] = s + np.searchsorted(-w_s[s:e], -t, side="right")
        return ends

    def try_augment(j0: int, ends: np.ndarray, st: int) -> bool:
        """Iterative Kuhn DFS from unmatched column j0 over the admissible
        prefixes; applies the augmenting path in place."""
        cols = [j0]
        pos = [int(ptr[j0])]
        taken: list = []                      # row chosen at each depth
        while cols:
            j = cols[-1]
            t = pos[-1]
            descended = False
            while t < ends[j]:
                i = int(rows_s[t])
                wt = w_s[t]
                t += 1
                if visited[i] == st:
                    continue
                visited[i] = st
                if row_match[i] < 0:
                    # free row: unwind, flipping the alternating path
                    pos[-1] = t
                    cur, cw = i, wt
                    for d in range(len(cols) - 1, -1, -1):
                        jj = cols[d]
                        row_match[cur] = jj
                        col_match[jj] = cur
                        matched_w[jj] = cw
                        if d > 0:
                            cur = taken[d - 1][0]
                            cw = taken[d - 1][1]
                    return True
                pos[-1] = t
                taken.append((i, wt))
                nxt = int(row_match[i])
                cols.append(nxt)
                pos.append(int(ptr[nxt]))
                descended = True
                break
            if not descended:
                cols.pop()
                pos.pop()
                if taken:
                    taken.pop()
        return False

    def probe(t: float) -> bool:
        """Feasibility of threshold t, warm-started from the current
        matching (HSLmc64UD's repeated-max-matching reuse)."""
        nonlocal stamp
        ends = active_ends(t)
        # drop matched edges that fall below the new threshold
        for j in range(n):
            if col_match[j] >= 0 and matched_w[j] < t:
                row_match[col_match[j]] = -1
                col_match[j] = -1
        ok = True
        for j in range(n):
            if col_match[j] < 0:
                stamp += 1
                if not try_augment(j, ends, stamp):
                    ok = False
        return ok

    if not probe(float(vals[0])):
        # structurally singular: best effort at the smallest threshold
        return col_match.copy(), 0.0
    best = (col_match.copy(), float(vals[0]))

    lo, hi = 1, len(vals) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        if probe(float(vals[mid])):
            best = (col_match.copy(), float(vals[mid]))
            lo = mid + 1
        else:
            # restore the best feasible matching as the next warm start
            col_match[:] = best[0]
            row_match.fill(-1)
            for j in range(n):
                if col_match[j] >= 0:
                    row_match[col_match[j]] = j
            # matched weights need recomputing only for correctness of the
            # next drop pass; they equal the weight of (col_match[j], j)
            for j in range(n):
                i = col_match[j]
                if i >= 0:
                    s, e = ptr[j], ptr[j + 1]
                    k = np.flatnonzero(rows_s[s:e] == i)
                    matched_w[j] = w_s[s + k[0]]
            hi = mid - 1
    return best


def symmetric_expand(a) -> sp.csr_matrix:
    """mc34AD-style symmetric expansion (reference/src/hslmc64.c:2680):
    mirror stored entries across the diagonal so a triangular-stored
    symmetric matrix presents its full pattern to the matching engines —
    the reference's WBM adapter requests the symmetrized pattern
    (symmetric=TRUE MatGetRowIJ, reference/src/petsc_mat_wbm.c:29).
    Where both (i,j) and (j,i) are stored, stored values win (no summing).
    """
    c = sp.csr_matrix(a)
    c.eliminate_zeros()
    t = c.T.tocsr()
    pattern = sp.csr_matrix(
        (np.ones_like(c.data), c.indices, c.indptr), shape=c.shape)
    missing = t - t.multiply(pattern)      # transpose entries absent from c
    return (c + missing).tocsr()


# ---------------------------------------------------------------------------
# Min-cost assignment via shortest augmenting paths (MC64 jobs 4/5 engine)
# ---------------------------------------------------------------------------

def sparse_assignment(n: int, col_ptr: np.ndarray, row_ind: np.ndarray,
                      cost: np.ndarray):
    """Sparse linear assignment: minimize sum of cost over a perfect matching.

    Successive shortest augmenting paths with dual variables (u on rows, v on
    columns) and a binary heap — the same algorithmic family as HSLmc64WD
    (reference/src/hslmc64.c:1917) and SciPy's LAPJVsp.

    Returns (match_col2row, u, v, feasible): reduced costs
    cost - u_i - v_j >= 0 everywhere and == 0 on matched entries; this dual
    tightness is what yields the MC64 job-5 scaling vectors.

    Costs must be >= 0 and finite.
    """
    INF = np.inf
    u = np.zeros(n)
    v = np.zeros(n)
    row_match = np.full(n, -1, dtype=np.int64)   # row -> col
    col_match = np.full(n, -1, dtype=np.int64)   # col -> row

    # Column-minimum dual init + greedy tight matching (the "cheap
    # assignment" phase all MC64-family codes start with).
    for j in range(n):
        s, e = col_ptr[j], col_ptr[j + 1]
        if s == e:
            continue
        v[j] = cost[s:e].min()
    for j in range(n):
        s, e = col_ptr[j], col_ptr[j + 1]
        for t in range(s, e):
            i = row_ind[t]
            if col_match[j] < 0 and row_match[i] < 0 and \
                    cost[t] - u[i] - v[j] <= 0.0:
                row_match[i] = j
                col_match[j] = i
                break

    dist = np.empty(n)
    pred_col = np.empty(n, dtype=np.int64)   # row -> column that reached it
    feasible = True

    for j0 in range(n):
        if col_match[j0] >= 0:
            continue
        # Dijkstra from column j0 over rows
        dist.fill(INF)
        finalized_rows = []
        tree_col_of_row = pred_col
        heap = []
        s, e = col_ptr[j0], col_ptr[j0 + 1]
        for t in range(s, e):
            i = row_ind[t]
            rc = cost[t] - u[i] - v[j0]
            if rc < dist[i]:
                dist[i] = rc
                tree_col_of_row[i] = j0
                heapq.heappush(heap, (rc, i))
        done = np.zeros(n, dtype=bool)
        end_row = -1
        D = INF
        while heap:
            d, i = heapq.heappop(heap)
            if done[i] or d > dist[i]:
                continue
            done[i] = True
            finalized_rows.append(i)
            if row_match[i] < 0:
                end_row = i
                D = d
                break
            jm = row_match[i]
            base = d
            s2, e2 = col_ptr[jm], col_ptr[jm + 1]
            for t in range(s2, e2):
                i2 = row_ind[t]
                if done[i2]:
                    continue
                nd = base + cost[t] - u[i2] - v[jm]
                if nd < dist[i2]:
                    dist[i2] = nd
                    tree_col_of_row[i2] = jm
                    heapq.heappush(heap, (nd, i2))
        if end_row < 0:
            feasible = False
            continue
        # dual updates keeping reduced costs >= 0, matched edges tight
        v[j0] += D
        for i in finalized_rows:
            if i == end_row:
                break
            u[i] += dist[i] - D
            v[row_match[i]] += D - dist[i]
        # augment along the alternating path
        i = end_row
        while True:
            j = tree_col_of_row[i]
            prev = col_match[j]
            col_match[j] = i
            row_match[i] = j
            if j == j0:
                break
            i = prev

    return col_match, u, v, feasible

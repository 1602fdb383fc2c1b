"""Fiedler-vector spectral ordering (MC73 replacement).

The reference calls the proprietary HSL MC73 (multilevel Fiedler,
reference/src/hslmc73f.F90 + external libhsl_mc73) through a PETSc
adapter that inverts the returned permutation and prints profile/bandwidth
before/after (reference/src/petsc_mat_fiedler.c:11-58).  This module
replaces it with open algorithms:

* graph Laplacian with drop tolerance (MatLaplacian re-design,
  reference/src/spectralPartition.c:63-139),
* Fiedler vector by dense eigendecomposition (small n), SciPy Lanczos, or
  multilevel coarsening with LOBPCG refinement on the host (SciPy) or on
  the device (``refine="device"``), or LOBPCG on the device
  (``method="lobpcg"``: ``ordering/lobpcg.py`` on torch sparse products;
  the card unless ``device`` names another),
* ordering = argsort of the Fiedler vector,
* profile/bandwidth in -> out reporting, matching the MC73 wrapper's
  diagnostics (reference/src/hslmc73f.F90:33-36).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..utils.registry import register_ordering
from .base import OrderingResult


def graph_laplacian(a, tol: float = 1e-12, weighted: bool = False) -> sp.csr_matrix:
    """Graph Laplacian of the symmetrized pattern of ``a``.

    Entries with |a_ij| <= tol are dropped (the reference's drop-tolerance
    argument, reference/src/spectralPartition.c:63).  Unweighted: L has
    -1 off-diagonals and degree diagonal; weighted: -(|a_ij|+|a_ji|)/2.
    Row sums are exactly zero (the invariant the reference asserts,
    reference/src/spectralPartition.c:264-272).
    """
    csr = sp.csr_matrix(a)
    coo = csr.tocoo()
    keep = (np.abs(coo.data) > tol) & (coo.row != coo.col)
    w = np.abs(coo.data[keep]) if weighted else np.ones(keep.sum())
    g = sp.csr_matrix((w, (coo.row[keep], coo.col[keep])), shape=csr.shape)
    g = (g + g.T) * 0.5
    g.sum_duplicates()
    deg = np.asarray(g.sum(axis=1)).ravel()
    return (sp.diags(deg) - g).tocsr()


def heavy_edge_coarsen(adj: sp.csr_matrix) -> Tuple[sp.csr_matrix, np.ndarray]:
    """One level of vectorized heavy-edge matching coarsening.

    Mutual-heaviest-neighbor matching (two passes), singletons kept — the
    standard multilevel building block MC73 uses internally (the reference
    links hsl_mc73's multilevel Fiedler routine, reference/src/
    hslmc73f.F90:16 coarsest_size).  Returns (coarse_adj, parent[n]).
    """
    n = adj.shape[0]
    adj = adj.tocsr()
    indptr, indices, data = adj.indptr, adj.indices, np.abs(adj.data)
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    matched = np.full(n, -1, dtype=np.int64)
    NEG = -np.inf

    # symmetric pseudo-random tie-break: on equal-weight graphs (e.g.
    # unweighted grids) a deterministic "first max neighbour" almost never
    # yields mutual pairs and coarsening stalls; a per-undirected-edge jitter
    # makes both endpoints agree on which incident edge is "heaviest"
    lo = np.minimum(row_of, indices).astype(np.uint64)
    hi = np.maximum(row_of, indices).astype(np.uint64)
    key = (lo * np.uint64(2654435761) ^ hi * np.uint64(40503)) \
        % np.uint64(1 << 20)
    scale = data.max() if data.size else 1.0
    data = data + (0.01 * scale / float(1 << 20)) * key.astype(np.float64)

    for _ in range(4):   # mutual-heaviest passes (vectorized)
        if (matched >= 0).all():
            break
        # mask edges whose endpoint (either side) is already matched
        w = np.where((matched[row_of] < 0) & (matched[indices] < 0),
                     data, NEG)
        # per-row max weight (empty rows -> NEG)
        rowmax = np.full(n, NEG)
        np.maximum.at(rowmax, row_of, w)
        # first edge achieving the row max -> heaviest free neighbor
        hit = w >= rowmax[row_of]
        hit &= np.isfinite(w)
        eidx = np.where(hit, np.arange(len(w)), len(w))
        first = np.full(n, len(w), dtype=np.int64)
        np.minimum.at(first, row_of, eidx)
        has = first < len(w)
        best = np.full(n, -1, dtype=np.int64)
        best[has] = indices[first[has]]
        # mutual agreement
        ok = best >= 0
        mutual = ok & (best[np.clip(best, 0, n - 1)] == np.arange(n)) & \
            (np.arange(n) < best)
        vs = np.flatnonzero(mutual)
        if vs.size == 0:
            break
        matched[vs] = best[vs]
        matched[best[vs]] = vs

    # parents (vectorized): roots = singletons + the smaller of each pair
    is_root = (matched < 0) | (np.arange(n) < matched)
    ids = np.cumsum(is_root) - 1
    parent = np.where(is_root, ids,
                      ids[np.clip(matched, 0, n - 1)]).astype(np.int64)
    nc = int(is_root.sum())
    s = sp.csr_matrix((np.ones(n), (np.arange(n), parent)), shape=(n, nc))
    coarse = (s.T @ adj @ s).tocsr()
    coarse.setdiag(0)
    coarse.eliminate_zeros()
    return coarse, parent


def _fiedler_multilevel(lap: sp.csr_matrix, tol: float, seed: int,
                        coarsest: int = 64,
                        refine_iters: int = 40,
                        refine: str = "auto",
                        device=None) -> Tuple[np.ndarray, float]:
    """Multilevel Fiedler: heavy-edge coarsening, exact coarsest solve,
    prolong + LOBPCG refinement per level (the MC73 job-3 scheme rebuilt
    from the multilevel-spectral literature).

    ``refine``: "host" (SciPy LOBPCG, the default) or "auto" (= host);
    "device": ``ordering/lobpcg.py`` on ``device`` (default the card) at
    every level of at least 4 nodes.  Coarsening stays host-side by
    design: it is a
    combinatorial matching, the numerics are the per-level eigensolves."""
    if refine == "auto":
        refine = "host"
    refiner = (partial(_refine_lobpcg_device, device=device)
               if refine == "device" else _refine_lobpcg)
    # adjacency from the Laplacian: off-diagonal magnitudes
    adj = -lap.copy()
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj.data = np.abs(adj.data)

    adjs, parents = [adj], []
    while adjs[-1].shape[0] > coarsest and len(adjs) < 60:
        coarse, parent = heavy_edge_coarsen(adjs[-1])
        if coarse.shape[0] >= 0.95 * adjs[-1].shape[0]:   # stalled
            break
        parents.append(parent)
        adjs.append(coarse)

    # coarsest-level solve.  Coarsening can STALL well above ``coarsest``
    # (mutual-heaviest matching finds <5% pairs on some weight patterns);
    # a dense eigh there is O(n^3) — measured 19.6 s of a 30 s multilevel
    # run at a ~5k-node stalled coarsest level.  Route by size exactly
    # like fiedler_vector's "auto": dense only when truly small, else
    # shift-invert Lanczos on the sparse Laplacian (<1 s at 5k nodes).
    lap_c = _lap_of(adjs[-1])
    nc = lap_c.shape[0]
    if nc <= 1:
        vec = np.zeros(nc)
    elif nc <= 512:
        evals, evecs = np.linalg.eigh(lap_c.toarray())
        vec = evecs[:, 1]
    else:
        vec, _ = fiedler_vector(lap_c, method="lanczos", tol=tol, seed=seed)

    # prolong + refine back up
    for level in range(len(parents) - 1, -1, -1):
        vec = vec[parents[level]]
        lap_l = _lap_of(adjs[level])
        vec = refiner(lap_l, vec, tol=tol, maxiter=refine_iters)
    lap0 = _lap_of(adjs[0])
    lam2 = float(vec @ (lap0 @ vec) / max(vec @ vec, 1e-300))
    return vec, lam2


def _lap_of(adj: sp.csr_matrix) -> sp.csr_matrix:
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return (sp.diags(deg) - adj).tocsr()


def _refine_lobpcg(lap: sp.csr_matrix, x0: np.ndarray, tol: float,
                   maxiter: int) -> np.ndarray:
    n = lap.shape[0]
    x0 = x0 - x0.mean()
    nrm = np.linalg.norm(x0)
    if nrm < 1e-12:
        x0 = np.random.default_rng(0).standard_normal(n)
        x0 -= x0.mean()
        nrm = np.linalg.norm(x0)
    x0 = (x0 / nrm).reshape(-1, 1)
    ones = np.ones((n, 1)) / np.sqrt(n)
    try:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vals, vecs = spla.lobpcg(lap.asfptype(), x0, Y=ones,
                                     tol=tol, maxiter=maxiter, largest=False)
        return vecs[:, 0]
    except Exception:
        return x0[:, 0]


def _gershgorin(lap: sp.csr_matrix) -> float:
    """An upper bound of the Laplacian's spectrum, for the flip."""
    return float(2.0 * np.abs(lap).sum(axis=1).max())


def _laplacian_operator(lap: sp.csr_matrix, c: float, device):
    """The deflated, spectrum-flipped ``c x - L x`` on ``device``, the
    Laplacian a ``torch.sparse_csr_tensor`` in its own dtype and the
    product the torch sparse one; its top eigenvector is L's Fiedler
    vector (JAX ``fiedler.py:303-307``)."""
    import torch
    csr = lap.tocsr()
    L = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64),
        torch.as_tensor(csr.indices, dtype=torch.int64),
        torch.as_tensor(csr.data), size=csr.shape).to(device)

    def op(x):
        # (c I - L) with the constant vector deflated
        x = x - x.mean(dim=0, keepdim=True)
        y = c * x - L @ x
        return y - y.mean(dim=0, keepdim=True)
    return op


def _refine_lobpcg_device(lap: sp.csr_matrix, x0: np.ndarray, tol: float,
                          maxiter: int, device=None) -> np.ndarray:
    """Warm-started LOBPCG refinement of a prolonged Fiedler guess on the
    device (the card unless ``device`` names another): the top eigenvector
    of the deflated c I - L by ``ordering.lobpcg`` on torch sparse
    products (JAX ``fiedler.py:209-242``; tiny levels on the host, as
    JAX)."""
    import torch
    from .lobpcg import lobpcg_standard

    n = lap.shape[0]
    if n < 4:  # lobpcg needs a few dofs; tiny levels are free on host
        return _refine_lobpcg(lap, x0, tol, maxiter)
    device = torch.device(device or "cuda")
    op = _laplacian_operator(lap, _gershgorin(lap) or 1.0, device)
    x0 = x0 - x0.mean()
    nrm = np.linalg.norm(x0)
    if nrm < 1e-12:
        x0 = np.random.default_rng(0).standard_normal(n)
        x0 -= x0.mean()
        nrm = np.linalg.norm(x0)
    X = torch.as_tensor((x0 / nrm).reshape(-1, 1)).to(device)
    _, u, _ = lobpcg_standard(op, X, m=maxiter, tol=tol)
    return u[:, 0].cpu().numpy()


def fiedler_vector(lap: sp.csr_matrix, method: str = "auto",
                   tol: float = 1e-8, seed: int = 0,
                   maxiter: Optional[int] = None,
                   refine: str = "auto",
                   device=None) -> Tuple[np.ndarray, float]:
    """Second-smallest eigenpair of the Laplacian. Returns (vector, lambda2).
    ``device`` (default the card) is where ``method="lobpcg"`` and
    ``refine="device"`` run."""
    n = lap.shape[0]
    if method == "auto":
        method = "dense" if n <= 512 else \
            ("lanczos" if n <= 20000 else "multilevel")

    if method == "multilevel":
        return _fiedler_multilevel(lap, tol=tol, seed=seed, refine=refine,
                                   device=device)

    if method == "dense":
        evals, evecs = np.linalg.eigh(lap.toarray())
        # lambda0 ~ 0 with constant eigenvector — the invariant the reference
        # asserts (reference/src/spectralPartition.c:314-319)
        return evecs[:, 1], float(evals[1])

    if method == "lanczos":
        k = min(3, n - 1)
        # shift-invert with a small negative sigma: L itself is exactly
        # singular (constant null vector), L - sigma*I is SPD
        scale = float(lap.diagonal().mean()) or 1.0
        evals, evecs = spla.eigsh(lap.asfptype(), k=k, sigma=-1e-2 * scale,
                                  which="LM", tol=tol, maxiter=maxiter)
        order = np.argsort(evals)
        return evecs[:, order[1]], float(evals[order[1]])

    if method == "lobpcg":
        return _fiedler_lobpcg_jax(lap, tol=tol, seed=seed,
                                   maxiter=maxiter or 200, device=device)

    raise ValueError(f"unknown fiedler method {method!r}")


def _fiedler_lobpcg_jax(lap: sp.csr_matrix, tol: float, seed: int,
                        maxiter: int, device=None
                        ) -> Tuple[np.ndarray, float]:
    """LOBPCG on the deflated, spectrum-flipped operator, on the device
    (the card unless ``device`` names another): (c I - L) restricted to the
    complement of the constant vector, whose top eigenvector is L's Fiedler
    vector (``-mat_ordering_fiedler_method lobpcg``; JAX
    ``fiedler.py:281-315``).  The seeded start is numpy's, as JAX's.  The
    ``FiedlerLOBPCG`` stage times it (device synchronized), and a
    ``fiedler_lobpcg`` event records its iterations."""
    import torch
    from ..utils.profiling import log_event, scope
    from .lobpcg import lobpcg_standard

    n = lap.shape[0]
    device = torch.device(device or "cuda")
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, 1))
    x0 = x0 - x0.mean()
    with scope("FiedlerLOBPCG"):
        c = _gershgorin(lap)
        op = _laplacian_operator(lap, c, device)
        X = torch.as_tensor(x0).to(device)
        theta, u, iters = lobpcg_standard(op, X, m=maxiter, tol=tol)
        lam2 = c - float(theta[0])
        vec = u[:, 0].cpu().numpy()
    log_event("fiedler_lobpcg", n=n, iterations=iters, lambda2=lam2,
              device=str(device))
    return vec, lam2


def fiedler(a, tol: float = 1e-12, weighted: bool = False,
            method: str = "auto", refine: str = "auto", device=None,
            eig_tol: float = 1e-8,
            eig_maxiter: Optional[int] = None) -> OrderingResult:
    """The Fiedler ordering of ``a`` (``tol``: the Laplacian's drop
    tolerance).  ``eig_tol`` and ``eig_maxiter`` are ``fiedler_vector``'s
    ``tol`` and ``maxiter``, at the JAX package's defaults unless given
    (``-mat_ordering_fiedler_tol``, ``-mat_ordering_fiedler_max_it``)."""
    from .. import sparse as hsp

    csr = sp.csr_matrix(a)
    lap = graph_laplacian(csr, tol=tol, weighted=weighted)
    vec, lam2 = fiedler_vector(lap, method=method, tol=eig_tol,
                               maxiter=eig_maxiter, refine=refine,
                               device=device)
    perm = np.argsort(vec, kind="stable").astype(np.int64)

    res = OrderingResult(rperm=perm, cperm=perm.copy(),
                         info=dict(type="fiedler", lambda2=lam2))
    # MC73-style diagnostics: profile/bandwidth in -> out
    pa = res.apply(csr)
    res.info.update(
        profile_in=hsp.matrix_profile(csr), profile_out=hsp.matrix_profile(pa),
        bandwidth_in=hsp.compute_bandwidth(csr),
        bandwidth_out=hsp.compute_bandwidth(pa))
    return res


@register_ordering("fiedler")
def ordering_fiedler(a, options=None) -> OrderingResult:
    weighted = bool(options.get_bool("mat_ordering_fiedler_weighted", False)) \
        if options is not None else False
    method = options.get_string("mat_ordering_fiedler_method", "auto") \
        if options is not None else "auto"
    refine = options.get_string("mat_ordering_fiedler_refine", "auto") \
        if options is not None else "auto"
    # the eigensolver's tolerance and iteration limit (JAX's defaults
    # unless given): LOBPCG's test is |r| < tol * 10 * n * (theta + |A v|),
    # loose at large n with JAX's tol (PERF.md, config 4)
    eig_tol = options.get_real("mat_ordering_fiedler_tol", 1e-8) \
        if options is not None else 1e-8
    eig_maxiter = options.get_int("mat_ordering_fiedler_max_it", None) \
        if options is not None else None
    # the device parts run where the testbed runs: the card unless
    # -platform cpu
    device = "cpu" if options is not None and \
        options.get_string("platform", "cuda") == "cpu" else None
    return fiedler(a, weighted=weighted, method=method, refine=refine,
                   device=device, eig_tol=eig_tol, eig_maxiter=eig_maxiter)

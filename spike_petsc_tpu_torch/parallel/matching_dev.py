"""Device-parallel weighted bipartite matching (the auction algorithm).

The port of the JAX package's ``parallel/matching_dev.py``, on one device
(``auction_match``) and over a mesh axis (``auction_match_dist``, the
columns sharded over the axis).  On one device:
the matrix as padded ELL arrays [n, dmax] on the device, then rounds of
all-column bidding (a row-wise argmax and two segment reductions,
``scatter_reduce`` "amax" and "amin"), row acceptance by the highest raise
with ties to the lowest column index, and the leftovers completed
deterministically on the host.  The epsilon-scaled auction ends within
n * eps of the optimal log-product weight, MC64 job 5's objective; the row
and column scalings come from the final prices on the host.

The rounds run in a host loop that checks the exit condition every
``CHECK_EVERY`` rounds (one device sync each): a round that finds every
column matched changes nothing, so the extra rounds are no-ops, and the
count of rounds that began with a column unmatched is JAX's ``rounds``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ordering.base import OrderingResult

# rounds between two host reads of the exit condition
CHECK_EVERY = 16


def csc_to_ell(a) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad CSC columns to uniform depth: rows[n, dmax] (n = invalid),
    logw[n, dmax] (+inf = invalid), where logw = log(colmax/|a|) >= 0.
    JAX's column loop, vectorized over the entries (the same arrays)."""
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    n = csc.shape[0]
    counts = np.diff(csc.indptr)
    dmax = max(int(counts.max()), 1) if n else 1
    rows = np.full((n, dmax), n, dtype=np.int32)
    logw = np.full((n, dmax), np.inf)
    absval = np.abs(csc.data.astype(np.float64))
    keep = absval > 0
    col = np.repeat(np.arange(n), counts)[keep]
    val = absval[keep]
    kept = np.bincount(col, minlength=n)
    start = np.cumsum(kept) - kept
    pos = np.arange(col.size) - start[col]
    colmax = np.zeros(n)
    has = kept > 0
    if col.size:
        colmax[has] = np.maximum.reduceat(val, start[has])
    rows[col, pos] = csc.indices[keep]
    logw[col, pos] = np.log(colmax[col] / val)
    return rows, logw, n


def _auction_round(rows, benefit, state, eps: float):
    """One bidding round of JAX's ``_auction_rounds`` body, in place on
    ``state`` = (match, matchR, p, active): ``active`` counts the rounds
    that began with a column unmatched (the JAX loop's condition)."""
    match, matchR, p, active = state
    n = rows.shape[0]
    dev = rows.device
    ar = torch.arange(n, device=dev)
    neg = torch.tensor(-torch.inf, dtype=benefit.dtype, device=dev)
    unmatched = match < 0
    active += unmatched.any()
    # bidding: every unmatched column evaluates value = benefit - price
    pr = torch.cat([p, p.new_zeros(1)])                    # pad row n
    vals = torch.where(unmatched[:, None], benefit - pr[rows], neg)
    best_e = torch.argmax(vals, dim=1)
    best = vals.gather(1, best_e[:, None])[:, 0]
    vals[ar, best_e] = neg
    second = vals.amax(dim=1)
    has_bid = unmatched & torch.isfinite(best)
    target = torch.where(has_bid, rows[ar, best_e], n)
    raise_amt = torch.where(torch.isfinite(second), best - second,
                            torch.zeros_like(best)) + eps

    # acceptance: per target row, the highest raise wins (ties -> lowest
    # column index): a segment max, then a masked segment min
    bid_key = torch.where(has_bid, raise_amt, neg)
    row_best = torch.full((n + 1,), -torch.inf, dtype=benefit.dtype,
                          device=dev).scatter_reduce(0, target, bid_key,
                                                     "amax")
    is_top = has_bid & (bid_key >= row_best[target] - 0.0)
    col_ids = torch.where(is_top, ar, n)
    row_winner = torch.full((n + 1,), torch.iinfo(torch.int64).max,
                            device=dev).scatter_reduce(
                                0, target, col_ids, "amin")[:n]
    tgt_c = target.clamp(0, n - 1)
    accepted = has_bid & (row_winner[tgt_c] == ar) & (target < n)

    # evict previous owners of rows that changed hands; no-op writes go to
    # the dummy slot n, so they never collide with real evictions
    old_owner = torch.where(accepted, matchR[tgt_c], n)
    evict_idx = torch.where((old_owner >= 0) & (old_owner < n), old_owner, n)
    match_pad = torch.cat([match, match.new_full((1,), -1)])
    match_pad[evict_idx] = -1
    # assign: accepted columns take their rows
    match.copy_(torch.where(accepted, tgt_c, match_pad[:n]))
    write_row = torch.where(accepted, tgt_c, n)
    matchR_pad = torch.cat([matchR, matchR.new_full((1,), -1)])
    matchR_pad[write_row] = ar
    matchR.copy_(matchR_pad[:n])
    p_pad = torch.cat([p, p.new_zeros(1)])
    p_pad.index_add_(0, write_row,
                     torch.where(accepted, raise_amt, torch.zeros_like(p)))
    p.copy_(p_pad[:n])


def _auction_rounds(rows, benefit, n: int, eps: float, max_rounds: int):
    """The parallel auction on ``rows``' device: (match[n], matchR[n],
    prices[n], rounds), rounds as JAX counts them.  The host reads the
    exit condition every ``CHECK_EVERY`` rounds and never runs more than
    ``max_rounds``."""
    dev = rows.device
    match = torch.full((n,), -1, dtype=torch.int64, device=dev)
    matchR = torch.full((n,), -1, dtype=torch.int64, device=dev)
    p = torch.zeros(n, dtype=benefit.dtype, device=dev)
    active = torch.zeros((), dtype=torch.int64, device=dev)
    state = (match, matchR, p, active)
    ran = 0
    while ran < max_rounds and bool((match < 0).any()):
        for _ in range(min(CHECK_EVERY, max_rounds - ran)):
            _auction_round(rows, benefit, state, eps)
        ran += min(CHECK_EVERY, max_rounds - ran)
    return match, matchR, p, int(active)


def _scalings_from_prices(a, rows_np, logw_np, p, n):
    """Shared dual->scaling derivation (see auction_match)."""
    logw_flat = logw_np.ravel()
    rows_flat = rows_np.ravel()
    finite = np.isfinite(logw_flat) & (rows_flat < n)
    q = np.full(n, -np.inf)
    col_flat = np.repeat(np.arange(n), rows_np.shape[1])
    np.maximum.at(q, col_flat[finite],
                  -logw_flat[finite] - p[rows_flat[finite]])
    q[~np.isfinite(q)] = 0.0
    coo = sp.csc_matrix(a).tocoo()
    colmax = np.zeros(n)
    np.maximum.at(colmax, coo.col, np.abs(coo.data))
    logmax = np.zeros(n)
    np.log(colmax, out=logmax, where=colmax > 0)
    row_scale = np.exp(np.clip(-p, -700, 700))
    col_scale = np.exp(np.clip(-q - logmax, -700, 700))
    return row_scale, col_scale


def auction_match(a, eps: Optional[float] = None,
                  max_rounds: Optional[int] = None,
                  device=None) -> OrderingResult:
    """MC64-job-5-objective matching computed on the device (the card
    unless ``device`` names another; JAX ``parallel/matching_dev.py:
    252-313``).

    eps trades optimality for rounds (the result is within n * eps of the
    optimal log-product).  The scalings come from the final prices, which
    play the role of the column duals.  ``info`` holds ``rounds`` (JAX's
    count), ``eps`` and, where the round budget ran out, ``completed``."""
    rows_np, logw_np, n = csc_to_ell(a)
    if n == 0:
        return OrderingResult(rperm=np.arange(0), cperm=np.arange(0))
    eps = eps if eps is not None else 1e-3 / max(n, 1)
    max_rounds = max_rounds or 50 * n
    device = torch.device(device or "cuda")

    rows = torch.as_tensor(rows_np.astype(np.int64)).to(device)
    benefit = torch.as_tensor(-np.where(np.isfinite(logw_np), logw_np,
                                        np.inf)).to(device)
    benefit = torch.where(torch.isfinite(benefit), benefit,
                          torch.tensor(-torch.inf, dtype=benefit.dtype,
                                       device=device))

    match, _, prices, rounds = _auction_rounds(
        rows, benefit, n=n, eps=eps, max_rounds=max_rounds)
    match = match.cpu().numpy()
    info = dict(type="auction", rounds=rounds, eps=float(eps))

    # deterministic completion (structurally singular / round budget)
    unmatched = np.flatnonzero(match < 0)
    if unmatched.size:
        used = np.zeros(n, dtype=bool)
        used[match[match >= 0]] = True
        free = np.flatnonzero(~used)
        match[unmatched] = free[: unmatched.size]
        info["completed"] = int(unmatched.size)

    # duals from prices (eps-complementary slackness of the auction): rows
    # carry prices p_i; column values q_j = max_e (-w_je - p_{row(je)});
    # u_i = -p_i, v_j = -q_j satisfy u + v <= w (equality on matched,
    # within eps), the tightness MC64 job 5 uses for its scalings
    row_scale, col_scale = _scalings_from_prices(
        a, rows_np, logw_np, prices.double().cpu().numpy(), n)
    return OrderingResult(rperm=match, cperm=np.arange(n),
                          row_scale=row_scale, col_scale=col_scale,
                          info=info)


def _auction_round_dist(rows_l, ben_l, gcol, state, eps: float, n: int,
                        ax):
    """One bidding round of JAX's ``_auction_rounds_dist`` body on this
    rank's columns, in place on ``state`` = (match_l, matchR, p, active):
    the row owners ``matchR`` and the prices ``p`` are replicated and
    updated identically on every rank from two ``all_reduce``s (the best
    raise a row, ``max``; the winning global column id, ``min``)."""
    match_l, matchR, p, active = state
    nl = rows_l.shape[0]
    dev = rows_l.device
    ar = torch.arange(nl, device=dev)
    neg = torch.tensor(-torch.inf, dtype=ben_l.dtype, device=dev)
    unmatched = match_l < 0
    active += ax.all_reduce(unmatched.sum()[None])[0] > 0
    pr = torch.cat([p, p.new_zeros(1)])                    # pad row n
    vals = torch.where(unmatched[:, None], ben_l - pr[rows_l], neg)
    best_e = torch.argmax(vals, dim=1)
    best = vals.gather(1, best_e[:, None])[:, 0]
    vals[ar, best_e] = neg
    second = vals.amax(dim=1)
    has_bid = unmatched & torch.isfinite(best)
    target = torch.where(has_bid, rows_l[ar, best_e], n)
    raise_amt = torch.where(torch.isfinite(second), best - second,
                            torch.zeros_like(best)) + eps

    # global acceptance: per row the highest raise over every rank, ties
    # to the lowest global column id; the dummy slot n takes no-bids
    bid_key = torch.where(has_bid, raise_amt, neg)
    row_best = torch.full((n + 1,), -torch.inf, dtype=ben_l.dtype,
                          device=dev).scatter_reduce(0, target, bid_key,
                                                     "amax")
    row_best = ax.all_reduce(row_best, "max")
    is_top = has_bid & (bid_key >= row_best[target])
    cand = torch.where(is_top, gcol, n)
    winner = torch.full((n + 1,), n, dtype=cand.dtype,
                        device=dev).scatter_reduce(0, target, cand, "amin")
    winner = ax.all_reduce(winner, "min")[:n]

    # the replicated row state, identical on every rank
    accepted_row = (winner < n) & torch.isfinite(row_best[:n])
    matchR.copy_(torch.where(accepted_row, winner, matchR))
    p.add_(torch.where(accepted_row, row_best[:n], torch.zeros_like(p)))

    # this rank's columns: a win where it is its target's winner; an
    # eviction where the row's owner is no longer this column
    tgt_c = target.clamp(0, n - 1)
    i_won = has_bid & (target < n) & (winner[tgt_c] == gcol)
    match_l.copy_(torch.where(i_won, tgt_c, match_l))
    owned = match_l >= 0
    still_mine = owned & (matchR[match_l.clamp(0, n - 1)] == gcol)
    match_l.copy_(torch.where(owned & ~still_mine,
                              torch.full_like(match_l, -1), match_l))


def _auction_rounds_dist(rows_l, ben_l, n: int, eps: float,
                         max_rounds: int, ax):
    """The mesh auction on this rank's ``[nl, dmax]`` columns: (match_l,
    matchR[n], prices[n], rounds), rounds as JAX counts them (the rounds
    that began with a column unmatched on any rank, padded columns
    included).  The exit condition is read every ``CHECK_EVERY`` rounds
    from an ``all_reduce``d count, so every rank stops together; the
    rounds run after every column is matched change nothing."""
    dev = rows_l.device
    nl = rows_l.shape[0]
    gcol = ax.rank * nl + torch.arange(nl, device=dev)
    match_l = torch.full((nl,), -1, dtype=torch.int64, device=dev)
    matchR = torch.full((n,), -1, dtype=torch.int64, device=dev)
    p = torch.zeros(n, dtype=ben_l.dtype, device=dev)
    active = torch.zeros((), dtype=torch.int64, device=dev)
    state = (match_l, matchR, p, active)
    ran = 0
    while ran < max_rounds and int(ax.all_reduce(
            (match_l < 0).sum()[None])[0]) > 0:
        for _ in range(min(CHECK_EVERY, max_rounds - ran)):
            _auction_round_dist(rows_l, ben_l, gcol, state, eps, n, ax)
        ran += min(CHECK_EVERY, max_rounds - ran)
    return match_l, matchR, p, int(active)


def auction_match_dist(a, mesh, axis: str = "p", eps: Optional[float] = None,
                       max_rounds: Optional[int] = None) -> OrderingResult:
    """MC64-job-5-objective matching over a mesh axis (JAX
    ``parallel/matching_dev.py:132-250``): the columns sharded over
    ``axis`` (padded to a multiple of its size with columns that cannot
    bid), the row owners and prices replicated.  Every rank passes the
    same matrix and gets the same result; ``info`` holds ``rounds``
    (JAX's count), ``eps``, ``devices`` and, where the round budget ran
    out, ``completed``."""
    ax = mesh.axis(axis)
    rows_np, logw_np, n = csc_to_ell(a)
    ndev = ax.size
    eps = eps if eps is not None else 1e-3 / max(n, 1)
    max_rounds = max_rounds or 50 * n
    n_pad = -(-max(n, 1) // ndev) * ndev
    dmax = rows_np.shape[1] if n else 1
    rows_pad = np.full((n_pad, dmax), n, dtype=np.int64)
    ben_pad = np.full((n_pad, dmax), -np.inf)
    if n:
        rows_pad[:n] = rows_np
        ben_pad[:n] = np.where(np.isfinite(logw_np), -logw_np, -np.inf)
    nl = n_pad // ndev
    mine = slice(ax.rank * nl, (ax.rank + 1) * nl)
    match_l, _, prices, rounds = _auction_rounds_dist(
        torch.as_tensor(rows_pad[mine]).to(ax.device),
        torch.as_tensor(ben_pad[mine]).to(ax.device), n=n, eps=eps,
        max_rounds=max_rounds, ax=ax)
    match = ax.all_gather(match_l).reshape(-1)[:n].cpu().numpy()
    info = dict(type="auction_dist", rounds=rounds, eps=float(eps),
                devices=ndev)
    unmatched = np.flatnonzero(match < 0)
    if unmatched.size:
        used = np.zeros(n, dtype=bool)
        used[match[match >= 0]] = True
        free = np.flatnonzero(~used)
        match[unmatched] = free[: unmatched.size]
        info["completed"] = int(unmatched.size)
    row_scale, col_scale = _scalings_from_prices(
        a, rows_np, logw_np, prices.double().cpu().numpy(), n)
    return OrderingResult(rperm=match, cperm=np.arange(n),
                          row_scale=row_scale, col_scale=col_scale,
                          info=info)

"""Batched multi-RHS Krylov engines (PyTorch): one iteration loop for all
columns of B ``[n, r]``.

The port of ``spike_petsc_tpu.solvers.krylov_many``.  Every matvec and
PCApply is one call on the ``[n, r]`` block (the spike PC streams its
factors once for all columns), and the per-column inner products of a step
are ``[r]`` reductions.  Convergence is per column: a column whose reason is
terminal keeps its state (the JAX ``_freeze_cols``), while the whole block
still goes through matvec and PC until every column is terminal.

The JAX engines run in ``lax.while_loop``.  Here the vectors and the
per-column scalars stay on the operator's device, and the per-column norms
come to the host once per decision point (BiCGStab: after the s-norm and
after the full step; the other engines: once per iteration), where the
convergence tests, the iteration counts and the history are kept; each read
is one ``KSPHostSync`` span (``_host``; ``preonly_many``'s are not).
Results are column-batched ``KSPResult``s (see ``types.KSPResult``).

On a mesh every engine takes ``axis_name`` (a ``parallel.mesh.MeshAxis``;
its rank's row block of the columns): each JAX ``psum`` of ``[r]`` or
stacked ``[k, r]`` column sums is one ``all_reduce`` (``_cdots``).
``conv_sync_axis`` (the replica axis) keeps JAX's meaning: the loop runs
while any column of any replica iterates (stopped columns stay frozen, the
loop-global trip count advances), and bicgstab's half-step exit and
gmres's DGKS refinement are taken replica-wide, one ``all_reduce`` each.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..utils.profiling import span
from .krylov import DGKS_THRESHOLD, _Sync
from .types import (CONVERGED_ITERATING, CONVERGED_ITS, DIVERGED_BREAKDOWN,
                    DIVERGED_NANORINF, KSPResult, default_convergence_check)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _identity_pc(x):
    return x


def _cdot(a: torch.Tensor, b: torch.Tensor, axis=None) -> torch.Tensor:
    """Per-column inner products <a_j, b_j> = a_j^H b_j: [n, r] x [n, r]
    -> [r], summed over the mesh axis ``axis`` (one ``all_reduce``)."""
    d = (a.conj() * b).sum(dim=0)
    return d if axis is None else axis.all_reduce(d)


def _cdots(pairs, axis=None) -> tuple:
    """Several per-column inner products, one stacked ``[k, r]``
    ``all_reduce`` on a mesh (JAX ``krylov_many.py:51-57``)."""
    d = [(a.conj() * b).sum(dim=0) for a, b in pairs]
    if axis is None:
        return tuple(d)
    s = axis.all_reduce(torch.stack(d))
    return tuple(s[i] for i in range(len(pairs)))


def _cnorm(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Per-column norms, real for complex x."""
    return torch.sqrt(_cdot(x, x, axis).real)


def _sync(conv_sync_axis) -> Optional[_Sync]:
    return None if conv_sync_axis is None else _Sync(conv_sync_axis)


def _host(t: torch.Tensor) -> np.ndarray:
    """Bring a small device tensor to the host (one synchronization, one
    ``KSPHostSync`` span)."""
    with span("KSPHostSync"):
        return t.detach().cpu().numpy()


class _Columns:
    """Host-side per-column bookkeeping shared by the engines: the reasons,
    iteration counts and residual history, and the per-column freeze."""

    def __init__(self, rnorm0: np.ndarray, bnorm: np.ndarray, maxit: int,
                 dtype: torch.dtype, *, rtol, atol, divtol):
        self.bnorm = bnorm
        self.tols = dict(rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
        r = rnorm0.shape[0]
        self.history = torch.full((maxit + 1, r), float("nan"),
                                  dtype=dtype.to_real())
        self.history[0] = torch.from_numpy(rnorm0)
        self.its = np.zeros(r, np.int32)
        self.reason = self.check(rnorm0, 0)
        self.trip = 0                      # loop-global iteration count

    def check(self, rn: np.ndarray, its: int) -> np.ndarray:
        return np.array([default_convergence_check(
            rn[j], self.bnorm[j], its, **self.tols)
            for j in range(rn.shape[0])], np.int32)

    def iterating(self, sync: Optional[_Sync] = None) -> bool:
        """Some column iterates (on some replica, under ``sync``)."""
        it = bool((self.reason == CONVERGED_ITERATING).any())
        return it if sync is None else sync.any(it)

    def active(self) -> np.ndarray:
        return self.reason == CONVERGED_ITERATING

    def record(self, active: np.ndarray, rn: np.ndarray,
               reason: np.ndarray) -> None:
        """One iteration of the active columns: history row ``trip + 1``,
        its + 1, the new reason; terminal columns keep theirs."""
        self.trip += 1
        idx = torch.from_numpy(np.flatnonzero(active))
        self.history[self.trip, idx] = torch.from_numpy(rn[active]).to(
            self.history.dtype)
        self.its[active] += 1
        self.reason = np.where(active, reason, self.reason).astype(np.int32)

    def result(self, X: torch.Tensor, rnorm: torch.Tensor) -> KSPResult:
        return KSPResult(x=X, its=torch.from_numpy(self.its),
                         reason=torch.from_numpy(self.reason),
                         rnorm=torch.from_numpy(_host(rnorm)),
                         history=self.history)


def _merge(active: np.ndarray, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """Per-column merge (the column axis last): terminal columns keep
    ``old``."""
    if active.all():
        return new
    return torch.where(torch.from_numpy(active).to(new.device), new, old)


def _freeze(active: np.ndarray, new: dict, old: dict) -> dict:
    return {k: _merge(active, new[k], old[k]) for k in new}


def bicgstab_many(matvec: Callable, B: torch.Tensor,
                  X0: Optional[torch.Tensor] = None,
                  pc_apply: Optional[Callable] = None, *,
                  rtol: float = 1e-5, atol: float = 1e-50,
                  divtol: float = 1e4, maxit: int = 10000,
                  axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched preconditioned BiCGStab; B: [n, r].

    Each column runs the one-RHS ``bicgstab`` recurrence (its own initial
    residual as shadow vector).  The half-step ("s-norm") exit: when every
    active column already passes the convergence test on s = r - alpha v,
    the iteration stops there (x += alpha p_hat) and skips the second PC
    apply and matvec; otherwise the full step runs and per-column freezing
    applies.  PETSc's KSPSolve_BCGS performs the same s-norm exit."""
    psolve = pc_apply or _identity_pc
    ax, sync = axis_name, _sync(conv_sync_axis)
    x0_zero = X0 is None                 # R0 = B exactly; skip matvec(0)
    dev, dtype = B.device, B.dtype
    tiny = torch.finfo(dtype).tiny
    bnorm = _host(_cnorm(B, ax))
    R0 = B if x0_zero else B - matvec(X0)
    cols = _Columns(_host(_cnorm(R0, ax)), bnorm, maxit, dtype, rtol=rtol,
                    atol=atol, divtol=divtol)
    ones = torch.ones(B.shape[1], dtype=dtype, device=dev)
    s = dict(X=torch.zeros_like(B) if x0_zero else X0.clone(), R=R0,
             P=torch.zeros_like(B), V=torch.zeros_like(B), rho=ones,
             alpha=ones, omega=ones)
    Rt = R0
    while cols.iterating(sync):
        active = cols.active()
        rho_new = _cdot(Rt, s["R"], ax)
        beta = (rho_new / torch.where(s["rho"] != 0, s["rho"], 1.0)) \
            * (s["alpha"] / torch.where(s["omega"] != 0, s["omega"], 1.0))
        P = s["R"] + beta * (s["P"] - s["omega"] * s["V"])
        Phat = psolve(P)
        V = matvec(Phat)
        denom = _cdot(Rt, V, ax)
        alpha = rho_new / torch.where(denom != 0, denom, 1.0)
        Sr = s["R"] - alpha * V
        snorm, rho_abs = _host(torch.stack([_cnorm(Sr, ax),
                                            rho_new.abs()]))
        half_reason = cols.check(snorm, cols.trip + 1)
        all_half = bool(np.all(~active | (half_reason > 0)))
        if sync is not None:                 # JAX's pmin over the replicas
            all_half = not sync.any(not all_half)
        if all_half:
            new = dict(X=s["X"] + alpha * Phat, R=Sr, P=P, V=V, rho=rho_new,
                       alpha=alpha, omega=s["omega"])
            rn, reason = snorm, half_reason
        else:
            Shat = psolve(Sr)
            T = matvec(Shat)
            tt, ts = _cdots(((T, T), (T, Sr)), ax)
            omega = ts / torch.where(tt != 0, tt, 1.0)
            R = Sr - omega * T
            new = dict(X=s["X"] + alpha * Phat + omega * Shat, R=R, P=P, V=V,
                       rho=rho_new, alpha=alpha, omega=omega)
            rn = _host(_cnorm(R, ax))
            reason = cols.check(rn, cols.trip + 1)
            reason = np.where((rho_abs < tiny)
                              & (reason == CONVERGED_ITERATING),
                              DIVERGED_BREAKDOWN, reason)
        s = _freeze(active, new, s)
        cols.record(active, rn, reason)
    return cols.result(s["X"], _cnorm(B - matvec(s["X"]), ax))


def cg_many(matvec: Callable, B: torch.Tensor,
            X0: Optional[torch.Tensor] = None,
            pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
            atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
            axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched preconditioned CG (SPD operator and PC); B: [n, r]."""
    psolve = pc_apply or _identity_pc
    ax, sync = axis_name, _sync(conv_sync_axis)
    x0_zero = X0 is None
    dtype = B.dtype
    bnorm = _host(_cnorm(B, ax))
    R0 = B if x0_zero else B - matvec(X0)
    Z0 = psolve(R0)
    cols = _Columns(_host(_cnorm(R0, ax)), bnorm, maxit, dtype, rtol=rtol,
                    atol=atol, divtol=divtol)
    s = dict(X=torch.zeros_like(B) if x0_zero else X0.clone(), R=R0, P=Z0,
             rz=_cdot(R0, Z0, ax))
    while cols.iterating(sync):
        active = cols.active()
        W = matvec(s["P"])
        pw = _cdot(s["P"], W, ax)
        alpha = s["rz"] / torch.where(pw != 0, pw, 1.0)
        X = s["X"] + alpha * s["P"]
        R = s["R"] - alpha * W
        Z = psolve(R)
        rz_new, rr = _cdots(((R, Z), (R, R)), ax)
        beta = rz_new / torch.where(s["rz"] != 0, s["rz"], 1.0)
        new = dict(X=X, R=R, P=Z + beta * s["P"], rz=rz_new)
        rn = _host(torch.sqrt(rr.real))
        reason = cols.check(rn, cols.trip + 1)
        s = _freeze(active, new, s)
        cols.record(active, rn, reason)
    return cols.result(s["X"], _cnorm(B - matvec(s["X"]), ax))


def _orthogonalize_many(V: torch.Tensor, w: torch.Tensor,
                        cgs_refinement: str, axis=None,
                        sync: Optional[_Sync] = None):
    """Classical Gram-Schmidt of each column of ``w [n, r]`` against the
    basis ``V [a, n, r]`` with the single-RHS policy of
    ``krylov._orthogonalize``.  ``"ifneeded"``: the DGKS test is per column,
    and the one batched refinement pass runs when any column (of any
    replica, under ``sync``) needs it (JAX ``krylov_many.py:343-370``),
    decided on the host; on a mesh the column norms ride the gram row's
    ``all_reduce``.  Returns ``(w, h, ||w||)``, ``h [a, r]``."""
    def gram(w):
        h = torch.einsum("anr,nr->ar", V.conj(), w)
        return h if axis is None else axis.all_reduce(h)

    def project(w, h):
        return w - torch.einsum("ar,anr->nr", h, V)

    if cgs_refinement == "ifneeded" and axis is not None:
        hw = axis.all_reduce(torch.cat([
            torch.einsum("anr,nr->ar", V.conj(), w),
            (w.conj() * w).sum(dim=0)[None].to(V.dtype)]))
        h, wnorm0 = hw[:-1], torch.sqrt(hw[-1].real.abs())
    else:
        h = gram(w)
        wnorm0 = _cnorm(w) if cgs_refinement == "ifneeded" else None
    w = project(w, h)
    hj1 = _cnorm(w, axis)
    refine = cgs_refinement == "always"
    if cgs_refinement == "ifneeded":
        after, before = _host(torch.stack([hj1, wnorm0]))
        refine = bool((after < DGKS_THRESHOLD * before).any())
        if sync is not None:
            refine = sync.any(refine)
    if refine:
        h2 = gram(w)
        w = project(w, h2)
        h, hj1 = h + h2, _cnorm(w, axis)
    return w, h, hj1


def gmres_many(matvec: Callable, B: torch.Tensor,
               X0: Optional[torch.Tensor] = None,
               pc_apply: Optional[Callable] = None, *, restart: int = 30,
               rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
               maxit: int = 10000, side: str = "left",
               cgs_refinement: str = "always", axis_name=None,
               conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched restarted GMRES, left (default) or right
    preconditioned; B: [n, r].

    Every column runs the one-RHS ``gmres`` recurrence (classical
    Gram-Schmidt with the ``cgs_refinement`` policy of
    :func:`_orthogonalize_many`, Givens least squares), sharing each
    iteration's matvec and PCApply.  Under ``side='right'`` the residual
    and the convergence norm are the true ones, the basis runs on A M^-1
    and the correction takes one PC apply a cycle.  The Hessenberg column
    of every column comes to the host once per iteration, where the
    (unitary) rotations run per column in the vectors' dtype.  A column
    that converges mid-cycle freezes its basis, Hessenberg and rotations;
    its solution update uses exactly the basis vectors it built.  The
    basis is ``[restart+1, n, r]``."""
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}: expected left or right")
    if cgs_refinement not in ("never", "ifneeded", "always"):
        raise ValueError(
            f"unknown cgs_refinement {cgs_refinement!r}: expected never, "
            "ifneeded, or always (-ksp_gmres_cgs_refinement_type)")
    psolve = pc_apply or _identity_pc
    ax, sync = axis_name, _sync(conv_sync_axis)
    right = side == "right"
    n, nc = B.shape
    dev, dtype = B.device, B.dtype
    npdt = _NP_DTYPES[dtype]
    m = max(1, int(restart))

    def residual(X):
        R = B - matvec(X)
        return R if right else psolve(R)

    X = torch.zeros_like(B) if X0 is None else X0.clone()
    bnorm = _host(_cnorm(B if right else psolve(B), ax))
    R = residual(X)
    cols = _Columns(_host(_cnorm(R, ax)), bnorm, maxit, dtype, rtol=rtol,
                    atol=atol, divtol=divtol)
    while cols.iterating(sync):
        cycle_active = cols.active()
        beta = _cnorm(R, ax)
        V = torch.zeros((m + 1, n, nc), dtype=dtype, device=dev)
        V[0] = R / torch.where(beta > 0, beta, 1.0)
        H = np.zeros((m + 1, m, nc), npdt)
        g = np.zeros((m + 1, nc), npdt)
        g[0] = _host(beta)
        cs = np.ones((m, nc), npdt)
        sn = np.zeros((m, nc), npdt)
        jcol = np.zeros(nc, np.int64)      # steps each column was active for
        j = 0
        while j < m and cols.iterating(sync):
            active = cols.active()
            w = matvec(psolve(V[j])) if right else psolve(matvec(V[j]))
            w, h, hj1 = _orthogonalize_many(V[:j + 1], w, cgs_refinement,
                                            ax, sync)
            V[j + 1] = _merge(active, w / torch.where(hj1 > 0, hj1, 1.0),
                              V[j + 1])
            col = np.zeros((m + 1, nc), npdt)
            col[:j + 2] = _host(torch.cat([h, hj1[None].to(h.dtype)]))
            # accumulated rotations G_i = [[c, s], [-conj(s), conj(c)]],
            # then the one eliminating col[j+1]: c = conj(a) / r,
            # s = conj(b) / r, r = sqrt(|a|^2 + |b|^2)
            for i in range(j):
                t1 = cs[i] * col[i] + sn[i] * col[i + 1]
                t2 = -np.conj(sn[i]) * col[i] + np.conj(cs[i]) * col[i + 1]
                col[i], col[i + 1] = t1, t2
            denom = np.sqrt(np.abs(col[j]) ** 2 + np.abs(col[j + 1]) ** 2)
            ok = denom > 0
            safe = np.where(ok, denom, 1)
            c_new = np.where(ok, np.conj(col[j]) / safe, 1).astype(npdt)
            s_new = np.where(ok, np.conj(col[j + 1]) / safe, 0).astype(npdt)
            col[j], col[j + 1] = denom, 0
            gj = g[j].copy()
            H[:, j, active] = col[:, active]
            g[j, active] = (c_new * gj)[active]
            g[j + 1, active] = (-np.conj(s_new) * gj)[active]
            cs[j, active], sn[j, active] = c_new[active], s_new[active]
            jcol[active] += 1
            rn = np.abs(g[j + 1])
            cols.record(active, rn, cols.check(rn, cols.trip + 1))
            j += 1
        # per-column least squares on the rotated Hessenberg, each over
        # the basis vectors that column built
        y = np.zeros((m, nc), npdt)
        for c in np.flatnonzero(jcol):
            jc = jcol[c]
            y[:jc, c] = scipy.linalg.solve_triangular(
                H[:jc, :jc, c], g[:jc, c], lower=False)
        dX = torch.einsum("ar,anr->nr", torch.from_numpy(y).to(dev), V[:m])
        Xn = X + (psolve(dX) if right else dX)
        X, R = (_merge(cycle_active, Xn, X),
                _merge(cycle_active, residual(Xn), R))
    return cols.result(X, _cnorm(B - matvec(X), ax))


def richardson_many(matvec: Callable, B: torch.Tensor,
                    X0: Optional[torch.Tensor] = None,
                    pc_apply: Optional[Callable] = None, *,
                    rtol: float = 1e-5, atol: float = 1e-50,
                    divtol: float = 1e4, maxit: int = 10000,
                    scale: float = 1.0, axis_name=None, conv_sync_axis=None,
                    **_) -> KSPResult:
    """Column-batched preconditioned Richardson iteration
    X += scale * M^{-1}(B - A X); B: [n, r].  With a factorization PC this
    is multi-RHS iterative refinement."""
    psolve = pc_apply or _identity_pc
    ax, sync = axis_name, _sync(conv_sync_axis)
    x0_zero = X0 is None
    dtype = B.dtype
    bnorm = _host(_cnorm(B, ax))
    R0 = B if x0_zero else B - matvec(X0)
    cols = _Columns(_host(_cnorm(R0, ax)), bnorm, maxit, dtype, rtol=rtol,
                    atol=atol, divtol=divtol)
    s = dict(X=torch.zeros_like(B) if x0_zero else X0.clone(), R=R0)
    while cols.iterating(sync):
        active = cols.active()
        X = s["X"] + scale * psolve(s["R"])
        R = B - matvec(X)
        rn = _host(_cnorm(R, ax))
        reason = cols.check(rn, cols.trip + 1)
        s = _freeze(active, dict(X=X, R=R), s)
        cols.record(active, rn, reason)
    return cols.result(s["X"], _cnorm(B - matvec(s["X"]), ax))


def preonly_many(matvec: Callable, B: torch.Tensor,
                 X0: Optional[torch.Tensor] = None,
                 pc_apply: Optional[Callable] = None, axis_name=None,
                 **_) -> KSPResult:
    """One multi-RHS preconditioner application (KSPPREONLY batched): with
    a direct factorization PC this is ``spike_solve_many`` with the
    KSPResult bookkeeping.  The history is ``[2, r]``: ||B|| and the final
    residual norm."""
    psolve = pc_apply or _identity_pc
    X = psolve(B) if X0 is None else X0 + psolve(B - matvec(X0))
    rn = _cnorm(B - matvec(X), axis_name).detach().cpu()
    history = torch.stack([_cnorm(B, axis_name).detach().cpu(), rn])
    reason = torch.where(torch.isfinite(rn), CONVERGED_ITS,
                         DIVERGED_NANORINF).to(torch.int32)
    return KSPResult(x=X, its=torch.ones(B.shape[1], dtype=torch.int32),
                     reason=reason, rnorm=rn, history=history)


#: batched engines by the single-RHS name they correspond to
MANY_SOLVERS = {
    "gmres": gmres_many,
    "bcgs": bicgstab_many,
    "bicgstab": bicgstab_many,
    "cg": cg_many,
    "richardson": richardson_many,
    "preonly": preonly_many,
}

"""Krylov solvers (the KSP layer), PyTorch.

Ported: restarted GMRES with left preconditioning, classical Gram-Schmidt
with one unconditional refinement pass (``cgs_refinement="always"``) and
classical Givens rotations, BiCGStab (``bcgs``/``fbcgs``/``bicgstab``),
preconditioned CG (``cg``), preconditioned Richardson (``richardson``, the
iterative-refinement loop) and one PC application (``preonly``), as in
``spike_petsc_tpu.solvers.krylov``.

The JAX version stages the whole solve in ``lax.while_loop``.  Here the
vectors and the Krylov basis stay on the operator's device, and the small
Hessenberg column comes to the host once per iteration: the Givens rotations,
the convergence test and the least-squares solve run there in the vectors'
dtype.  That is one device synchronization per iteration, and it keeps
iteration counts and residual histories equal to the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..utils.registry import register_ksp
from .types import (CONVERGED_ITERATING, CONVERGED_ITS, DIVERGED_BREAKDOWN,
                    DIVERGED_NANORINF, KSPResult, default_convergence_check)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _identity_pc(x):
    return x


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(x, x))


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          pc_apply: Optional[Callable] = None, *, restart: int = 30,
          rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
          maxit: int = 10000, side: str = "left", monitor_true: bool = False,
          norm_type: str = "default",
          cgs_refinement: str = "always") -> KSPResult:
    """Restarted GMRES with left preconditioning (PETSc KSPGMRES defaults:
    restart 30, rtol 1e-5, preconditioned residual monitoring).

    Ported options: ``side="left"``, ``norm_type`` "default" or
    "preconditioned", ``cgs_refinement="always"``; the others raise.
    """
    if side != "left":
        raise NotImplementedError(f"gmres(side={side!r}) is not yet ported")
    if monitor_true or norm_type not in ("default", "preconditioned"):
        raise NotImplementedError(
            "gmres true-residual monitoring is not yet ported")
    if cgs_refinement != "always":
        raise NotImplementedError(
            f"gmres(cgs_refinement={cgs_refinement!r}) is not yet ported")
    return _gmres_like(matvec, b, x0, pc_apply, restart=restart, rtol=rtol,
                       atol=atol, divtol=divtol, maxit=maxit)


def _gmres_like(matvec, b, x0, pc_apply, *, restart, rtol, atol, divtol,
                maxit):
    psolve = pc_apply or _identity_pc
    n, dtype, device = b.shape[0], b.dtype, b.device
    npdt = _NP_DTYPES[dtype]
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = float(_norm(psolve(b)))
    history = torch.full((maxit + 1,), float("nan"), dtype=dtype)

    def check(rn, its):
        return default_convergence_check(rn, bnorm, its, rtol=rtol,
                                         atol=atol, divtol=divtol,
                                         maxit=maxit)

    r = psolve(b - matvec(x))
    rnorm = float(_norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    while reason == CONVERGED_ITERATING:
        beta = _norm(r)
        V = torch.zeros((restart + 1, n), dtype=dtype, device=device)
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        H = np.zeros((restart + 1, restart), npdt)
        g = np.zeros(restart + 1, npdt)
        g[0] = npdt(beta.item())
        cs = np.ones(restart, npdt)
        sn = np.zeros(restart, npdt)
        j = 0
        while j < restart and reason == CONVERGED_ITERATING:
            w = psolve(matvec(V[j]))
            # classical Gram-Schmidt against V[0..j], one refinement pass
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - h @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            hj1 = _norm(w)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
            col = np.zeros(restart + 1, npdt)
            col[:j + 2] = torch.cat([h + h2, hj1[None]]).cpu().numpy()
            # accumulated Givens rotations, then the one eliminating col[j+1]
            for i in range(j):
                t1 = cs[i] * col[i] + sn[i] * col[i + 1]
                t2 = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i], col[i + 1] = t1, t2
            denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            c_new, s_new = ((col[j] / denom, col[j + 1] / denom)
                            if denom > 0 else (npdt(1), npdt(0)))
            col[j], col[j + 1] = denom, 0
            g[j], g[j + 1] = c_new * g[j], -s_new * g[j]
            H[:, j] = col
            cs[j], sn[j] = c_new, s_new
            rnorm = float(abs(g[j + 1]))
            j += 1
            its += 1
            history[its] = rnorm
            reason = check(rnorm, its)
        # least squares on the rotated (upper triangular) Hessenberg
        y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
        x = x + torch.from_numpy(np.ascontiguousarray(y)).to(device) @ V[:j]
        if reason == CONVERGED_ITERATING:
            r = psolve(b - matvec(x))
    return KSPResult(x=x, its=its, reason=reason, rnorm=rnorm,
                     history=history)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None,
             pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
             atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
             **_) -> KSPResult:
    """Preconditioned BiCGStab (van der Vorst), PETSc KSPBCGS/KSPFBCGS as in
    the JAX package: the PC is applied afresh to p and s every iteration
    and the solution is updated with the preconditioned vectors; the
    monitored residual is the true residual.  The scalars stay on the
    device; the residual norm and |rho| come to the host once per
    iteration for the convergence and breakdown tests."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = torch.finfo(dtype).tiny
    bnorm = float(_norm(b))
    history = torch.full((maxit + 1,), float("nan"), dtype=dtype)

    def check(rn, its):
        return default_convergence_check(rn, bnorm, its, rtol=rtol,
                                         atol=atol, divtol=divtol,
                                         maxit=maxit)

    r = b if x0_zero else b - matvec(x)
    rtilde = r
    rnorm = float(_norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    while reason == CONVERGED_ITERATING:
        rho_new = torch.dot(rtilde, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = psolve(p)
        v = matvec(phat)
        denom = torch.dot(rtilde, v)
        alpha = rho_new / torch.where(denom != 0, denom, 1.0)
        sr = r - alpha * v
        shat = psolve(sr)
        t = matvec(shat)
        tt, ts = torch.dot(t, t), torch.dot(t, sr)
        omega = ts / torch.where(tt != 0, tt, 1.0)
        x = x + alpha * phat + omega * shat
        r = sr - omega * t
        rho = rho_new
        rn, rho_abs = torch.stack([_norm(r), rho_new.abs()]).tolist()
        its += 1
        history[its] = rn
        reason = check(rn, its)
        if reason == CONVERGED_ITERATING and rho_abs < tiny:
            reason = DIVERGED_BREAKDOWN
    return KSPResult(x=x, its=its, reason=reason,
                     rnorm=float(_norm(b - matvec(x))), history=history)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
       atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
       **_) -> KSPResult:
    """Preconditioned conjugate gradients (SPD operator and PC).  The
    monitored residual is the unpreconditioned ||r||, which comes to the
    host once per iteration for the convergence test; <r, z>, alpha and
    beta stay on the device."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    bnorm = float(_norm(b))
    history = torch.full((maxit + 1,), float("nan"), dtype=b.dtype)

    def check(rn, its):
        return default_convergence_check(rn, bnorm, its, rtol=rtol,
                                         atol=atol, divtol=divtol,
                                         maxit=maxit)

    r = b if x0_zero else b - matvec(x)
    p = psolve(r)
    rz = torch.dot(r, p)
    rnorm = float(_norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    while reason == CONVERGED_ITERATING:
        w = matvec(p)
        pw = torch.dot(p, w)
        alpha = rz / torch.where(pw != 0, pw, 1.0)
        x = x + alpha * p
        r = r - alpha * w
        z = psolve(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        rn = float(_norm(r))
        its += 1
        history[its] = rn
        reason = check(rn, its)
    return KSPResult(x=x, its=its, reason=reason,
                     rnorm=float(_norm(b - matvec(x))), history=history)


def richardson(matvec: Callable, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None,
               pc_apply: Optional[Callable] = None, *, scale: float = 1.0,
               rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
               maxit: int = 10000, **_) -> KSPResult:
    """Preconditioned Richardson iteration x += scale * M^{-1} r; with a
    (possibly lower-precision) factorization PC this is stationary
    iterative refinement.  The monitored residual is the true ||b - A x||,
    recomputed every iteration, and comes to the host once per iteration
    for the convergence test."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    bnorm = float(_norm(b))
    history = torch.full((maxit + 1,), float("nan"), dtype=b.dtype)

    def check(rn, its):
        return default_convergence_check(rn, bnorm, its, rtol=rtol,
                                         atol=atol, divtol=divtol,
                                         maxit=maxit)

    r = b if x0_zero else b - matvec(x)
    rnorm = float(_norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    while reason == CONVERGED_ITERATING:
        x = x + scale * psolve(r)
        r = b - matvec(x)
        rn = float(_norm(r))
        its += 1
        history[its] = rn
        reason = check(rn, its)
    return KSPResult(x=x, its=its, reason=reason,
                     rnorm=float(_norm(b - matvec(x))), history=history)


def preonly(matvec: Callable, b: torch.Tensor,
            x0: Optional[torch.Tensor] = None,
            pc_apply: Optional[Callable] = None, **_) -> KSPResult:
    """One preconditioner application (PETSc KSPPREONLY): with a direct
    factorization PC this is the direct solve.  The reason is
    CONVERGED_ITS unless the residual is non-finite (DIVERGED_NANORINF);
    the history is ``[||b||, ||b - A x||]`` whatever the caller's maxit."""
    psolve = pc_apply or _identity_pc
    x = psolve(b) if x0 is None else x0 + psolve(b - matvec(x0))
    rn, bn = torch.stack([_norm(b - matvec(x)), _norm(b)]).tolist()
    history = torch.tensor([bn, rn], dtype=b.dtype)
    reason = CONVERGED_ITS if math.isfinite(rn) else DIVERGED_NANORINF
    return KSPResult(x=x, its=1, reason=reason, rnorm=rn, history=history)


register_ksp("gmres", gmres)
register_ksp("cg", cg)
register_ksp("richardson", richardson)
register_ksp("preonly", preonly)
for _name in ("bcgs", "fbcgs", "bicgstab"):
    register_ksp(_name, bicgstab)

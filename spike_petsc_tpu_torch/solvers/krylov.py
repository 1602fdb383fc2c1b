"""Krylov solvers (the KSP layer), PyTorch.

Ported, as in ``spike_petsc_tpu.solvers.krylov``, with the same arguments,
defaults, converged reasons and history semantics:

* the GMRES family: restarted ``gmres`` (left or right PC; the
  preconditioned, unpreconditioned or default convergence norm; classical
  Gram-Schmidt with the ``never``, ``ifneeded`` or ``always`` refinement;
  the true-residual monitor), ``fgmres`` (flexible, right PC) and
  ``lgmres`` (restart cycles augmented with earlier error approximations);
* BiCGStab (``bcgs``/``fbcgs``/``bicgstab``), BiCGStab(l) (``bcgsl``),
  ``cgs``, ``tfqmr`` and ``gcr`` for general operators;
* ``cg``, ``pipecg``, ``cr``, ``minres`` and ``symmlq`` for symmetric ones;
* ``chebyshev``, ``richardson`` and ``preonly``;
* the types that iterate on A^T, given ``matvec_transpose`` and
  ``pc_apply_transpose`` (``ksp.make_solver`` builds them from the
  operator and ``PC.transpose``): ``bicg``, ``cgnr`` (registered as
  ``cgne``, ``cgnr`` and ``cgls``) and ``lsqr``;
* the Arnoldi spectrum estimate behind ``-ksp_compute_eigenvalues`` and
  ``-ksp_chebyshev_esteig`` (``arnoldi_hessenberg``,
  ``estimate_extreme_eigs``, ``chebyshev_esteig_bounds``), and the
  Golub-Kahan singular-value estimate behind
  ``-ksp_compute_singularvalues`` (``golub_kahan_bidiag``,
  ``estimate_extreme_singular_values``).

The JAX versions stage each solve in ``lax.while_loop``.  Here the vectors
(and the Krylov bases) stay on the operator's device, and the small scalars
that a decision needs come to the host once per iteration: the residual
norm for the convergence test, with the breakdown tests' magnitudes stacked
beside it.  GMRES brings its Hessenberg column to the host, where the
Givens rotations and the least-squares solve run in the vectors' dtype.
Complex scalars take JAX's formulas: inner products conjugate their first
argument, norms and histories are real, the Givens rotations are unitary
and the A^T types apply A^H = conj(A^T conj(.)).  Where the JAX loop computes a step and discards it (a gate on a terminal
reason), the port does not compute it.  Iteration counts and residual
histories equal the reference's.

Reductions are mesh-aware, as in JAX: every solver takes ``axis_name``, a
``parallel.mesh.MeshAxis`` (or None), and then sees its rank's row block
of the vectors; each JAX ``psum`` is one ``all_reduce`` over the axis's
group (the fused ``_dots`` and the DGKS norm riding the gram row stay one),
so every rank brings the same scalars to the host and takes the same
branches.  With ``axis_name=None`` no collective runs.  ``conv_sync_axis``
(the replica axis of a serving mesh) keeps JAX's meaning: the GMRES family
(``gmres``, ``fgmres``, ``lgmres``) runs every replica until all have
stopped and takes the DGKS refinement where any replica needs it, one
``all_reduce`` a decision.  JAX freezes the state of a stopped replica in
the other solvers, so their results do not depend on the other replicas;
here each replica's collectives run on its own group, and those solvers
need no vote.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..utils.registry import register_ksp
from .types import (CONVERGED_ITERATING, CONVERGED_ITS,
                    CONVERGED_RTOL_NORMAL, DIVERGED_BREAKDOWN,
                    DIVERGED_NANORINF, KSPResult, default_convergence_check)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _identity_pc(x):
    return x


def _psum(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over the mesh axis ``axis`` (one ``all_reduce``; a
    ``parallel.mesh.MeshAxis``), or ``t`` itself for ``axis=None``."""
    return t if axis is None else axis.all_reduce(t)


def _dot(a: torch.Tensor, b: torch.Tensor, axis=None) -> torch.Tensor:
    """<a, b> = a^H b (``jnp.vdot``: the first argument conjugated), summed
    over ``axis`` when the vectors are row blocks of a mesh."""
    return _psum(torch.vdot(a, b), axis)


def _norm(x: torch.Tensor, axis=None) -> torch.Tensor:
    """||x||, real for complex x."""
    return torch.sqrt(_dot(x, x, axis).real)


def _dots(pairs, axis=None) -> tuple:
    """Several inner products <a_i, b_i> in pair order; on a mesh they ride
    ONE stacked ``all_reduce`` (JAX ``krylov.py:76-87``)."""
    d = [torch.vdot(a, b) for a, b in pairs]
    if axis is None:
        return tuple(d)
    s = axis.all_reduce(torch.stack(d))
    return tuple(s[i] for i in range(len(pairs)))


def _gram(V: torch.Tensor, w: torch.Tensor, axis=None) -> torch.Tensor:
    """The projection row <V_i, w> = V^H w, summed over ``axis``."""
    return _psum(V.conj() @ w, axis)


def _normer(axis):
    """``x -> ||x||`` summed over ``axis``."""
    return lambda x: _norm(x, axis)


def _reducers(axis):
    """``(dot, norm, dots)`` summed over ``axis``: the inner products of a
    solver whose vectors are row blocks of a mesh."""
    return (lambda a, b: _dot(a, b, axis), _normer(axis),
            lambda pairs: _dots(pairs, axis))


class _Sync:
    """``conv_sync_axis`` of the GMRES family: the decisions JAX makes
    replica-wide by ``pmax`` over a mesh axis the solver's sums do not
    cover (the rhs axis of a serving mesh; JAX ``krylov.py:130, 142-156``).
    ``any(flag)`` is True when the flag holds on any replica, one
    ``all_reduce`` each; with no axis it is the flag itself.  Every replica
    runs the same sequence of votes, so their collectives stay aligned."""

    def __init__(self, axis):
        self.axis = axis

    def any(self, flag: bool) -> bool:
        if self.axis is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.axis.device)
        return bool(self.axis.all_reduce(t, "max").item())

    def iterating(self, reason: int) -> bool:
        """JAX ``_keep_iterating``: some replica's reason is iterating."""
        return self.any(reason == CONVERGED_ITERATING)


def _conj(x: torch.Tensor) -> torch.Tensor:
    """conj(x), materialized for complex x (a real x is returned as is)."""
    return torch.conj_physical(x) if x.is_complex() else x


def _hermitian(fn: Optional[Callable]) -> Optional[Callable]:
    """v -> conj(fn(conj(v))): A^H from the pure transpose A^T (JAX
    ``krylov.py:270-271``); the identity wrapping for real scalars."""
    if fn is None:
        return None
    return lambda v: _conj(fn(_conj(v)))


def _safe(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it is nonzero, else 1 (a guarded divisor)."""
    return torch.where(t != 0, t, torch.ones_like(t))


def _host(*scalars: torch.Tensor) -> list:
    """Device scalars to host floats, in one synchronization."""
    return torch.stack([s.reshape(()) for s in scalars]).tolist()


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).tiny


def _history(maxit: int, dtype: torch.dtype) -> torch.Tensor:
    """A NaN history in the real dtype of ``dtype`` (norms are real)."""
    return torch.full((maxit + 1,), float("nan"), dtype=dtype.to_real())


def _checker(bnorm: float, *, rtol, atol, divtol, maxit) -> Callable:
    def check(rn, its):
        return default_convergence_check(rn, bnorm, its, rtol=rtol,
                                         atol=atol, divtol=divtol,
                                         maxit=maxit)
    return check


def _breakdown(reason: int, broke: bool) -> int:
    """A breakdown overrides an iterating reason only."""
    if broke and reason == CONVERGED_ITERATING:
        return DIVERGED_BREAKDOWN
    return reason


def _result(matvec, b, x, its, reason, history, true_history=None,
            axis=None):
    """The result with the true final residual norm."""
    return KSPResult(x=x, its=its, reason=reason,
                     rnorm=float(_norm(b - matvec(x), axis)),
                     history=history, true_history=true_history)


#: the DGKS cancellation test of ``ifneeded``: refine when the projection
#: leaves less than 1/sqrt(2) of the vector's norm
DGKS_THRESHOLD = 0.7071067811865476


def _orthogonalize(V: torch.Tensor, w: torch.Tensor, cgs_refinement: str,
                   axis=None, sync: Optional[_Sync] = None):
    """Classical Gram-Schmidt of ``w`` against the rows of ``V`` with
    PETSc's refinement policy (``KSPGMRESSetCGSRefinementType``):
    ``"always"`` one unconditional second pass, ``"never"`` a single pass,
    ``"ifneeded"`` a second pass only when the DGKS test
    ``||w_after|| < ||w_before|| / sqrt(2)`` finds cancellation (decided on
    the host, so a skipped pass costs nothing; on a mesh the pre-projection
    norm rides the gram row's ``all_reduce``, and ``sync`` takes the
    decision over the replicas).  Returns ``(w, h, ||w||)`` with ``h`` the
    projection row ``V^H w``."""
    if cgs_refinement == "never":
        h = _gram(V, w, axis)
        w = w - h @ V
        return w, h, _norm(w, axis)
    if cgs_refinement == "always":
        h = _gram(V, w, axis)
        w = w - h @ V
        h2 = _gram(V, w, axis)
        w = w - h2 @ V
        return w, h + h2, _norm(w, axis)
    if cgs_refinement != "ifneeded":
        raise ValueError(
            f"unknown cgs_refinement {cgs_refinement!r}: expected never, "
            "ifneeded, or always (-ksp_gmres_cgs_refinement_type)")
    if axis is None:
        h = V.conj() @ w
        wnorm0 = _norm(w)
    else:
        hv = axis.all_reduce(torch.cat([V.conj() @ w,
                                        torch.vdot(w, w)[None].to(V.dtype)]))
        h, wnorm0 = hv[:-1], torch.sqrt(hv[-1].real.abs())
    w = w - h @ V
    hj1 = _norm(w, axis)
    after, before = _host(hj1, wnorm0)
    need = after < DGKS_THRESHOLD * before
    if sync is not None:
        need = sync.any(need)
    if need:
        h2 = _gram(V, w, axis)
        w = w - h2 @ V
        return w, h + h2, _norm(w, axis)
    return w, h, hj1


# ---------------------------------------------------------------------------
# Arnoldi spectrum estimation (KSPComputeEigenvalues / KSPChebyshevEstEig)
# ---------------------------------------------------------------------------

def arnoldi_hessenberg(matvec: Callable, v0: torch.Tensor, m: int,
                       pc_apply: Optional[Callable] = None, axis_name=None):
    """m-step Arnoldi factorization of the left-preconditioned operator
    M^-1 A started from ``v0``; returns ``(H, k)`` with H the ``(m+1, m)``
    Hessenberg (a host numpy array in the vectors' dtype) and ``k`` the
    number of completed columns (< m on exact breakdown, where the Krylov
    space became invariant and the Ritz values of ``H[:k, :k]`` are exact
    eigenvalues).  One classical Gram-Schmidt pass a step, as in JAX; the
    columns past a breakdown stay zero."""
    psolve = pc_apply or _identity_pc
    npdt = _NP_DTYPES[v0.dtype]
    tiny = _tiny(v0.dtype)
    n0 = _norm(v0, axis_name)
    V = torch.zeros((m + 1,) + tuple(v0.shape), dtype=v0.dtype,
                    device=v0.device)
    V[0] = v0 / _safe(n0)
    H = np.zeros((m + 1, m), npdt)
    k = 0
    for j in range(m):
        w = psolve(matvec(V[j]))
        h = _gram(V[:j + 1], w, axis_name)
        w = w - h @ V[:j + 1]
        hj1 = _norm(w, axis_name)
        col = torch.cat([h, hj1[None].to(h.dtype)]).cpu().numpy()
        H[:j + 2, j] = col
        k += 1
        if not col[-1].real > 1e3 * tiny:
            break
        V[j + 1] = w / _safe(hj1)
    return H, k


def estimate_extreme_eigs(matvec: Callable, n: int, dtype=torch.float32, *,
                          m: int = 10, pc_apply: Optional[Callable] = None,
                          seed: int = 0, v0=None, device=None,
                          axis_name=None):
    """Ritz-value estimate of M^-1 A's spectrum: ``m`` Arnoldi steps on the
    operator's device, the eigenvalues of the small Hessenberg on the host.
    Returns the complex Ritz values (length <= m).  ``v0`` defaults to a
    seeded standard normal vector (the JAX package's draws) on ``device``
    (default the card).  Set-up work, as PETSc's estimate in KSPSetUp."""
    m = max(1, min(int(m), int(n)))
    if v0 is None:
        v0 = torch.as_tensor(
            np.random.default_rng(seed).standard_normal(n)).to(
                device=torch.device(device or "cuda"), dtype=dtype)
    H, k = arnoldi_hessenberg(matvec, v0, m, pc_apply, axis_name)
    if k == 0:
        return np.zeros(0, complex)
    return np.linalg.eigvals(H[:k, :k])


# ---------------------------------------------------------------------------
# Golub-Kahan singular-value estimation (KSPComputeExtremeSingularValues)
# ---------------------------------------------------------------------------

def _need_transpose(name: str, matvec_transpose) -> None:
    if matvec_transpose is None:
        raise ValueError(f"{name} requires matvec_transpose (an explicit "
                         "operator through ksp.solve provides it; bare "
                         "callables cannot be transposed)")


def golub_kahan_bidiag(matvec: Callable, matvec_transpose: Callable,
                       v0: torch.Tensor, m: int,
                       pc_apply: Optional[Callable] = None,
                       pc_apply_transpose: Optional[Callable] = None,
                       axis_name=None):
    """m-step Golub-Kahan bidiagonalization of the left-preconditioned
    operator B = M^-1 A started from ``v0``; returns ``(alphas, betas, k)``
    (host numpy arrays in the vectors' dtype, length m) with
    bidiag(alphas, betas) the (k+1, k) lower-bidiagonal factor and ``k`` the
    number of completed steps (< m on breakdown, which appends no zero
    column).  The scalars stay on the device; each step's two norms come to
    the host for the breakdown test.  B^H = A^H M^-H comes from the pure
    transposes by conjugation."""
    psolve = pc_apply or _identity_pc
    mv_h = _hermitian(matvec_transpose)
    ps_h = _hermitian(pc_apply_transpose) or _identity_pc

    def bmv(v):
        return psolve(matvec(v))

    def bmv_t(v):
        return mv_h(ps_h(v))

    npdt = _NP_DTYPES[v0.dtype.to_real()]
    tiny = _tiny(v0.dtype)
    norm = _normer(axis_name)
    u = v0 / _safe(norm(v0))
    v_un = bmv_t(u)
    alpha = norm(v_un)
    v = v_un / _safe(alpha)
    alphas, betas = np.zeros(m, npdt), np.zeros(m, npdt)
    alphas[0] = float(alpha)
    k = 1
    alive = alphas[0] > 1e3 * tiny
    for j in range(m - 1):
        if not alive:
            break
        u_un = bmv(v) - alpha * u
        beta = norm(u_un)
        u = u_un / _safe(beta)
        v_un = bmv_t(u) - beta * v
        alpha = norm(v_un)
        v = v_un / _safe(alpha)
        beta_h, alpha_h = _host(beta, alpha)
        betas[j] = beta_h
        alive = beta_h > 1e3 * tiny and alpha_h > 1e3 * tiny
        if alive:
            alphas[j + 1] = alpha_h
            k += 1
    return alphas, betas, k


def estimate_extreme_singular_values(matvec: Callable,
                                     matvec_transpose: Callable, n: int,
                                     dtype=torch.float32, *, m: int = 30,
                                     pc_apply: Optional[Callable] = None,
                                     pc_apply_transpose: Optional[Callable]
                                     = None, seed: int = 0, v0=None,
                                     device=None, axis_name=None):
    """Extreme singular values of M^-1 A, ``(smax, smin)``: ``m``
    Golub-Kahan steps on the operator's device, the SVD of the small
    bidiagonal on the host (PETSc KSPComputeExtremeSingularValues).  ``v0``
    defaults to a seeded standard normal vector (the JAX package's draws)
    on ``device`` (default the card)."""
    m = max(2, min(int(m), int(n)))
    if v0 is None:
        v0 = torch.as_tensor(
            np.random.default_rng(seed).standard_normal(n)).to(
                device=torch.device(device or "cuda"), dtype=dtype)
    alphas, betas, k = golub_kahan_bidiag(matvec, matvec_transpose, v0, m,
                                          pc_apply, pc_apply_transpose,
                                          axis_name)
    if k == 0:
        return 0.0, 0.0
    B = np.zeros((k + 1, k))
    B[np.arange(k), np.arange(k)] = alphas[:k]
    B[np.arange(1, k + 1), np.arange(k)] = betas[:k]
    sv = np.linalg.svd(B, compute_uv=False)
    return float(sv.max()), float(sv.min())


#: PETSc's default -ksp_chebyshev_esteig transform: bounds from the Ritz
#: extremes as (a*lmin + b*lmax, c*lmin + d*lmax).  The 0.1 floor keeps the
#: smoother robust when the smallest eigenvalues are underestimated by a
#: short Arnoldi run; 1.1 adds headroom above the largest Ritz value.
ESTEIG_DEFAULT_TRANSFORM = (0.0, 0.1, 0.0, 1.1)


def chebyshev_esteig_bounds(eigs, transform=ESTEIG_DEFAULT_TRANSFORM):
    """Map Ritz values to chebyshev [emin, emax] via the 4-parameter PETSc
    transform (KSPChebyshevEstEigSet semantics)."""
    re = np.real(np.asarray(eigs))
    if re.size == 0:
        raise ValueError("no Ritz values: Arnoldi broke down at step 0 "
                         "(zero starting vector?)")
    lmin, lmax = float(re.min()), float(re.max())
    a, b, c, d = transform
    return a * lmin + b * lmax, c * lmin + d * lmax


# ---------------------------------------------------------------------------
# GMRES family
# ---------------------------------------------------------------------------

class _Givens:
    """The rotated Hessenberg of one restart cycle, on the host in the
    vectors' dtype: Givens rotations G_i = [[c_i, s_i], [-conj(s_i),
    conj(c_i)]] (unitary; the classical ones for real scalars), the rotated
    right-hand side ``g`` and the triangular least-squares solve."""

    def __init__(self, restart: int, beta: float, npdt):
        self.npdt = npdt
        self.H = np.zeros((restart + 1, restart), npdt)
        self.g = np.zeros(restart + 1, npdt)
        self.g[0] = npdt(beta)
        self.cs = np.ones(restart, npdt)
        self.sn = np.zeros(restart, npdt)

    def add_column(self, j: int, col: np.ndarray) -> float:
        """Rotate column ``j`` (``col[:j+2]``) into the triangle; return the
        new residual estimate |g[j+1]|."""
        cs, sn, npdt = self.cs, self.sn, self.npdt
        col = np.concatenate([col, np.zeros(self.H.shape[0] - col.size,
                                            npdt)])
        for i in range(j):
            t1 = cs[i] * col[i] + sn[i] * col[i + 1]
            t2 = -np.conj(sn[i]) * col[i] + np.conj(cs[i]) * col[i + 1]
            col[i], col[i + 1] = t1, t2
        # c = conj(a) / r, s = conj(b) / r, r = sqrt(|a|^2 + |b|^2)
        denom = np.sqrt(np.abs(col[j]) ** 2 + np.abs(col[j + 1]) ** 2)
        c_new, s_new = ((np.conj(col[j]) / denom,
                         np.conj(col[j + 1]) / denom)
                        if denom > 0 else (npdt(1), npdt(0)))
        col[j], col[j + 1] = denom, 0
        self.g[j], self.g[j + 1] = (c_new * self.g[j],
                                    -np.conj(s_new) * self.g[j])
        self.H[:, j] = col
        cs[j], sn[j] = c_new, s_new
        return float(abs(self.g[j + 1]))

    def solve(self, j: int, device) -> torch.Tensor:
        y = scipy.linalg.solve_triangular(self.H[:j, :j], self.g[:j],
                                          lower=False)
        return torch.from_numpy(np.ascontiguousarray(y)).to(device)


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          pc_apply: Optional[Callable] = None, *, restart: int = 30,
          rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
          maxit: int = 10000, side: str = "left", monitor_true: bool = False,
          norm_type: str = "default", cgs_refinement: str = "always",
          axis_name=None, conv_sync_axis=None) -> KSPResult:
    """Restarted GMRES with left (default) or right preconditioning (PETSc
    KSPGMRES defaults: restart 30, rtol 1e-5, classical Givens least
    squares, the preconditioned residual monitored under a left PC).

    ``monitor_true=True`` records the unpreconditioned residual norm of
    every iteration in ``result.true_history`` (``-ksp_monitor_true_residual``)
    at one extra matvec (and PC apply under a right PC) an iteration.
    ``norm_type`` "unpreconditioned" converges on that true norm under a left
    PC; "preconditioned" with a right PC is an error, as in PETSc.
    ``cgs_refinement``: see :func:`_orthogonalize`.

    On a mesh (``axis_name``, a ``parallel.mesh.MeshAxis``) every inner
    product is one ``all_reduce`` over the axis.  ``conv_sync_axis``
    (another axis, the replicas of a serving mesh) runs every replica until
    all have stopped, as JAX's synced predicate does: a converged replica
    keeps refining, and ``its`` counts the iterations it ran."""
    return _gmres_like(matvec, b, x0, pc_apply, restart=restart, rtol=rtol,
                       atol=atol, divtol=divtol, maxit=maxit, flexible=False,
                       right=(side == "right"), monitor_true=monitor_true,
                       norm_type=norm_type, cgs_refinement=cgs_refinement,
                       axis_name=axis_name, conv_sync_axis=conv_sync_axis)


def fgmres(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           pc_apply: Optional[Callable] = None, *, restart: int = 30,
           rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
           maxit: int = 10000, monitor_true: bool = False,
           norm_type: str = "default", cgs_refinement: str = "always",
           axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Flexible GMRES: right-preconditioned, storing the preconditioned
    basis, so the PC may change between iterations (an inner Krylov
    solve).  ``norm_type`` "unpreconditioned" is a no-op (the true residual
    is monitored already) and "preconditioned" an error, as in PETSc."""
    return _gmres_like(matvec, b, x0, pc_apply, restart=restart, rtol=rtol,
                       atol=atol, divtol=divtol, maxit=maxit, flexible=True,
                       right=True, monitor_true=monitor_true,
                       norm_type=norm_type, cgs_refinement=cgs_refinement,
                       axis_name=axis_name, conv_sync_axis=conv_sync_axis)


def _keeper(conv_sync_axis):
    """``(sync, keep)``: the replica vote of :class:`_Sync` (None without a
    sync axis) and the loop predicate on a reason, synced when there is
    one."""
    if conv_sync_axis is None:
        return None, lambda reason: reason == CONVERGED_ITERATING
    sync = _Sync(conv_sync_axis)
    return sync, sync.iterating


def _gmres_like(matvec, b, x0, pc_apply, *, restart, rtol, atol, divtol,
                maxit, flexible, right, monitor_true=False,
                norm_type="default", cgs_refinement="always",
                axis_name=None, conv_sync_axis=None):
    psolve = pc_apply or _identity_pc
    norm = _normer(axis_name)
    sync, keep = _keeper(conv_sync_axis)
    n, dtype, device = b.shape[0], b.dtype, b.device
    npdt = _NP_DTYPES[dtype]
    if norm_type not in ("default", "preconditioned", "unpreconditioned"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    if norm_type == "preconditioned" and right:
        raise ValueError("norm_type='preconditioned' is incompatible with "
                         "right preconditioning (fgmres / side='right')")
    unprec = norm_type == "unpreconditioned" and not right
    track_true = monitor_true or unprec
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = float(norm(b) if (right or unprec) else norm(psolve(b)))
    check = _checker(bnorm, rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
    history = _history(maxit, dtype)
    true_history = _history(maxit, dtype) if track_true else None

    def residual(x):
        r = b - matvec(x)
        return r if right else psolve(r)

    def update(giv, j, V, Z):
        """The correction of a cycle's first j directions."""
        y = giv.solve(j, device)
        if flexible:
            return y @ Z[:j]
        dx = y @ V[:j]
        return psolve(dx) if right else dx

    r = residual(x)
    rnorm = float(norm(r))
    if track_true:
        true0 = float(norm(b - matvec(x)))
        true_history[0] = true0
        if unprec:
            rnorm = true0
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    going = keep(reason)
    while going:
        beta = norm(r)
        V = torch.zeros((restart + 1, n), dtype=dtype, device=device)
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        Z = (torch.zeros((restart, n), dtype=dtype, device=device)
             if flexible else None)
        giv = _Givens(restart, beta.item(), npdt)
        j = 0
        while j < restart and going:
            if flexible:
                Z[j] = psolve(V[j])
                w = matvec(Z[j])
            elif right:
                w = matvec(psolve(V[j]))
            else:
                w = psolve(matvec(V[j]))
            w, h, hj1 = _orthogonalize(V[:j + 1], w, cgs_refinement,
                                       axis_name, sync)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
            col = torch.cat([h, hj1[None].to(h.dtype)]).cpu().numpy()
            rnorm = giv.add_column(j, col)
            j += 1
            its += 1
            if track_true:
                # the current iterate's true residual: one extra matvec
                true_rn = float(norm(b - matvec(x + update(giv, j, V, Z))))
                true_history[its] = true_rn
                if unprec:
                    rnorm = true_rn
            history[its] = rnorm
            reason = check(rnorm, its)
            going = keep(reason)
        x = x + update(giv, j, V, Z)
        if going:
            r = residual(x)
    return KSPResult(x=x, its=its, reason=reason, rnorm=rnorm,
                     history=history, true_history=true_history)


def lgmres(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           pc_apply: Optional[Callable] = None, *, restart: int = 30,
           aug: int = 2, rtol: float = 1e-5, atol: float = 1e-50,
           divtol: float = 1e4, maxit: int = 10000,
           cgs_refinement: str = "always", axis_name=None,
           conv_sync_axis=None, **_) -> KSPResult:
    """LGMRES (Baker-Jessup-Manteuffel; PETSc KSPLGMRES): restarted,
    left-preconditioned GMRES whose cycles append the ``aug`` most recent
    normalized error approximations (each cycle's correction) to the search
    space, ``restart`` directions in all.  The first cycle is plain
    GMRES(restart); ``aug=0`` is gmres.  ``axis_name`` and
    ``conv_sync_axis`` as in :func:`gmres`."""
    psolve = pc_apply or _identity_pc
    norm = _normer(axis_name)
    sync, keep = _keeper(conv_sync_axis)
    n, dtype, device = b.shape[0], b.dtype, b.device
    npdt = _NP_DTYPES[dtype]
    aug = max(0, min(int(aug), restart - 1))
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = float(norm(psolve(b)))
    check = _checker(bnorm, rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
    history = _history(maxit, dtype)

    def residual(x):
        return psolve(b - matvec(x))

    r = residual(x)
    rnorm = float(norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    going = keep(reason)
    augs = []                      # normalized corrections, newest first
    while going:
        beta = norm(r)
        mk = restart - len(augs)   # Krylov directions this cycle
        V = torch.zeros((restart + 1, n), dtype=dtype, device=device)
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        Z = torch.zeros((restart, n), dtype=dtype, device=device)
        giv = _Givens(restart, beta.item(), npdt)
        j = 0
        while j < restart and going:
            Z[j] = V[j] if j < mk else augs[j - mk]
            w = psolve(matvec(Z[j]))
            w, h, hj1 = _orthogonalize(V[:j + 1], w, cgs_refinement,
                                       axis_name, sync)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
            rnorm = giv.add_column(
                j, torch.cat([h, hj1[None].to(h.dtype)]).cpu().numpy())
            j += 1
            its += 1
            history[its] = rnorm
            reason = check(rnorm, its)
            going = keep(reason)
        dx = giv.solve(j, device) @ Z[:j]
        x = x + dx
        if aug:
            dxn = norm(dx)
            if dxn.item() > 0:
                augs = [dx / dxn] + augs[:aug - 1]
        if going:
            r = residual(x)
    return KSPResult(x=x, its=its, reason=reason, rnorm=rnorm,
                     history=history)


# ---------------------------------------------------------------------------
# General operators: BiCGStab, BiCGStab(l), CGS, TFQMR, GCR
# ---------------------------------------------------------------------------

def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None,
             pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
             atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
             axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned BiCGStab (van der Vorst), PETSc KSPBCGS/KSPFBCGS as in
    the JAX package: the PC is applied afresh to p and s every iteration
    and the solution is updated with the preconditioned vectors; the
    monitored residual is the true residual.  The scalars stay on the
    device; the residual norm and |rho| come to the host once per
    iteration for the convergence and breakdown tests."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    history = _history(maxit, dtype)
    r = b if x0_zero else b - matvec(x)
    rtilde = r
    rnorm = float(norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    while reason == CONVERGED_ITERATING:
        rho_new = dot(rtilde, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = psolve(p)
        v = matvec(phat)
        alpha = rho_new / _safe(dot(rtilde, v))
        sr = r - alpha * v
        shat = psolve(sr)
        t = matvec(shat)
        tt, ts = dots(((t, t), (t, sr)))
        omega = ts / _safe(tt)
        x = x + alpha * phat + omega * shat
        r = sr - omega * t
        rho = rho_new
        rn, rho_abs = _host(norm(r), rho_new.abs())
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its), rho_abs < tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def bcgsl(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          pc_apply: Optional[Callable] = None, *, ell: int = 2,
          rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
          maxit: int = 10000,
          axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """BiCGStab(ell) (Sleijpen-Fokkema; PETSc KSPBCGSL, default ell = 2):
    each cycle runs ell BiCG steps, then an ell-dimensional minimal-residual
    update.  The PC is right-folded (B = A M^-1, x = x0 + M^-1 y), so the
    monitored norm is the true residual, recorded once a cycle at index
    ``its`` (its advances by ell a cycle; the entries between stay NaN).  A
    step whose residual ends the solve ends the cycle there, as the JAX
    gate does."""
    dot, norm, dots = _reducers(axis_name)
    if ell < 1:
        raise ValueError(f"bcgsl requires ell >= 1, got {ell}")
    L = int(ell)
    psolve = pc_apply or _identity_pc

    def bmv(v):
        return matvec(psolve(v))

    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r0 = b if x0 is None else b - matvec(x0)
    rt = r0
    history = _history(maxit, dtype)
    rnorm0 = float(norm(r0))
    history[0] = rnorm0
    reason = check(rnorm0, 0)
    R = [r0] + [torch.zeros_like(b) for _ in range(L)]
    U = [torch.zeros_like(b) for _ in range(L + 1)]
    y = torch.zeros_like(b)
    rho0 = torch.ones((), dtype=dtype, device=b.device)
    alpha = torch.zeros((), dtype=dtype, device=b.device)
    omega = torch.ones((), dtype=dtype, device=b.device)
    its = 0
    while reason == CONVERGED_ITERATING:
        rho0 = -omega * rho0
        live = True
        # ---- BiCG part: ell shadow steps --------------------------------
        for j in range(L):
            rho1 = dot(rt, R[j])
            beta = alpha * rho1 / _safe(rho0)
            Un = [R[i] - beta * U[i] for i in range(j + 1)] + U[j + 1:]
            Un[j + 1] = bmv(Un[j])
            gamma = dot(rt, Un[j + 1])
            alpha = rho1 / _safe(gamma)
            Rn = [R[i] - alpha * Un[i + 1] for i in range(j + 1)] + R[j + 1:]
            Rn[j + 1] = bmv(Rn[j])
            y = y + alpha * Un[0]
            rn, rho_abs, gamma_abs = _host(norm(Rn[0]), rho0.abs(),
                                           gamma.abs())
            U, R, rho0 = Un, Rn, rho1
            its += 1
            reason = _breakdown(check(rn, its),
                                rho_abs < tiny or gamma_abs < tiny)
            if reason != CONVERGED_ITERATING:
                live = False
                break
        if live:
            # ---- MR part: minimize ||r_0 - sum gamma_j r_j|| by modified
            # Gram-Schmidt on r_1..r_ell (ell is tiny) ---------------------
            Rm = list(R)
            tau = [[None] * (L + 1) for _ in range(L + 1)]
            sigma = [None] * (L + 1)
            gp = [None] * (L + 1)                      # gamma'
            for j in range(1, L + 1):
                for i in range(1, j):
                    tau[i][j] = dot(Rm[i], Rm[j]) / _safe(sigma[i])
                    Rm[j] = Rm[j] - tau[i][j] * Rm[i]
                sigma[j] = dot(Rm[j], Rm[j])
                gp[j] = dot(Rm[j], Rm[0]) / _safe(sigma[j])
            zero = torch.zeros((), dtype=dtype, device=b.device)
            g = [None] * (L + 1)
            g[L] = gp[L]
            for j in range(L - 1, 0, -1):
                g[j] = gp[j] - sum((tau[j][i] * g[i]
                                    for i in range(j + 1, L + 1)), zero)
            gpp = [None] * L
            for j in range(1, L):
                gpp[j] = g[j + 1] + sum((tau[j][i] * g[i + 1]
                                         for i in range(j + 1, L)), zero)
            # ---- polynomial update ----------------------------------------
            y = y + g[1] * Rm[0]
            Rn = list(Rm)
            Rn[0] = Rm[0] - gp[L] * Rm[L]
            U = list(U)
            U[0] = U[0] - g[L] * U[L]
            for j in range(1, L):
                U[0] = U[0] - g[j] * U[j]
                y = y + gpp[j] * Rn[j]
                Rn[0] = Rn[0] - gp[j] * Rn[j]
            R = Rn
            omega = g[L]
            rn, sigma_min = _host(norm(R[0]),
                                  torch.stack(sigma[1:]).abs().min())
            reason = _breakdown(check(rn, its), sigma_min < tiny)
        history[min(its, maxit)] = rn
    x = psolve(y) if x0 is None else x0 + psolve(y)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def cgs(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
        atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
        axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Conjugate Gradients Squared (Sonneveld; PETSc KSPCGS): transpose-free
    BiCG with the polynomial squared, two matvecs an iteration.  The PC is
    right-folded (B = A M^-1, x = x0 + M^-1 y), so the monitored history is
    the true residual of the original system."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc

    def bmv(v):
        return matvec(psolve(v))

    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r = b if x0 is None else b - matvec(x0)
    rt0 = r
    rho = dot(rt0, r)
    history = _history(maxit, dtype)
    rnorm0, rho_abs = _host(norm(r), rho.abs())
    history[0] = rnorm0
    its = 0
    reason = _breakdown(check(rnorm0, its), rho_abs < tiny)
    y = torch.zeros_like(b)
    u = p = r
    while reason == CONVERGED_ITERATING:
        v = bmv(p)
        sigma = dot(rt0, v)
        alpha = rho / _safe(sigma)
        q = u - alpha * v
        uq = u + q
        y = y + alpha * uq
        r = r - alpha * bmv(uq)
        rho_new, rr = dots(((rt0, r), (r, r)))
        beta = rho_new / _safe(rho)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        rho = rho_new
        rn, sigma_abs, rho_abs = _host(torch.sqrt(rr.real), sigma.abs(),
                                       rho_new.abs())
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its),
                            sigma_abs < tiny or rho_abs < tiny)
    x = psolve(y) if x0 is None else x0 + psolve(y)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def tfqmr(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
          atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
          axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Transpose-Free QMR (Freund; PETSc KSPTFQMR): CGS's search space with
    quasi-minimal-residual smoothing, two matvecs an iteration.  The PC is
    right-folded as in ``cgs``; the monitored history is Freund's bound
    tau sqrt(2k + 1) (what PETSc's monitor shows), and ``rnorm`` the true
    final residual."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc

    def bmv(v):
        return matvec(psolve(v))

    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r0 = b if x0 is None else b - matvec(x0)
    rt0 = r0
    tau = norm(r0)
    rho = dot(rt0, r0)
    v = uhat = bmv(r0)
    history = _history(maxit, dtype)
    tau0, rho_abs = _host(tau, rho.abs())
    history[0] = tau0
    its = 0
    reason = _breakdown(check(tau0, its), rho_abs < tiny)

    def half(ym, Aym, w, tau, theta, eta, d, yacc, alpha):
        """One QMR half-step: residual update, smoothing, solution step."""
        w1 = w - alpha * Aym
        theta1 = norm(w1) / torch.clamp(tau, min=tiny)
        c1 = 1.0 / torch.sqrt(1.0 + theta1 ** 2)
        tau1 = tau * theta1 * c1
        eta1 = (c1 ** 2) * alpha
        sa = torch.where(alpha.abs() > tiny, alpha, torch.ones_like(alpha))
        d1 = ym + ((theta ** 2) * eta / sa) * d
        return w1, tau1, theta1, eta1, d1, yacc + eta1 * d1

    yacc = d = torch.zeros_like(b)
    w = y1 = r0
    theta = torch.zeros((), dtype=dtype.to_real(), device=b.device)
    eta = torch.zeros((), dtype=dtype, device=b.device)
    while reason == CONVERGED_ITERATING:
        sigma = dot(rt0, v)
        alpha = rho / _safe(sigma)
        y2 = y1 - alpha * v
        By2 = bmv(y2)
        # half-step m = 2k-1 uses B y1 (uhat), not the direction v
        w, tau, theta, eta, d, yacc = half(y1, uhat, w, tau, theta, eta, d,
                                           yacc, alpha)
        w, tau, theta, eta, d, yacc = half(y2, By2, w, tau, theta, eta, d,
                                           yacc, alpha)
        rho_new = dot(rt0, w)
        beta = rho_new / _safe(rho)
        y1 = w + beta * y2
        uhat = bmv(y1)
        v = uhat + beta * (By2 + beta * v)
        rho = rho_new
        its += 1
        # Freund's bound ||r_m|| <= tau_m sqrt(m + 1) at m = 2k
        rn, sigma_abs, rho_abs = _host(
            tau * math.sqrt(2.0 * its + 1.0), sigma.abs(), rho_new.abs())
        history[its] = rn
        reason = _breakdown(check(rn, its),
                            sigma_abs < tiny or rho_abs < tiny)
    x = psolve(yacc) if x0 is None else x0 + psolve(yacc)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def gcr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        pc_apply: Optional[Callable] = None, *, restart: int = 30,
        rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
        maxit: int = 10000,
        axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Generalized Conjugate Residuals with restarts (PETSc KSPGCR): takes
    a PC that changes between iterations, and updates x and the true
    residual every iteration.  Stores ``restart`` directions p and A p
    (cleared at each restart boundary); the monitored norm comes from
    ``||r'||^2 = ||r||^2 - <Ap, r>^2 / ||Ap||^2`` with ||r|| measured fresh
    each iteration."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r = b if x0_zero else b - matvec(x)
    history = _history(maxit, dtype)
    rnorm0 = float(norm(r))
    history[0] = rnorm0
    its = 0
    reason = check(rnorm0, its)
    m = max(1, int(restart))
    P = torch.zeros((m,) + tuple(b.shape), dtype=dtype, device=b.device)
    AP = torch.zeros_like(P)
    while reason == CONVERGED_ITERATING:
        slot = its % m
        if slot == 0:                      # restart boundary: drop them
            P.zero_()
            AP.zero_()
        p = psolve(r)
        Ap = matvec(p)
        beta = _gram(AP, Ap, axis_name)    # empty slots give 0
        p = p - beta @ P
        Ap = Ap - beta @ AP
        nn, ar, rr = dots(((Ap, Ap), (Ap, r), (r, r)))
        nrm = torch.sqrt(nn.real)
        safe = _safe(nrm)
        p = p / safe
        Ap = Ap / safe
        alpha = ar / _safe(nn) * safe
        x = x + alpha * p
        r = r - alpha * Ap
        P[slot] = p
        AP[slot] = Ap
        rn_t = torch.sqrt(torch.clamp(rr.real - ar.abs() ** 2
                                      / _safe(nn).real, min=0.0))
        rn, nrm_h = _host(rn_t, nrm)
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its), nrm_h <= 1e3 * tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


# ---------------------------------------------------------------------------
# Symmetric operators: CG, pipelined CG, CR, MINRES, SYMMLQ
# ---------------------------------------------------------------------------

def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
       atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
       axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned conjugate gradients (SPD operator and PC).  The
    monitored residual is the unpreconditioned ||r||, which comes to the
    host once per iteration for the convergence test; <r, z>, alpha and
    beta stay on the device."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    history = _history(maxit, b.dtype)
    r = b if x0_zero else b - matvec(x)
    p = psolve(r)
    rz = dot(r, p)
    rnorm = float(norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    while reason == CONVERGED_ITERATING:
        w = matvec(p)
        alpha = rz / _safe(dot(p, w))
        x = x + alpha * p
        r = r - alpha * w
        z = psolve(r)
        rz_new, rr = dots(((r, z), (r, r)))
        beta = rz_new / _safe(rz)
        p = z + beta * p
        rz = rz_new
        rn = float(torch.sqrt(rr.real))
        its += 1
        history[its] = rn
        reason = check(rn, its)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def pipecg(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Pipelined conjugate gradients (Ghysels-Vanroose; PETSc KSPPIPECG):
    CG in exact arithmetic, restructured so that an iteration's three inner
    products do not wait on its PC apply and matvec (the next stage's
    m = M^-1 w and n = A m), carrying s = A p, q = M^-1 A p and
    z = A M^-1 A p beside p.  SPD operator and PC."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r = b if x0_zero else b - matvec(x)
    u = psolve(r)
    w = matvec(u)
    gamma, delta, rr = dots(((r, u), (w, u), (r, r)))
    history = _history(maxit, dtype)
    rnorm0 = float(torch.sqrt(rr.real))
    history[0] = rnorm0
    its = 0
    reason = check(rnorm0, its)
    m = psolve(w)
    n = matvec(m)
    z = q = s = p = torch.zeros_like(b)
    gamma_p = alpha_p = None
    while reason == CONVERGED_ITERATING:
        if its == 0:
            beta = torch.zeros((), dtype=dtype, device=b.device)
            denom = delta
        else:
            beta = gamma / _safe(gamma_p)
            denom = delta - beta * gamma / _safe(alpha_p)
        alpha = gamma / _safe(denom)
        z = n + beta * z
        q = m + beta * q
        s = w + beta * s
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        gamma_p, alpha_p = gamma, alpha
        gamma, delta, rr = dots(((r, u), (w, u), (r, r)))
        m = psolve(w)
        n = matvec(m)
        rn, denom_abs = _host(torch.sqrt(rr.real), denom.abs())
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its), denom_abs < tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def cr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
       atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
       axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned Conjugate Residuals (PETSc KSPCR) for symmetric
    operators with an SPD PC: minimizes ``||b - A x||_{M^-1}`` with CG's
    short recurrences, one matvec and one PC apply an iteration; zero
    curvature ``<w, M^-1 w>`` reports DIVERGED_BREAKDOWN."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = _tiny(dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    r = b if x0_zero else b - matvec(x)
    z = p = psolve(r)
    w = matvec(z)
    rho = dot(z, w)
    history = _history(maxit, dtype)
    rnorm0 = float(norm(r))
    history[0] = rnorm0
    its = 0
    reason = check(rnorm0, its)
    while reason == CONVERGED_ITERATING:
        q = psolve(w)                      # M^-1 A p
        wq = dot(w, q)
        alpha = rho / _safe(wq)
        x = x + alpha * p
        r = r - alpha * w
        z = z - alpha * q
        Az = matvec(z)
        rho_new, rr = dots(((z, Az), (r, r)))
        beta = rho_new / _safe(rho)
        p = z + beta * p
        w = Az + beta * w                  # A p by recurrence
        rho = rho_new
        rn, wq_abs = _host(torch.sqrt(rr.real), wq.abs())
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its), wq_abs < tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def minres(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned MINRES (Paige-Saunders; PETSc KSPMINRES) for
    symmetric, possibly indefinite operators with an SPD PC: the Lanczos
    recurrence with a Givens QR of the tridiagonal.  The monitored norm is
    the preconditioned residual ||r||_{M^-1} (the phibar recurrence),
    tested against ||b||_{M^-1}; ``rnorm`` is the true final residual.  A
    negative beta^2 (an indefinite PC) or a Lanczos breakdown reports
    DIVERGED_BREAKDOWN, whatever the convergence test says."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    dtype = b.dtype
    tiny = _tiny(dtype)
    rdtype = dtype.to_real()
    r1 = b if x0_zero else b - matvec(x)
    y = psolve(r1)
    beta1_sq = dot(r1, y).real
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    bnorm_t = torch.sqrt(torch.clamp(dot(b, psolve(b)).real, min=0))
    beta1_h, bnorm, beta1_sq_h = _host(beta1, bnorm_t, beta1_sq)
    check = _checker(bnorm, rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
    history = _history(maxit, dtype)
    history[0] = beta1_h
    its = 0
    reason = (DIVERGED_BREAKDOWN if beta1_sq_h < 0
              else check(beta1_h, its))
    zero = torch.zeros((), dtype=rdtype, device=b.device)
    r2 = r1
    w = w2 = torch.zeros_like(b)
    beta, oldb, dbar, epsln, sn = beta1, zero, zero, zero, zero
    cs = -torch.ones((), dtype=rdtype, device=b.device)
    phibar = beta1
    while reason == CONVERGED_ITERATING:
        ibeta = 1.0 / _safe(beta)
        v = y * ibeta
        y = matvec(v)
        if its >= 1:
            y = y - (beta / _safe(oldb)) * r1
        alfa = dot(v, y).real
        y = y - (alfa * ibeta) * r2
        r1, r2 = r2, y
        y = psolve(r2)
        beta_sq = dot(r2, y).real
        oldb, beta = beta, torch.sqrt(torch.clamp(beta_sq, min=0))
        # Givens QR of the Lanczos tridiagonal, one column an iteration
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.sqrt(gbar * gbar + beta * beta)
        lanczos_break = gamma < tiny
        gamma = torch.where(lanczos_break, torch.ones_like(gamma), gamma)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        rn, bsq, broke = _host(phibar, beta_sq, lanczos_break.to(rdtype))
        its += 1
        history[its] = rn
        reason = check(rn, its)
        if bsq < 0 or broke:
            reason = DIVERGED_BREAKDOWN
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def symmlq(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """SYMMLQ (Paige-Saunders; PETSc KSPSYMMLQ) for symmetric, possibly
    indefinite operators with an SPD PC: an LQ factorization of the Lanczos
    tridiagonal, iterates minimizing the error norm.  Convergence is tested
    on the residual of the transferred CG point (symmlq.m's ``cgnorm``)
    against ||r0||_{M^-1}, and the solution takes the CG-point transfer
    step at the end.  A negative beta^2 reports DIVERGED_BREAKDOWN."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x00 = torch.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    tiny = _tiny(dtype)
    rdtype = dtype.to_real()
    # the x0 = 0 problem A dx = r0 (SYMMLQ's natural form)
    r0 = b - matvec(x00)
    y0 = psolve(r0)
    beta1_sq = dot(r0, y0).real
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    sfe = torch.where(beta1 > 0, beta1, torch.ones_like(beta1))
    v1 = y0 / sfe
    yA = matvec(v1)
    alfa0 = dot(v1, yA).real
    r2 = yA - (alfa0 / sfe) * r0
    y = psolve(r2)
    beta_sq0 = dot(r2, y).real
    beta = torch.sqrt(torch.clamp(beta_sq0, min=0))
    beta1_h, b1sq, b0sq = _host(beta1, beta1_sq, beta_sq0)
    check = _checker(beta1_h, rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    history = _history(maxit, dtype)
    history[0] = beta1_h
    its = 0
    reason = (DIVERGED_BREAKDOWN if b1sq < 0 or b0sq < 0
              else check(beta1_h, its))
    x = torch.zeros_like(b)
    w = torch.zeros_like(b)
    r1 = r0
    oldb, gbar, dbar, rhs1 = beta1, alfa0, beta, beta1
    rhs2 = bstep = torch.zeros((), dtype=rdtype, device=b.device)
    snprod = torch.ones((), dtype=rdtype, device=b.device)
    while reason == CONVERGED_ITERATING:
        ibeta = 1.0 / torch.where(beta > 0, beta, torch.ones_like(beta))
        v = y * ibeta
        y = matvec(v)
        y = y - (beta / _safe(oldb)) * r1
        alfa = dot(v, y).real
        y = y - (alfa * ibeta) * r2
        r1, r2 = r2, y
        y = psolve(r2)
        oldb = beta
        beta_sq = dot(r2, y).real
        beta = torch.sqrt(torch.clamp(beta_sq, min=0))
        # LQ factorization: the previous rotation folds into this column
        gamma = torch.clamp(torch.sqrt(gbar ** 2 + oldb ** 2), min=tiny)
        cs = gbar / gamma
        sn = oldb / gamma
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        # LQ-point update
        z = rhs1 / gamma
        x = x + (z * cs) * w + (z * sn) * v
        w = sn * w - cs * v
        rhs1 = rhs2 - delta * z
        rhs2 = -epsln * z
        # the component along M^-1 r0 accumulates apart (symmlq.m's
        # bstep, added after the loop); the CG point's residual norm
        # drives convergence
        bstep = snprod * cs * z + bstep
        snprod = snprod * sn
        diag = torch.where(gbar.abs() > 0, gbar.abs(),
                           torch.full_like(gbar, tiny))
        cgnorm = snprod * beta1 * beta / diag
        rn, bsq = _host(cgnorm, beta_sq)
        its += 1
        history[its] = rn
        reason = check(rn, its)
        if bsq < 0:
            reason = DIVERGED_BREAKDOWN
    if its > 0:
        # the LQ point to the CG point: a last step along w and the
        # accumulated component along M^-1 r0
        denom = torch.where(gbar.abs() > tiny, gbar,
                            torch.full_like(gbar, tiny))
        zbar = rhs1 / denom
        x = x + zbar * w + ((snprod * zbar + bstep) / sfe) * y0
    return _result(matvec, b, x00 + x, its, reason, history, axis=axis_name)


# ---------------------------------------------------------------------------
# Chebyshev, Richardson, preonly
# ---------------------------------------------------------------------------

def chebyshev(matvec: Callable, b: torch.Tensor,
              x0: Optional[torch.Tensor] = None,
              pc_apply: Optional[Callable] = None, *, emin: float = 0.1,
              emax: float = 1.1, rtol: float = 1e-5, atol: float = 1e-50,
              divtol: float = 1e4, maxit: int = 10000,
              axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Chebyshev semi-iteration over the preconditioned spectrum interval
    [emin, emax] (PETSc KSPCHEBYSHEV): no inner products in the iteration;
    the residual norm comes to the host once an iteration for the
    convergence test."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma1 = theta / delta if delta != 0 else 0.0
    r = b if x0_zero else b - matvec(x)
    history = _history(maxit, b.dtype)
    rnorm0 = float(norm(r))
    history[0] = rnorm0
    its = 0
    reason = check(rnorm0, its)
    p = torch.zeros_like(b)
    rho = torch.zeros((), dtype=b.dtype, device=b.device)
    while reason == CONVERGED_ITERATING:
        z = psolve(r)
        if its == 0:
            rho_new = torch.full_like(rho, 1.0 / sigma1)
            p = z / theta
        else:
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            p = (rho_new * rho) * p + (2.0 * rho_new / delta) * z
        rho = rho_new
        x = x + p
        r = r - matvec(p)
        rn = float(norm(r))
        its += 1
        history[its] = rn
        reason = check(rn, its)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def richardson(matvec: Callable, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None,
               pc_apply: Optional[Callable] = None, *, scale: float = 1.0,
               rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
               maxit: int = 10000,
               axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned Richardson iteration x += scale * M^{-1} r; with a
    (possibly lower-precision) factorization PC this is stationary
    iterative refinement.  The monitored residual is the true ||b - A x||,
    recomputed every iteration, and comes to the host once per iteration
    for the convergence test."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    history = _history(maxit, b.dtype)
    r = b if x0_zero else b - matvec(x)
    rnorm = float(norm(r))
    history[0] = rnorm
    its = 0
    reason = check(rnorm, its)
    while reason == CONVERGED_ITERATING:
        x = x + scale * psolve(r)
        r = b - matvec(x)
        rn = float(norm(r))
        its += 1
        history[its] = rn
        reason = check(rn, its)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def preonly(matvec: Callable, b: torch.Tensor,
            x0: Optional[torch.Tensor] = None,
            pc_apply: Optional[Callable] = None,
            axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """One preconditioner application (PETSc KSPPREONLY): with a direct
    factorization PC this is the direct solve.  The reason is
    CONVERGED_ITS unless the residual is non-finite (DIVERGED_NANORINF);
    the history is ``[||b||, ||b - A x||]`` whatever the caller's maxit."""
    dot, norm, dots = _reducers(axis_name)
    psolve = pc_apply or _identity_pc
    x = psolve(b) if x0 is None else x0 + psolve(b - matvec(x0))
    rn, bn = _host(norm(b - matvec(x)), norm(b))
    history = torch.tensor([bn, rn], dtype=b.dtype.to_real())
    reason = CONVERGED_ITS if math.isfinite(rn) else DIVERGED_NANORINF
    return KSPResult(x=x, its=1, reason=reason, rnorm=rn, history=history)


# ---------------------------------------------------------------------------
# The types that iterate on A^T: BiCG and the normal-equations family
# (PETSc KSPBICG, KSPCGNE, KSPLSQR)
# ---------------------------------------------------------------------------

def bicg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000,
         axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Preconditioned BiConjugate Gradients (PETSc KSPBICG): the shadow
    recurrence runs on A^H and M^-H, conjugations of the pure transposes
    ``matvec_transpose`` and ``pc_apply_transpose``.  The monitored
    residual is the true residual; it comes to the host once per iteration
    with the breakdown tests' |<pt, A p>| and |rho|."""
    dot, norm, dots = _reducers(axis_name)
    _need_transpose("bicg", matvec_transpose)
    psolve = pc_apply or _identity_pc
    mv_h = _hermitian(matvec_transpose)
    ps_h = _hermitian(pc_apply_transpose) or _identity_pc
    x0_zero = x0 is None                   # r0 = b exactly; skip matvec(0)
    x = torch.zeros_like(b) if x0_zero else x0.clone()
    tiny = _tiny(b.dtype)
    check = _checker(float(norm(b)), rtol=rtol, atol=atol, divtol=divtol,
                     maxit=maxit)
    history = _history(maxit, b.dtype)
    r = b if x0_zero else b - matvec(x)
    rt = r
    p, pt = psolve(r), ps_h(rt)
    rho = dot(rt, p)
    rnorm0, rho_abs = _host(norm(r), rho.abs())
    history[0] = rnorm0
    its = 0
    reason = _breakdown(check(rnorm0, its), rho_abs < tiny)
    while reason == CONVERGED_ITERATING:
        q, qt = matvec(p), mv_h(pt)
        denom = dot(pt, q)
        alpha = rho / _safe(denom)
        x = x + alpha * p
        r = r - alpha * q
        rt = rt - alpha.conj() * qt
        z, zt = psolve(r), ps_h(rt)
        rho_new, rr = dots(((rt, z), (r, r)))
        beta = rho_new / _safe(rho)
        p = z + beta * p
        pt = zt + beta.conj() * pt
        rho = rho_new
        rn, denom_abs, rho_abs = _host(torch.sqrt(rr.real), denom.abs(),
                                       rho_new.abs())
        its += 1
        history[its] = rn
        reason = _breakdown(check(rn, its),
                            denom_abs < tiny or rho_abs < tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def cgnr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000,
         axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """CG on the normal equations in CGLS form (PETSc KSPCGNE; registered
    as ``cgne``, ``cgnr`` and ``cgls``): minimizes ||M^-1 (b - A x)|| with
    B = M^-1 A, carrying the least-squares residual s = M^-1 (b - A x) and
    the normal residual r = B^T s apart, A^T A never formed.  x and b may
    differ in length (a rectangular least-squares problem through
    callables).  The monitored history is ||s||; CONVERGED_RTOL_NORMAL is
    reported once ||B^T s|| <= rtol ||B^T M^-1 b|| (the normal-equations
    test, where ||s|| stalls at the least-squares optimum)."""
    dot, norm, dots = _reducers(axis_name)
    _need_transpose("cgnr/cgne", matvec_transpose)
    psolve = pc_apply or _identity_pc
    mv_h = _hermitian(matvec_transpose)
    ps_h = _hermitian(pc_apply_transpose) or _identity_pc

    def bmv(v):                            # B = M^-1 A
        return psolve(matvec(v))

    def bmv_t(v):                          # B^H = A^H M^-H
        return mv_h(ps_h(v))

    tiny = _tiny(b.dtype)
    c = psolve(b)
    bt = bmv_t(c)                          # also fixes x's length
    if x0 is None:
        x = torch.zeros_like(bt)
        s, r = c, bt
    else:
        x = x0.clone()
        s = psolve(b - matvec(x0))
        r = bmv_t(s)
    gamma = dot(r, r).real
    bnorm, ntnorm0, rnorm0, gamma_h = _host(norm(c), norm(bt), norm(s),
                                            gamma)
    check = _checker(bnorm, rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
    history = _history(maxit, b.dtype)
    history[0] = rnorm0
    its = 0

    def normal_test(reason, gamma_h):
        if reason == CONVERGED_ITERATING and \
                math.sqrt(gamma_h) <= rtol * ntnorm0:
            return CONVERGED_RTOL_NORMAL
        return reason

    # x0 may already sit at the normal-equations optimum
    reason = normal_test(check(rnorm0, its), gamma_h)
    p = r
    while reason == CONVERGED_ITERATING:
        q = bmv(p)
        qq = dot(q, q).real
        alpha = gamma / _safe(qq)
        x = x + alpha * p
        s = s - alpha * q
        r = bmv_t(s)
        gamma_new, ss = dots(((r, r), (s, s)))
        gamma_new = gamma_new.real
        beta = gamma_new / _safe(gamma)
        p = r + beta * p
        gamma = gamma_new
        rn, qq_h, gamma_h = _host(torch.sqrt(ss.real), qq, gamma_new)
        its += 1
        history[its] = rn
        reason = _breakdown(normal_test(check(rn, its), gamma_h),
                            qq_h < tiny)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


def lsqr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000,
         axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """LSQR (Paige-Saunders Golub-Kahan bidiagonalization; PETSc KSPLSQR):
    min ||b - A x|| for square or rectangular A, right-preconditioned
    (B = A M^-1, x = x0 + M^-1 y).  The monitored history is the residual
    estimate phibar; CONVERGED_RTOL_NORMAL fires on the Paige-Saunders
    test ||B^T r|| = phibar alpha |c| <= rtol ||B||_F-est ||r||, or when the
    bidiagonalization terminates (alpha or beta below tiny).  The scalar
    recurrences run on the device in the vectors' dtype; phibar and the
    test's terms come to the host once per iteration."""
    dot, norm, dots = _reducers(axis_name)
    _need_transpose("lsqr", matvec_transpose)
    psolve = pc_apply or _identity_pc
    mv_h = _hermitian(matvec_transpose)
    ps_h = _hermitian(pc_apply_transpose) or _identity_pc

    def bmv(v):                            # B = A M^-1
        return matvec(psolve(v))

    def bmv_t(u):                          # B^H = M^-H A^H
        return ps_h(mv_h(u))

    tiny = _tiny(b.dtype)
    r0 = b if x0 is None else b - matvec(x0)
    beta0 = norm(r0)
    u = r0 / _safe(beta0)
    v_un = bmv_t(u)
    alpha = norm(v_un)
    v = v_un / _safe(alpha)
    bnorm, beta0_h, alpha0_h = _host(norm(b), beta0, alpha)
    check = _checker(bnorm, rtol=rtol, atol=atol, divtol=divtol, maxit=maxit)
    history = _history(maxit, b.dtype)
    history[0] = beta0_h
    its = 0
    reason = check(beta0_h, its)
    if reason == CONVERGED_ITERATING and alpha0_h <= tiny:
        reason = CONVERGED_RTOL_NORMAL
    y, w = torch.zeros_like(v), v
    rhobar, phibar, anorm2 = alpha, beta0, alpha ** 2
    while reason == CONVERGED_ITERATING:
        u_un = bmv(v) - alpha * u
        beta = norm(u_un)
        u = u_un / _safe(beta)
        v_un = bmv_t(u) - beta * v
        alpha = norm(v_un)
        v = v_un / _safe(alpha)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        cs = rhobar / _safe(rho)
        sn = beta / _safe(rho)
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        y = y + (phi / _safe(rho)) * w
        w = v - (theta / _safe(rho)) * w
        anorm2 = anorm2 + alpha ** 2 + beta ** 2
        normal_rn = phibar * alpha * cs.abs()
        limit = rtol * torch.sqrt(anorm2) * torch.clamp(phibar, min=tiny)
        rn, normal_h, limit_h, alpha_h, beta_h = _host(
            phibar, normal_rn, limit, alpha, beta)
        its += 1
        history[its] = rn
        reason = check(rn, its)
        # Paige-Saunders stopping rule 2, then a terminated
        # bidiagonalization: the (least-squares) optimum of the space
        if reason == CONVERGED_ITERATING and (
                normal_h <= limit_h or alpha_h <= tiny or beta_h <= tiny):
            reason = CONVERGED_RTOL_NORMAL
    x = psolve(y) if x0 is None else x0 + psolve(y)
    return _result(matvec, b, x, its, reason, history, axis=axis_name)


for _name, _fn in (("gmres", gmres), ("fgmres", fgmres), ("lgmres", lgmres),
                   ("bcgs", bicgstab), ("fbcgs", bicgstab),
                   ("bicgstab", bicgstab), ("bcgsl", bcgsl), ("cgs", cgs),
                   ("tfqmr", tfqmr), ("gcr", gcr), ("cg", cg),
                   ("pipecg", pipecg), ("cr", cr), ("minres", minres),
                   ("symmlq", symmlq), ("chebyshev", chebyshev),
                   ("richardson", richardson), ("preonly", preonly),
                   ("bicg", bicg), ("cgne", cgnr), ("cgnr", cgnr),
                   ("cgls", cgnr), ("lsqr", lsqr)):
    register_ksp(_name, _fn)

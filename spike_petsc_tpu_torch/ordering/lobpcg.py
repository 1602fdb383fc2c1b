"""LOBPCG for the top-k standard eigenpairs, on torch tensors.

The port's own copy of ``jax.experimental.sparse.linalg.lobpcg_standard``
(the callable form, ``_lobpcg_standard_callable`` and its helpers
``_svqb``, ``_project_out``, ``_orthonormalize``, ``_rayleigh_ritz_orth``
and ``_extend_basis``), which the JAX package's Fiedler ordering drives on
the accelerator.  The same iteration, basis truncation and convergence
test, so that the eigenpairs and the iteration count match JAX's on the
same operator and start; eigenvectors match up to sign (``eigh`` fixes no
sign).  The loop runs on the host: one device sync an iteration, for the
convergence count.

``torch.lobpcg`` is not used: it takes a matrix, not a callable, has no
way to deflate a known eigenvector (the constant vector of a graph
Laplacian), and iterates otherwise.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The top-k eigenpairs of the Hermitian operator ``A`` ([n, k] ->
    [n, k]) from the start ``X`` ([n, k], linearly independent, k * 5 < n),
    in at most ``m`` iterations.  An eigenpair (lambda, v) has converged
    when ``|A v - lambda v| < tol * 10 * n * (lambda + |A v|)``; ``tol``
    defaults to the dtype's epsilon.  Returns ``(theta [k], U [n, k],
    iterations)``."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i, converged = 0, 0
    while i < m and converged < k:
        # invariants: X, P, R orthonormal; R and P columns may be zero
        # (basis truncation), X's never
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)

        # the difference directions: concat(0, Q[k:, :k]) orthogonalized
        # against Q[:, :k] in the standard basis, then mapped by XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.vector_norm(R, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were "
                         f"{test_output.dtype}, {X.dtype})")
    if tuple(test_output.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output "
                         f"{tuple(test_output.shape)}")


def _eigh_descending(A):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """A truncated orthonormal basis of ``X`` (SVQB): the eigenbasis of
    X^T X after column normalization; directions whose eigenvalue is below
    eps times the largest are zeroed."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.vector_norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _project_out(basis, U):
    """The component of ``U`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``, its nonzero columns orthonormal: subtract and
    orthonormalize twice, subtract twice more, and zero every column whose
    norm fell below 0.99."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S):
    """The eigenpairs of ``A`` projected on the orthonormal ``S``,
    eigenvalues in descending order."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X, m: int):
    """``m`` directions orthonormal to the orthonormal [n, k] ``X`` and to
    each other, from a block Householder reflector (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h

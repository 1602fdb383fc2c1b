"""Null spaces of singular consistent systems (PETSc MatNullSpace), PyTorch.

The port of ``spike_petsc_tpu.solvers.nullspace``.  A Krylov solve of a
singular system needs two projections:

* consistency: the components of b along the LEFT null space (the null
  space of A^T) are removed, or no solution exists;
* uniqueness: the solution is defined up to the null space of A, and
  projecting it picks the minimal-norm representative.

``make_solver(nullspace=..., transpose_nullspace=...)`` (or
``-ksp_nullspace_constant`` for the constant vector) projects b by the
transpose null space (by default the null space itself, the symmetric
case), every matvec output by the transpose null space, every PC output and
the returned x by the null space.  ``remove`` is two skinny products
(``[n, m]`` with m tiny) on the vectors' device, in double precision.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class NullSpace:
    """An orthonormal basis of a (tiny) null space.

    ``vecs``: ``[n, m]`` with orthonormal columns (m = dimension, typically
    1).  ``constant``: True when the basis holds the normalized constant
    vector (PETSc's ``has_cnst``)."""

    vecs: torch.Tensor
    constant: bool = False

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    def remove(self, v: torch.Tensor) -> torch.Tensor:
        """Project the null-space components out of ``v`` (``[n]`` or
        ``[n, r]``): MatNullSpaceRemove.

        The projection runs in double precision and rounds once at the
        end.  A preconditioner of a singular operator multiplies whatever
        null component a residual keeps by ~1/eps (the exactly singular
        reduced system of a partitioned Neumann Laplacian: |S^-1| ~ 2.4e6 in
        f32), so the remnant matters.  The f32 inner product of
        ``torch.matmul`` on the CPU left ~4x the remnant of XLA's on the
        same vectors, and f32 CG ran to maxit on 6 of 20 right-hand sides
        that JAX solved (``tests/test_torch_nullspace.py``)."""
        acc = torch.complex128 if v.is_complex() else torch.float64
        q = self.vecs.to(device=v.device, dtype=acc)
        w = v.to(acc)
        return (w - q @ (q.conj().T @ w)).to(v.dtype)


def make_nullspace(n: Optional[int] = None, *, constant: bool = False,
                   vecs=None, dtype=None, device=None) -> NullSpace:
    """Build an orthonormal NullSpace (MatNullSpaceCreate).

    ``constant=True`` includes the normalized constant vector; ``vecs``
    (a tensor or array ``[n]`` or ``[n, m]``, or a sequence of ``[n]``)
    adds user vectors, orthonormalized together with the constant by QR.
    The columns must be linearly independent, as PETSc requires.  The
    basis lies on ``device`` (default: that of ``vecs``, else the card) in
    ``dtype`` (default: that of ``vecs``, else float32)."""
    cols = []
    if vecs is not None:
        if isinstance(vecs, (list, tuple)):
            v = torch.stack([torch.as_tensor(c) for c in vecs], dim=1)
        else:
            v = torch.as_tensor(vecs)
        if v.ndim == 1:
            v = v[:, None]
        elif v.ndim != 2:
            raise ValueError(f"vecs must be [n] or [n, m], got "
                             f"{tuple(v.shape)}")
        v = v.to(device=device if device is not None else v.device,
                 dtype=dtype or v.dtype)
        cols.append(v)
        n = v.shape[0] if n is None else n
        if v.shape[0] != n:
            raise ValueError(f"vecs rows {v.shape[0]} != n {n}")
    if constant:
        if n is None:
            raise ValueError("constant nullspace needs n (or vecs)")
        dt = dtype or (cols[0].dtype if cols else torch.float32)
        dev = cols[0].device if cols else torch.device(device or "cuda")
        cols.insert(0, torch.ones((n, 1), dtype=dt, device=dev)
                    / torch.sqrt(torch.tensor(float(n), dtype=dt)))
    if not cols:
        raise ValueError("empty null space: pass constant=True and/or vecs")
    V = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    if V.shape[1] == 1:
        Q = V / torch.linalg.norm(V, dim=0, keepdim=True)
    else:
        Q, _ = torch.linalg.qr(V)
    return NullSpace(vecs=Q, constant=constant)

"""Solver result type and converged-reason codes (PETSc KSPConvergedReason
values, as in ``spike_petsc_tpu.solvers.types``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

CONVERGED_ITERATING = 0
CONVERGED_RTOL_NORMAL = 1
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_ITS = 4
DIVERGED_NULL = -2
DIVERGED_ITS = -3
DIVERGED_DTOL = -4
DIVERGED_BREAKDOWN = -5
DIVERGED_NANORINF = -9

_REASON_NAMES = {
    0: "CONVERGED_ITERATING",
    1: "CONVERGED_RTOL_NORMAL",
    2: "CONVERGED_RTOL",
    3: "CONVERGED_ATOL",
    4: "CONVERGED_ITS",
    -2: "DIVERGED_NULL",
    -3: "DIVERGED_ITS",
    -4: "DIVERGED_DTOL",
    -5: "DIVERGED_BREAKDOWN",
    -9: "DIVERGED_NANORINF",
}


def reason_str(reason) -> str:
    return _REASON_NAMES.get(int(reason), f"UNKNOWN({int(reason)})")


@dataclass(frozen=True)
class KSPResult:
    """Result of a Krylov solve.

    ``history[i]`` is the monitored residual norm at iteration i
    (``history[0]`` is the initial residual); entries beyond ``its`` are
    NaN.  ``history`` is a CPU tensor of the residual's real dtype.

    A column-batched solve (``solve_many``, ``krylov_many``) gives ``x``
    ``[n, r]``; ``its``, ``reason`` and ``rnorm`` as ``[r]`` CPU tensors;
    and ``history`` ``[maxit+1, r]``, NaN beyond each column's ``its``
    (``[2, r]`` for ``preonly_many``).

    ``true_history`` holds the unpreconditioned residual norms where a
    solver records them: gmres and fgmres under ``monitor_true=True``
    (``-ksp_monitor_true_residual``), in the history's dtype and layout;
    ``None`` otherwise.
    """

    x: torch.Tensor
    its: Union[int, torch.Tensor]
    reason: Union[int, torch.Tensor]
    rnorm: Union[float, torch.Tensor]
    history: torch.Tensor
    true_history: Optional[torch.Tensor] = None

    @property
    def converged(self):
        """``reason > 0``: a bool, or a ``[r]`` bool tensor for a
        column-batched result."""
        return self.reason > 0

    def history_trimmed(self) -> torch.Tensor:
        """``history[:its + 1]``; for a column-batched result, up to the
        largest ``its`` (rows past a column's own ``its`` stay NaN)."""
        its = self.its
        if isinstance(its, torch.Tensor):
            its = int(its.max())
        return self.history[:its + 1]

    def __repr__(self):  # pragma: no cover
        if isinstance(self.its, torch.Tensor):
            return (f"KSPResult(its={self.its.tolist()}, reason="
                    f"{[reason_str(r) for r in self.reason.tolist()]}, "
                    f"rnorm max={float(self.rnorm.max()):.6e})")
        return (f"KSPResult(its={self.its}, reason={reason_str(self.reason)}, "
                f"rnorm={self.rnorm:.6e})")


def default_convergence_check(rnorm, bnorm, its, *, rtol, atol, divtol,
                              maxit) -> int:
    """PETSc KSPConvergedDefault semantics on host scalars; returns the
    reason (0 while iterating)."""
    rnorm, bnorm = float(rnorm), float(bnorm)
    if not math.isfinite(rnorm):
        return DIVERGED_NANORINF
    if rnorm <= atol:
        return CONVERGED_ATOL
    if rnorm <= rtol * bnorm:
        return CONVERGED_RTOL
    if rnorm > divtol * bnorm:
        return DIVERGED_DTOL
    if its >= maxit:
        return DIVERGED_ITS
    return CONVERGED_ITERATING

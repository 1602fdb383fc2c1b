"""Solver layer: Krylov methods (KSP), preconditioners (PC), composition."""

from .krylov import (arnoldi_hessenberg, bicgstab, cg, chebyshev,
                     estimate_extreme_eigs, fgmres, gmres, minres, pipecg,
                     preonly, richardson)
from .ksp import make_solver, make_solver_many, print_monitor, solve, solve_many
from .nullspace import NullSpace, make_nullspace
from .pc import PC, make_pc
from .types import KSPResult, reason_str

__all__ = ["solve", "make_solver", "solve_many", "make_solver_many",
           "print_monitor", "gmres", "fgmres", "bicgstab", "cg", "pipecg",
           "minres", "chebyshev", "richardson", "preonly",
           "arnoldi_hessenberg", "estimate_extreme_eigs", "PC", "make_pc",
           "KSPResult", "reason_str", "NullSpace", "make_nullspace"]

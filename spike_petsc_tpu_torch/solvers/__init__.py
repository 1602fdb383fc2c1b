"""Solver layer: Krylov methods (KSP), preconditioners (PC), composition."""

from .krylov import bicgstab, cg, gmres
from .ksp import make_solver, make_solver_many, solve, solve_many
from .pc import PC, make_pc
from .types import KSPResult, reason_str

__all__ = ["solve", "make_solver", "solve_many", "make_solver_many", "gmres",
           "bicgstab", "cg", "PC", "make_pc", "KSPResult", "reason_str"]

"""spike_petsc_tpu_torch — the PyTorch / CUDA port of spike_petsc_tpu.

SPIKE-preconditioned Krylov solves of banded systems, one right-hand side
(``solve``) or a batch of them (``solve_many``), in PyTorch, with
hand-written CUDA kernels for the banded (f32 and f64) and
block-tridiagonal matvecs and the fused and two-pass block-Thomas sweeps
(``ops/cuda``, sources in ``csrc``).  The JAX
package ``spike_petsc_tpu`` is the reference it is held against; this
package never imports JAX.
"""

from .ops.band import BandedMatrix
from .ops.spike import SpikeFactor, spike_factor, spike_solve, spike_solve_many
from .solvers import (KSPResult, make_solver, make_solver_many, solve,
                      solve_many)
from .utils.options import Options

__all__ = ["solve", "make_solver", "solve_many", "make_solver_many",
           "Options", "BandedMatrix", "spike_factor", "spike_solve",
           "spike_solve_many", "SpikeFactor", "KSPResult"]

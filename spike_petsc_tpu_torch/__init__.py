"""spike_petsc_tpu_torch — the PyTorch / CUDA port of spike_petsc_tpu.

SPIKE-preconditioned Krylov solves of banded systems, one right-hand side
(``solve``) or a batch of them (``solve_many``), in PyTorch, with
hand-written CUDA kernels for the banded (f32 and f64) and
block-tridiagonal matvecs and the fused and two-pass block-Thomas sweeps
(``ops/cuda``, sources in ``csrc``).  The JAX
package ``spike_petsc_tpu`` is the reference it is held against; this
package never imports JAX.
"""

from .ops.band import (BandedMatrix, banded_axpy, banded_bandwidth,
                       banded_from_coo, banded_from_numpy_dense, banded_scale,
                       banded_shift, extract_banded_device)
from .ops.spike import (SpikeFactor, spike_factor, spike_factor_blocks,
                        spike_factor_grouped, spike_solve, spike_solve_many)
from .solvers import (KSPResult, make_solver, make_solver_many, solve,
                      solve_many)
from .utils.options import Options

__all__ = ["solve", "make_solver", "solve_many", "make_solver_many",
           "Options", "BandedMatrix", "banded_from_coo", "banded_shift",
           "banded_scale", "banded_axpy", "banded_bandwidth",
           "banded_from_numpy_dense", "extract_banded_device",
           "spike_factor", "spike_factor_blocks", "spike_factor_grouped",
           "spike_solve", "spike_solve_many", "SpikeFactor", "KSPResult"]

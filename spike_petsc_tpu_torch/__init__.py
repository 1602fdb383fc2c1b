"""spike_petsc_tpu_torch — the PyTorch / CUDA port of spike_petsc_tpu.

SPIKE-preconditioned Krylov solves of banded systems, one right-hand side
(``solve``) or a batch of them (``solve_many``), in PyTorch, with
hand-written CUDA kernels for the banded (f32 and f64) and
block-tridiagonal matvecs and the fused and two-pass block-Thomas sweeps
(``ops/cuda``, sources in ``csrc``).  The JAX
package ``spike_petsc_tpu`` is the reference it is held against; this
package never imports JAX.
"""

from .ops.autodiff import solve_banded_diff
from .ops.band import (BandedMatrix, banded_axpy, banded_bandwidth,
                       banded_diagonal, banded_diagonal_scale,
                       banded_from_coo, banded_from_dense,
                       banded_from_numpy_dense, banded_matvec, banded_scale,
                       banded_shift, banded_to_dense, extract_banded_device)
from .ops.blocktri import (BlockTridiagonal, band_to_blocktri,
                           blocktri_factor, blocktri_matvec, blocktri_solve,
                           blocktri_solve_transpose)
from .ops.spike import (SpikeFactor, spike_factor, spike_factor_blocks,
                        spike_factor_grouped, spike_solve, spike_solve_many,
                        spike_transpose)
from .solvers import (KSPResult, make_solver, make_solver_many, solve,
                      solve_many)
from .solvers.pc import PC, make_pc
from .solvers.types import reason_str
from .utils.options import Options
from .utils.registry import (ORDERINGS, PRECONDITIONERS, SOLVERS,
                             register_ksp, register_ordering, register_pc)
from . import sparse

__all__ = [
    "BandedMatrix", "banded_from_dense", "banded_from_coo", "banded_to_dense",
    "banded_matvec", "banded_diagonal", "banded_shift",
    "banded_scale", "banded_axpy", "banded_diagonal_scale",
    "banded_bandwidth", "banded_from_numpy_dense", "extract_banded_device",
    "BlockTridiagonal", "band_to_blocktri", "blocktri_factor",
    "blocktri_solve", "blocktri_solve_transpose", "blocktri_matvec",
    "SpikeFactor", "spike_factor", "spike_factor_blocks",
    "spike_factor_grouped", "spike_solve", "spike_solve_many",
    "spike_transpose", "solve_banded_diff",
    "solve", "solve_many", "make_solver", "make_solver_many",
    "PC", "make_pc", "KSPResult", "reason_str",
    "Options", "ORDERINGS", "PRECONDITIONERS", "SOLVERS",
    "register_ksp", "register_ordering", "register_pc", "sparse",
]

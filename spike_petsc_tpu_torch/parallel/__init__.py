"""Multi-rank execution on ``torch.distributed`` (the port of
``spike_petsc_tpu.parallel``): meshes of process groups (1-D, the 2-D
serving mesh, the multislice and the 3-D meshes), the distributed SPIKE
factor and solves, the Krylov solvers and the serving engines over them
(``mesh.py``, ``spike_dist.py``), the differentiable mesh solves
(``autodiff.py``), the elastic solves (``elastic.py``) and the auction on
one device and over a mesh axis (``matching_dev.py``)."""

from .autodiff import (dist_solve_banded_diff,
                       dist_solve_banded_diff_multislice)
from .elastic import (ResilientResult, ResilientServeResult, SolveCheckpoint,
                      resilient_serve, resilient_solve)
from .matching_dev import auction_match, auction_match_dist
from .mesh import (Mesh, MeshAxis, make_mesh, make_mesh_2d, make_mesh_3d,
                   make_mesh_multislice, shard_leading)
from .spike_dist import (DistSpikeFactor, dist_spike_factor,
                         dist_spike_factor_multislice, dist_spike_solve,
                         dist_spike_solve_many, dist_spike_transpose,
                         dist_spike_transpose_multislice, make_dist_solver,
                         make_dist_solver_3d, make_dist_solver_batched,
                         make_dist_solver_multislice,
                         make_dist_solver_multislice_batched)

__all__ = [
    "Mesh", "MeshAxis", "make_mesh", "make_mesh_2d", "shard_leading",
    "DistSpikeFactor", "dist_spike_factor", "dist_spike_solve",
    "dist_spike_solve_many", "dist_spike_transpose",
    "make_dist_solver", "make_dist_solver_batched",
    "make_mesh_multislice", "dist_spike_factor_multislice",
    "make_dist_solver_multislice", "make_dist_solver_multislice_batched",
    "dist_spike_transpose_multislice", "make_mesh_3d", "make_dist_solver_3d",
    "auction_match", "auction_match_dist",
    "ResilientResult", "ResilientServeResult", "SolveCheckpoint",
    "resilient_serve", "resilient_solve",
    "dist_solve_banded_diff", "dist_solve_banded_diff_multislice",
]

"""Multi-rank execution on ``torch.distributed``: meshes of process groups,
the distributed SPIKE factor and solves, and the Krylov solvers over a 1-D
mesh and a 2-D (rhs x p) serving mesh (``mesh.py``, ``spike_dist.py``); the
single-device auction (``matching_dev.auction_match``).

Not yet ported (ROADMAP Queue 1 item 5b): the multislice and 3-D meshes,
the distributed autodiff, elastic serving and the mesh auction.  Their
names are here and raise ``NotImplementedError``."""

from .matching_dev import auction_match, auction_match_dist
from .mesh import Mesh, MeshAxis, make_mesh, make_mesh_2d, shard_leading
from .spike_dist import (DistSpikeFactor, dist_spike_factor,
                         dist_spike_solve, dist_spike_solve_many,
                         dist_spike_transpose, make_dist_solver,
                         make_dist_solver_batched)


def _pending(name: str):
    def not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not yet ported to spike_petsc_tpu_torch (ROADMAP "
            "Queue 1 item 5b: multislice and 3-D meshes, parallel/autodiff, "
            "parallel/elastic, auction_match_dist)")
    not_ported.__name__ = not_ported.__qualname__ = name
    return not_ported


make_mesh_multislice = _pending("make_mesh_multislice")
dist_spike_factor_multislice = _pending("dist_spike_factor_multislice")
make_dist_solver_multislice = _pending("make_dist_solver_multislice")
make_dist_solver_multislice_batched = _pending(
    "make_dist_solver_multislice_batched")
dist_spike_transpose_multislice = _pending("dist_spike_transpose_multislice")
make_mesh_3d = _pending("make_mesh_3d")
make_dist_solver_3d = _pending("make_dist_solver_3d")
resilient_solve = _pending("resilient_solve")
resilient_serve = _pending("resilient_serve")
dist_solve_banded_diff = _pending("dist_solve_banded_diff")
dist_solve_banded_diff_multislice = _pending(
    "dist_solve_banded_diff_multislice")

__all__ = [
    "Mesh", "MeshAxis", "make_mesh", "make_mesh_2d", "shard_leading",
    "DistSpikeFactor", "dist_spike_factor", "dist_spike_solve",
    "dist_spike_solve_many", "dist_spike_transpose",
    "make_dist_solver", "make_dist_solver_batched",
    "make_mesh_multislice", "dist_spike_factor_multislice",
    "make_dist_solver_multislice", "make_dist_solver_multislice_batched",
    "dist_spike_transpose_multislice", "make_mesh_3d", "make_dist_solver_3d",
    "resilient_solve", "resilient_serve",
    "dist_solve_banded_diff", "dist_solve_banded_diff_multislice",
    "auction_match", "auction_match_dist",
]

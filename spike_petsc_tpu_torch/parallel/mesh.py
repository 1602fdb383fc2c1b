"""Device meshes on ``torch.distributed`` (the port of
``spike_petsc_tpu.parallel.mesh``).

The JAX package names a ``jax.sharding.Mesh`` axis and runs one program
over it.  Here one Python process runs per rank, and a mesh axis is a
process group: :class:`MeshAxis` holds the group, this rank's coordinate on
the axis, the axis size, the global ranks along it and the device, and
carries the collectives the distributed solvers use (``all_reduce``,
``all_gather``, the neighbour exchange ``exchange``).

  axis "p"   - the SPIKE partition axis (``ppd`` band partitions a rank);
  axis "rhs" - an optional batch axis over independent right-hand sides,
               each row of the 2-D mesh a replica of the factorization;
  axis "slice" - the outer row axis of the multislice layout: exact SPIKE
               within a slice, block-Jacobi across slices.

A mesh of two or more axes also carries the plane of its last two axes as
one axis, ``mesh.axis(("slice", "p"))``: the ranks of a ``(slice, p)``
plane in slice-major order, the JAX package's tuple axis name.  Its ring
exchange and its reductions are those of the flattened plane.

A mesh needs a default process group that the caller initialized
(``torch.distributed.init_process_group``); it never creates one.  The
device defaults to ``cuda:<local rank>``, ``device="cpu"`` selects the
CPU.  The backend follows the device: NCCL moves CUDA tensors and gloo CPU
ones, and a default group made with ``backend="cpu:gloo,cuda:nccl"`` serves
both.  A CUDA mesh over a group without NCCL raises: nothing moves through
the host behind the caller's back.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshAxis:
    """One named axis of a :class:`Mesh`: the process group of this rank's
    line along the axis."""

    name: str
    group: object                     # torch.distributed ProcessGroup
    size: int
    rank: int                         # this rank's coordinate on the axis
    ranks: tuple                      # global ranks along the axis, in order
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "max", "min") of ``t`` over the axis: one
        ``all_reduce`` of a copy (``t`` itself is left as it is)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` in axis order, one
        ``all_gather_into_tensor``."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:])
                          if t.dim() else (self.size,),
                          dtype=t.dtype, device=t.device)
        with warnings.catch_warnings():     # renamed all_gather_single
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, t if t.dim() else t.reshape(1),
                                        group=self.group)
        return out.reshape((self.size,) + tuple(t.shape))

    def exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor):
        """The cyclic neighbour exchange of the JAX package's two
        ``ppermute``s: send ``to_prev`` to the previous rank on the axis
        and ``to_next`` to the next one, and return ``(from_next,
        from_prev)``, what the next rank sent back and what the previous
        one sent forward.  Both directions go in one ``batch_isend_irecv``,
        matched by tag and by the order of the operations, so two ranks
        that are each other's previous and next (size 2) pair them right.
        On a one-rank axis nothing is sent: a rank is its own neighbour."""
        if self.size == 1:
            return to_prev, to_next
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        to_prev, to_next = to_prev.contiguous(), to_next.contiguous()
        from_next = torch.empty_like(to_prev)
        from_prev = torch.empty_like(to_next)
        ops = [dist.P2POp(dist.isend, to_prev, prv, group=self.group, tag=0),
               dist.P2POp(dist.isend, to_next, nxt, group=self.group, tag=1),
               dist.P2POp(dist.irecv, from_next, nxt, group=self.group,
                          tag=0),
               dist.P2POp(dist.irecv, from_prev, prv, group=self.group,
                          tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_next, from_prev


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the default group, row-major: on a 2-D
    mesh of shape (R, P) global rank ``i * P + j`` sits at (i, j)."""

    axis_names: tuple
    shape: dict                       # axis name -> size
    device: torch.device
    axes: dict = field(repr=False)    # axis name -> MeshAxis

    def axis(self, name: str) -> MeshAxis:
        if name not in self.axes:
            raise ValueError(f"mesh has no axis {name!r} (axes: "
                             f"{', '.join(self.axis_names)})")
        return self.axes[name]


def _mesh_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               % max(1, torch.cuda.device_count())))
    return torch.device("cuda", local)


def _check_backend(group, device: torch.device) -> None:
    backend = str(dist.get_backend(group)).lower()
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(
            f"a mesh on {device} needs the {need} backend, but the process "
            f"group has {backend!r}: initialize it with "
            "backend='cpu:gloo,cuda:nccl' (or the backend of the device)")


def _require_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group(backend=..., "
            "init_method=..., world_size=..., rank=...) first")


def _build_mesh(shape: Sequence[int], axes: Sequence[str],
                device) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    default group, row-major, axes named ``axes``: one process group for
    every line along every axis and, on a mesh of two or more axes, one
    for every plane of the last two axes (its ranks in row-major order,
    the flattened ``(slice, p)`` order of the JAX package's tuple axis
    names), registered under the tuple of the two names.  Every rank of
    the default group calls ``dist.new_group`` for every group, in the
    same order, including the groups it is not in; a rank outside the mesh
    raises after that."""
    _require_group()
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    world, me = dist.get_world_size(), dist.get_rank()
    need = int(np.prod(shape))
    if need > world:
        raise ValueError(f"requested {need} ranks, have {world}")
    dev = _mesh_device(device)
    grid = np.arange(need).reshape(shape)
    d = len(shape)
    groups = [((a,), axes[a]) for a in range(d)]
    if d >= 2:
        groups.append(((d - 2, d - 1), (axes[d - 2], axes[d - 1])))
    made = {}
    for dims, name in groups:
        rest = [a for a in range(d) if a not in dims]
        lines = np.moveaxis(grid, list(dims),
                            list(range(len(rest), d))).reshape(
                                -1, int(np.prod([shape[a] for a in dims])))
        for line in lines:
            ranks = tuple(int(r) for r in line)
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(list(ranks)))
            if me in ranks:
                _check_backend(group, dev)
                made[name] = MeshAxis(name=name, group=group,
                                      size=len(ranks),
                                      rank=ranks.index(me), ranks=ranks,
                                      device=dev)
    if me >= need:
        raise ValueError(f"rank {me} lies outside the {shape} mesh")
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)), device=dev,
                axes=made)


def make_mesh_2d(shape: Sequence[int], axes=("rhs", "p"),
                 device=None) -> Mesh:
    """A mesh of ``shape`` (one or two axes) over the first
    ``prod(shape)`` ranks of the default group, axes named ``axes``.
    Every rank of the default group must call it."""
    if len(shape) != len(axes) or not 1 <= len(shape) <= 2:
        raise ValueError(f"mesh shape {tuple(shape)} and axes "
                         f"{tuple(axes)}: one or two axes")
    return _build_mesh(shape, axes, device)


def make_mesh_multislice(shape: Sequence[int], axes=("slice", "p"),
                         device=None) -> Mesh:
    """The 2-D (slices, ranks-per-slice) mesh of the multislice SPIKE
    (JAX ``spike_dist.py:1045-1059``): ranks row-major, as JAX lays the
    devices out where they carry no ``slice_index``.  Its plane axis
    ``mesh.axis((axes[0], axes[1]))`` spans the whole mesh in slice-major
    order."""
    if len(shape) != 2 or len(axes) != 2:
        raise ValueError(f"a multislice mesh has two axes, got shape "
                         f"{tuple(shape)} and axes {tuple(axes)}")
    return _build_mesh(shape, axes, device)


def make_mesh_3d(shape: Sequence[int], axes=("rhs", "slice", "p"),
                 device=None) -> Mesh:
    """The 3-D (replicas, slices, ranks-per-slice) mesh of replicated
    multislice serving (JAX ``spike_dist.py:1696-1713``), ranks row-major.
    Each replica's ``(slice, p)`` plane is the axis
    ``mesh.axis((axes[1], axes[2]))``."""
    if len(shape) != 3 or len(axes) != 3:
        raise ValueError(f"a 3-D mesh has three axes, got shape "
                         f"{tuple(shape)} and axes {tuple(axes)}")
    return _build_mesh(shape, axes, device)


def make_mesh(n_devices: Optional[int] = None, axis: str = "p",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all)."""
    _require_group()
    return _build_mesh((n_devices or dist.get_world_size(),), (axis,),
                       device)


def shard_leading(mesh: Mesh, x, axis: str = "p") -> torch.Tensor:
    """This rank's block of ``x`` with its leading dim split over ``axis``
    (the JAX ``device_put`` with ``P(axis)``), on the mesh's device."""
    ax = mesh.axis(axis)
    x = torch.as_tensor(x)
    if x.shape[0] % ax.size:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by the "
                         f"{axis!r} axis size {ax.size}")
    step = x.shape[0] // ax.size
    return x[ax.rank * step:(ax.rank + 1) * step].to(mesh.device)

"""Elastic, fault-tolerant distributed solves (the port of
``spike_petsc_tpu.parallel.elastic``).

``resilient_solve`` runs the mesh SPIKE-preconditioned Krylov solve in
segments of ``segment_its`` iterations and checkpoints the iterate after
each one (to an npz file when ``ckpt_path`` is given: keys ``x``,
``its_done``, ``rnorm`` and ``segments``, the JAX package's format, so
either package resumes the other's file).  When a segment fails, the mesh
is rebuilt, the band re-factored there, and the solve resumes from the
last checkpoint.  The failure policy is JAX's: one same-size retry per
failure streak where every rank still answers, else halve the mesh (1-D)
or drop slices (multislice).  ``resilient_serve`` re-serves a batch of
right-hand sides on a replica mesh that lost replicas.  A
``fault_injector(index)`` that raises is handled as a device failure.

**One process per rank.**  JAX runs one program; here every rank runs
these functions with the same arguments, and they return the same result
on every rank:

* *Agreement on failure.*  After each segment, and on the failure path,
  every rank agrees on "failed or not" with one ``all_reduce(max)`` over
  the default group, so a rank-local exception cannot leave the other
  ranks inside the next segment's collectives.  The failing rank keeps
  its own exception; the others raise a ``RuntimeError`` naming the
  segment where ``max_failures`` is spent.
* *Live devices.*  Each rank writes a tensor to its own device and reads
  it back, then one ``all_reduce(sum)`` over the default group counts the
  ranks that answered.
* *Ranks outside a rebuilt mesh.*  A rebuilt mesh spans the first ranks of
  the world.  Every rank still calls the mesh factory (each group is made
  on every rank); the ranks outside it skip the factor and the solve and
  receive each segment's result by one broadcast from rank 0.
* *The checkpoint* is written by rank 0 and read by rank 0, which
  broadcasts it.
* *Limits.*  What this recovers from is an exception that reaches Python
  (on any rank, as long as the others reach the agreement).  A real NCCL
  communicator failure or a lost process cannot be recovered in the
  process: the collectives of the other ranks hang or abort.  That needs a
  restart of every rank with ``resume=True`` from the checkpoint file.

The meshes default to the card (``cuda:<local rank>``); ``device="cpu"``
runs them on the CPU.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.band import BandedMatrix
from ..solvers.types import CONVERGED_ITERATING, DIVERGED_ITS, KSPResult
from .mesh import _mesh_device, make_mesh, make_mesh_2d, make_mesh_3d
from .mesh import make_mesh_multislice
from .spike_dist import (dist_spike_factor, dist_spike_factor_multislice,
                         make_dist_solver, make_dist_solver_3d,
                         make_dist_solver_batched,
                         make_dist_solver_multislice)


@dataclass
class SolveCheckpoint:
    """Host-side restartable solver state."""

    x: np.ndarray
    its_done: int
    rnorm: float
    segments: int

    def save(self, path: str) -> None:
        np.savez_compressed(path, x=self.x, its_done=self.its_done,
                            rnorm=self.rnorm, segments=self.segments)

    @staticmethod
    def load(path: str) -> "SolveCheckpoint":
        z = np.load(path)
        return SolveCheckpoint(x=z["x"], its_done=int(z["its_done"]),
                               rnorm=float(z["rnorm"]),
                               segments=int(z["segments"]))


@dataclass
class ResilientResult:
    """KSPResult plus the recovery trail."""

    x: np.ndarray
    its: int
    reason: int
    rnorm: float
    segments: int
    failures: int
    meshes_used: list


@dataclass
class ResilientServeResult:
    """Served batch plus the recovery trail."""

    X: np.ndarray                # [R, n]
    attempts: int
    failures: int
    meshes_used: list


# ---------------------------------------------------------------------------
# The collectives of the recovery protocol (default group, every rank)
# ---------------------------------------------------------------------------

def _agree(flags, device) -> list:
    """The elementwise OR of every rank's ``flags`` (one ``all_reduce``
    ``max`` over the default group)."""
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def _probe_alive(device) -> int:
    """The ranks whose device completes a put and a readback: each rank
    tries its own, then one ``all_reduce`` sum over the default group."""
    try:
        ok = int(torch.ones(1, device=device).cpu().item() == 1.0)
    except Exception:                   # noqa: BLE001 - a lost device
        ok = 0
    t = torch.tensor([ok], dtype=torch.int32, device=device)
    dist.all_reduce(t)
    return int(t.item())


def _from_rank0(obj):
    """``obj`` as rank 0 holds it, on every rank (one broadcast)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _member(factory, cfg):
    """``factory(cfg)``, or None on a rank outside the mesh: every rank
    calls the factory, which makes each group on every rank."""
    try:
        return factory(cfg)
    except ValueError:
        if dist.get_rank() < int(np.prod(cfg)):
            raise
        return None


def _peer_failure(what: str) -> RuntimeError:
    return RuntimeError(f"another rank failed in {what}")


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def resilient_solve(band: BandedMatrix, rhs, *,
                    n_devices: Optional[int] = None,
                    mesh_shape: Optional[tuple] = None,
                    parts_per_device: int = 1,
                    block_b: Optional[int] = None,
                    method: str = "inv",
                    ksp_type: str = "gmres",
                    rtol: float = 1e-8,
                    maxit: int = 200,
                    segment_its: int = 20,
                    ckpt_path: Optional[str] = None,
                    resume: bool = False,
                    fault_injector: Optional[Callable[[int], None]] = None,
                    max_failures: int = 2,
                    mesh_factory: Callable = make_mesh,
                    on_failure: Optional[Callable] = None,
                    device=None,
                    **solver_params) -> ResilientResult:
    """Distributed SPIKE-preconditioned solve with checkpointed segments and
    mesh-rebuild recovery (JAX ``parallel/elastic.py:65-300``).

    Args:
      band: the operator, the same global band on every rank (kept as the
        re-factor source on recovery).
      n_devices: ranks of the 1-D mesh to start with (None = the world).
      mesh_shape: (n_slices, per_slice): a MULTISLICE mesh instead; a
        recovery drops whole slices, per_slice fixed.
      segment_its: iterations a segment (the checkpoint cadence).
      ckpt_path: npz path of the iterate checkpoint (None = in memory).
      resume: continue from ``ckpt_path``.
      fault_injector: called after each completed segment with its index;
        an exception from it is handled like a device failure.
      max_failures: re-raise after this many recoveries.
      mesh_factory: makes the mesh of a configuration (the rank count, or
        the shape in multislice mode); the default ones take ``device``.
      on_failure: ``(cfg, exc) -> new_cfg`` policy for the rebuilt mesh;
        default: the live-rank probe, one same-size retry a failure streak
        where every rank answers, else halve / drop slices.  It must give
        the same answer on every rank.
      device: the meshes' device (default ``cuda:<local rank>``).

    Returns a ResilientResult, the same on every rank; ``reason`` follows
    KSPConvergedReason, and iterations done inside a failed segment are
    redone from the checkpoint and not counted."""
    dev = _mesh_device(device)
    world = dist.get_world_size()
    multislice = mesh_shape is not None
    x_dtype = _np_dtype(band.dtype)
    if resume and ckpt_path:
        state = _from_rank0(SolveCheckpoint.load(ckpt_path)
                            if dist.get_rank() == 0 else None)
    else:
        state = SolveCheckpoint(x=np.zeros(band.n, x_dtype), its_done=0,
                                rnorm=float("inf"), segments=0)
    failures = 0
    meshes_used = []
    reason = CONVERGED_ITERATING
    solver = None

    if multislice:
        # a caller's factory receives the SHAPE tuple here (the 1-D path
        # passes a rank count)
        factory = (functools.partial(make_mesh_multislice, device=device)
                   if mesh_factory is make_mesh else mesh_factory)
    else:
        factory = (functools.partial(make_mesh, device=device)
                   if mesh_factory is make_mesh else mesh_factory)

    def build(cfg, seg_maxit):
        mesh = _member(factory, cfg)
        made = None
        if mesh is not None and multislice:
            dsf = dist_spike_factor_multislice(
                band, mesh, method=method, block_b=block_b,
                parts_per_device=parts_per_device)
            made = make_dist_solver_multislice(
                dsf, mesh, ksp_type=ksp_type, rtol=rtol, maxit=seg_maxit,
                **solver_params)
        elif mesh is not None:
            dsf = dist_spike_factor(band, mesh, method=method,
                                    block_b=block_b,
                                    parts_per_device=parts_per_device)
            made = make_dist_solver(dsf, mesh, ksp_type=ksp_type, rtol=rtol,
                                    maxit=seg_maxit, **solver_params)
        return made

    def default_on_failure(cfg, exc):
        """One probe of the live ranks: all alive means a transient fault
        (retried at the same size), else the mesh shrinks to what the
        survivors support."""
        alive = _probe_alive(dev)
        if multislice:
            s, p = cfg
            if alive >= s * p:
                return cfg
            new_s = min(s, alive // p)
            if new_s < 1:
                raise RuntimeError(
                    f"only {alive} devices survive — fewer than one "
                    f"slice of {p}; cannot rebuild a multislice mesh"
                ) from exc
            return (new_s, p)
        if alive >= cfg:
            return cfg
        return max(1, min(cfg, alive) // 2)

    def shrink(cfg):
        """The forced step-down when failures persist on a healthy probe:
        drop one slice (multislice) / halve (1-D)."""
        if multislice:
            return (max(1, cfg[0] - 1), cfg[1])
        return max(1, cfg // 2)

    cfg = tuple(mesh_shape) if multislice else (n_devices or world)
    rhs = torch.as_tensor(rhs)
    policy = on_failure or default_on_failure
    solver_maxit = None
    same_size_retries = 0
    building = True

    while state.its_done < maxit:
        exc = out = None
        # clamp the final segment so the GLOBAL maxit is exact; a changed
        # segment length rebuilds the solver once
        seg_maxit = min(segment_its, maxit - state.its_done)
        building = building or seg_maxit != solver_maxit
        built = False
        try:
            if building:
                solver = build(cfg, seg_maxit)
                solver_maxit, built = seg_maxit, True
            if solver is not None:
                # a checkpoint of the other package may carry another dtype
                res: KSPResult = solver(rhs, torch.as_tensor(state.x).to(
                    band.dtype))
                out = (res.x.detach().cpu().numpy(), int(res.its),
                       int(res.reason), float(res.rnorm))
            if fault_injector is not None:
                fault_injector(state.segments)
        except Exception as e:          # noqa: BLE001 - any runtime error
            exc = e
        build_failed, failed = _agree([building and not built,
                                       exc is not None], dev)
        if building and not build_failed:
            # the trail records only meshes whose build completed
            meshes_used.append(tuple(int(c) for c in np.atleast_1d(cfg)))
            building = False
        if failed:
            exc = exc or _peer_failure(f"segment {state.segments}")
            failures += 1
            if failures > max_failures:
                raise exc
            new_cfg = policy(cfg, exc)
            new_cfg = tuple(new_cfg) if multislice else int(new_cfg)
            if new_cfg == cfg and on_failure is None:
                # one same-size retry a failure streak; a second failure
                # without a completed segment shrinks anyway
                same_size_retries += 1
                if same_size_retries > 1:
                    new_cfg = shrink(cfg)
            if new_cfg != cfg or on_failure is not None:
                cfg = new_cfg
                building = True
            continue

        if int(np.prod(cfg)) < world:
            out = _from_rank0(out)
        x_host, seg_its, seg_reason, seg_rnorm = out
        same_size_retries = 0        # a completed segment ends the streak
        state = SolveCheckpoint(x=x_host,
                                its_done=state.its_done + max(seg_its, 1),
                                rnorm=seg_rnorm,
                                segments=state.segments + 1)
        if ckpt_path and dist.get_rank() == 0:
            state.save(ckpt_path)
        if seg_reason not in (CONVERGED_ITERATING, DIVERGED_ITS):
            reason = seg_reason
            break
    else:
        reason = DIVERGED_ITS

    return ResilientResult(x=state.x, its=state.its_done, reason=reason,
                           rnorm=state.rnorm, segments=state.segments,
                           failures=failures, meshes_used=meshes_used)


def resilient_serve(band: BandedMatrix, B, *,
                    mesh_shape: tuple,
                    parts_per_device: int = 1,
                    block_b: Optional[int] = None,
                    method: str = "inv",
                    ksp_type: str = "richardson",
                    rtol: float = 1e-8,
                    maxit: int = 50,
                    fault_injector: Optional[Callable[[int], None]] = None,
                    max_failures: int = 2,
                    on_failure: Optional[Callable] = None,
                    device=None,
                    **solver_params) -> ResilientServeResult:
    """Elastic multi-RHS serving on a replica mesh (JAX
    ``parallel/elastic.py:313-419``): a failure costs replicas, not work;
    the batch is re-served on a mesh with a smaller rhs axis.

    Args:
      B: right-hand sides [R, n], an array or a tensor (brought to the
        host, padded with zero rows to a multiple of the rhs axis; X
        trimmed).
      mesh_shape: (n_rhs, n_p), the 2-D replica mesh
        (``make_dist_solver_batched``), or (n_rhs, n_slices, per_slice),
        the 3-D replicated multislice mesh (``make_dist_solver_3d``).
      on_failure: ``(cfg, exc) -> new_cfg``; the default probes the live
        ranks and shrinks only the replica axis, with one same-size retry
        a failure streak where every rank answers.
      fault_injector: called after each serve attempt with its index.
      device: the meshes' device (default ``cuda:<local rank>``).

    Returns a ResilientServeResult (X ``[R, n]``), the same on every
    rank."""
    three_d = len(mesh_shape) == 3
    if not three_d and len(mesh_shape) != 2:
        raise ValueError("mesh_shape must be (n_rhs, n_p) or "
                         "(n_rhs, n_slices, per_slice)")
    dev = _mesh_device(device)
    world = dist.get_world_size()
    B = B.detach().cpu().numpy() if torch.is_tensor(B) else np.asarray(B)
    R = B.shape[0]
    failures = 0
    attempts = 0
    meshes_used = []
    cfg = tuple(int(c) for c in mesh_shape)

    def build(c):
        if three_d:
            mesh = _member(functools.partial(make_mesh_3d, device=device), c)
            solver = None
            if mesh is not None:
                dsf = dist_spike_factor_multislice(
                    band, mesh, method=method, block_b=block_b,
                    parts_per_device=parts_per_device)
                solver = make_dist_solver_3d(dsf, mesh, ksp_type=ksp_type,
                                             rtol=rtol, maxit=maxit,
                                             **solver_params)
        else:
            mesh = _member(functools.partial(make_mesh_2d, axes=("rhs", "p"),
                                             device=device), c)
            solver = None
            if mesh is not None:
                dsf = dist_spike_factor(band, mesh, axis="p", method=method,
                                        block_b=block_b,
                                        parts_per_device=parts_per_device)
                solver = make_dist_solver_batched(
                    dsf, mesh, ksp_type=ksp_type, rtol=rtol, maxit=maxit,
                    **solver_params)
        return solver

    inner = int(np.prod(cfg[1:]))

    def default_on_failure(c, exc):
        alive = _probe_alive(dev)
        if alive >= c[0] * inner:
            return c                      # transient; retry same size
        new_r = min(c[0], alive // inner)
        if new_r < 1:
            raise RuntimeError(
                f"only {alive} devices survive — fewer than one replica "
                f"of {inner}; cannot rebuild a serving mesh") from exc
        return (new_r,) + c[1:]

    policy = on_failure or default_on_failure
    solver = None
    building = True
    same_size_retries = 0
    while True:
        exc = X = None
        built = served = False
        try:
            if building:
                solver = build(cfg)
                built = True
            r_ax = cfg[0]
            Rp = -(-R // r_ax) * r_ax
            Bp = np.zeros((Rp, B.shape[1]), B.dtype)
            Bp[:R] = B
            if solver is not None:
                X = solver(torch.as_tensor(Bp)).detach().cpu().numpy()
            served = True
            if fault_injector is not None:
                fault_injector(attempts)
        except Exception as e:          # noqa: BLE001 - any runtime error
            exc = e
        build_failed, not_served, failed = _agree(
            [building and not built, not served, exc is not None], dev)
        if building and not build_failed:
            # the trail records only meshes whose build completed
            meshes_used.append(cfg)
            building = False
        if not not_served:
            attempts += 1
        if not failed:
            if int(np.prod(cfg)) < world:
                X = _from_rank0(X)
            return ResilientServeResult(X=X[:R], attempts=attempts,
                                        failures=failures,
                                        meshes_used=meshes_used)
        exc = exc or _peer_failure(f"serve attempt {attempts}")
        failures += 1
        if failures > max_failures:
            raise exc
        new_cfg = tuple(policy(cfg, exc))
        if new_cfg == cfg and on_failure is None:
            same_size_retries += 1
            if same_size_retries > 1:
                # the probe is not seeing the real fault: drop a replica
                new_cfg = (max(1, cfg[0] - 1),) + cfg[1:]
        if new_cfg != cfg:
            cfg = new_cfg
            building = True

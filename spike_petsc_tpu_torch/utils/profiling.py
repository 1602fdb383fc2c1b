"""Tracing / profiling / observability.

The reference delegates tracing to PETSc: PetscInfo event notes, per-function
stack tracing, -log_summary stage logging (SURVEY.md §5;
reference/src/matbanded.c:175).  The port's equivalents, one primitive for
each kind of path:

* ``span(name)`` — the hot path's span (the solve's operator, PC apply,
  SPIKE sweep and reduced solve, the Krylov loops' host reads), named after
  PETSc's log events: a host-side ``torch.profiler`` event while a profiler
  records, and nothing at all (one shared null context) while none does.
  It never synchronizes, so a trace shows the host and the device as they
  overlap, the device's operations on the same clock as the spans.
* ``scope(name)`` — a set-up stage (``PCSetUp``, the fieldsplit and Fiedler
  stages, the testbed's): a trace annotation that also accumulates
  wall-clock per stage (the -log_view analogue).  Where CUDA is in use, the
  scope synchronizes the device before it stops the clock, so a stage's
  time is the work it launched, not the time to queue it; keep it off the
  solve's path.
* ``log_event`` / ``event_log`` — structured event records (phase, matrix
  size, bandwidth, residuals) replacing PetscInfo prints.
* ``stage_report()`` — per-stage cumulative wall-clock/hit-count table;
  ``stage_times()`` the same seconds as a dict.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List, Set

import torch

_STAGES: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"time": 0.0, "count": 0})
_EVENTS: List[dict] = []
_OPEN: Set[str] = set()         # the stages being timed now
_NULL = contextlib.nullcontext()


def _sync() -> None:
    """Wait for the work queued on the CUDA devices, where CUDA is in use
    (on a machine that never initialized CUDA there is nothing to wait
    for)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def scope(name: str):
    """Named profiling scope: trace annotation + stage timer.  The device
    is synchronized at entry and exit when CUDA is in use, so the stage's
    time holds the device work it launched and none launched before it.
    A stage entered again inside itself (a sub-PC's ``PCSetUp``) is part
    of the outer one and is not timed twice."""
    if name in _OPEN:
        yield
        return
    _OPEN.add(name)
    try:
        _sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync()
        dt = time.perf_counter() - t0
    finally:
        _OPEN.discard(name)
    s = _STAGES[name]
    s["time"] += dt
    s["count"] += 1


def span(name: str):
    """A hot-path span: a context manager that, while a ``torch.profiler``
    records, marks ``name`` on the host's timeline, and otherwise is one
    shared null context (no clock read, no allocation).  It never
    synchronizes.  The event is a host-side one only
    (``_RecordFunctionFast``): a trace places the device's operations under
    it by the host call that launched them, and the device's timeline
    carries no annotation beside the operations."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)


def log_event(event: str, **fields: Any) -> None:
    _EVENTS.append(dict(event=event, t=time.time(), **fields))


def event_log() -> List[dict]:
    return list(_EVENTS)


def clear() -> None:
    _STAGES.clear()
    _EVENTS.clear()


def stage_times() -> Dict[str, float]:
    """Each stage's cumulative wall-clock in seconds."""
    return {name: s["time"] for name, s in _STAGES.items()}


def stage_report() -> str:
    """-log_summary style cumulative table."""
    lines = [f"{'stage':<32} {'count':>8} {'total_ms':>12} {'avg_ms':>10}"]
    for name, s in sorted(_STAGES.items(), key=lambda kv: -kv[1]["time"]):
        c = int(s["count"])
        lines.append(f"{name:<32} {c:>8} {s['time'] * 1e3:>12.2f} "
                     f"{s['time'] / max(c, 1) * 1e3:>10.3f}")
    return "\n".join(lines)


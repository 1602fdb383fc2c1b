"""Tracing / profiling / observability.

The reference delegates tracing to PETSc: PetscInfo event notes, per-function
stack tracing, -log_summary stage logging (SURVEY.md §5;
reference/src/matbanded.c:175).  The port's equivalents:

* ``scope(name)`` — named trace annotation: shows up in the torch.profiler
  timeline (``torch.profiler.record_function``) AND accumulates wall-clock
  per stage (the -log_view analogue).  Where CUDA is in use, the scope
  synchronizes the device before it stops the clock, so a stage's time is
  the work it launched, not the time to queue it.
* ``log_event`` / ``event_log`` — structured event records (phase, matrix
  size, bandwidth, residuals) replacing PetscInfo prints.
* ``start_trace``/``stop_trace`` — a torch.profiler trace of the host and
  the CUDA device, exported as a Chrome trace.
* ``stage_report()`` — per-stage cumulative wall-clock/hit-count table;
  ``stage_times()`` the same seconds as a dict.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, List

import torch

_STAGES: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"time": 0.0, "count": 0})
_EVENTS: List[dict] = []
_VERBOSITY = 0
_TRACE = None


def set_verbosity(level: int) -> None:
    """0 = silent, 1 = events printed, 2 = + stage timings (mirrors MC64's
    ICNTL(5) diagnostic levels, reference/src/hslmc64.c:233-241)."""
    global _VERBOSITY
    _VERBOSITY = level


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
    time holds the device work it launched and none launched before it."""
    _sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        _sync()
    dt = time.perf_counter() - t0
    s = _STAGES[name]
    s["time"] += dt
    s["count"] += 1
    if _VERBOSITY >= 2:
        print(f"[stage] {name}: {dt * 1e3:.3f} ms")


def log_event(event: str, **fields: Any) -> None:
    rec = dict(event=event, t=time.time(), **fields)
    _EVENTS.append(rec)
    if _VERBOSITY >= 1:
        print(f"[event] {json.dumps(rec, default=str)}")


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


def start_trace(logdir: str) -> None:
    """Start a torch.profiler trace of the host and, where CUDA is
    available, the device; ``stop_trace`` writes it to ``logdir``."""
    global _TRACE
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _TRACE = (torch.profiler.profile(activities=acts), logdir)
    _TRACE[0].__enter__()


def stop_trace() -> None:
    global _TRACE
    prof, logdir = _TRACE
    _TRACE = None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

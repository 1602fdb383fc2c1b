"""Measured-route tuning records: the card's matvec routes, timed.

A band's matvec has three routes on the card: the plain shifted-axpy
version (``xla``), the banded CUDA kernel (``banded_cuda``, #2; for an f64
band ``banded_cuda_f64``, #6) and the block-tridiagonal kernel after a
one-time conversion (``blocktri``, #7).  Their crossover points are
properties of the card, so they are measured, not guessed:

  * ``tools/tune.py`` times every feasible route at a shape and records the
    winner per (platform, width, dtype) in a small JSON file;
  * ``matvec_route_hint`` reads it back (nearest width within 2x on the
    same platform, n within 8x, the same dtype).

Unlike the JAX package's, the port's ``as_matvec("auto")`` follows no
record: the band kernel won at every shape measured on the card, so a
record could only move 'auto' onto a slower kernel.

The file is merged atomically; its location is ``SPIKE_TUNING_FILE``
(tests point it at a per-session file), by default
``~/.cache/spike_petsc_tpu_torch/tuning.json``.  No record ships with the
package.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
import time
import warnings
from typing import Optional

import torch

_DEFAULT = os.path.join(os.path.expanduser("~"), ".cache",
                        "spike_petsc_tpu_torch", "tuning.json")
_cache = {"path": None, "mtime": None, "data": None}
# the route names a record may name as its winner; the JAX package's
# records (its own names, under ``cpu`` or ``tpu:<generation>`` in a
# shared file) name none of them and are ignored
ROUTES = ("banded_cuda", "banded_cuda_f64", "blocktri", "xla")


def record_path() -> str:
    return os.environ.get("SPIKE_TUNING_FILE", _DEFAULT)


def load() -> dict:
    """The tuning record, re-read when the file changes."""
    path = record_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    if _cache["path"] == path and _cache["mtime"] == mtime:
        return _cache["data"]
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    data = data if isinstance(data, dict) else {}
    _cache.update(path=path, mtime=mtime, data=data)
    return data


def platform_key(device=None) -> str:
    """Device-qualified platform key for tuning records: on the card
    ``cuda:<name>``, the device name lowercased with its spaces removed
    (``"NVIDIA H100 80GB HBM3"`` -> ``"cuda:nvidiah10080gbhbm3"``), so that
    a record measured on one card never applies on another; off the card
    (no CUDA device, or ``device`` a CPU device) ``cpu``."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda" \
            or not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(device)
    return "cuda:" + name.lower().replace(" ", "")


_warned_platforms: set = set()


def _warn_other_card(platform: str, others: list) -> None:
    if platform in _warned_platforms:
        return
    _warned_platforms.add(platform)
    warnings.warn(
        f"no tuning measurements for platform {platform!r}; records exist "
        f"for {sorted(others)} but route crossovers do not transfer between "
        f"cards — using the static route rule. Run `python -m "
        f"spike_petsc_tpu_torch.tools.tune` on this card to record measured "
        f"routes.", RuntimeWarning, stacklevel=3)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    import numpy as np
    return np.dtype(dtype).name


def matvec_key(w: int, dtype) -> str:
    """Record key for a banded matvec measurement: total width and dtype
    (``"201:float32"``; a torch or numpy dtype)."""
    return f"{int(w)}:{_dtype_name(dtype)}"


def update(platform: str, kind: str, key: str, entry: dict) -> str:
    """Merge one measurement into the record (an atomic rename write):
    ``{platform: {kind: {key: entry}}}``, e.g. ``{"cuda:nvidiah10080gbhbm3":
    {"banded_matvec": {"201:float32": {"winner": "blocktri", "n":
    1000000, ...}}}}``.  Returns the path written."""
    path = record_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # a copy: load() returns the shared cache, which a failed write below
    # must not leave changed
    data = copy.deepcopy(load())
    data.setdefault(platform, {}).setdefault(kind, {})[str(key)] = entry
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tuning-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _cache.update(path=None, mtime=None, data=None)   # force a re-read
    return path


def matvec_route_hint(platform: str, w: int, dtype=None,
                      n: Optional[int] = None) -> Optional[str]:
    """The measured winner for a banded matvec of total width ``w`` on
    ``platform``, or None where no measurement applies.

    A measurement applies when its dtype matches, its width is within 2x,
    its problem size (where both are known) within 8x, and its winner is
    one of ``ROUTES``.  Records for another card (another ``cuda:`` key)
    never match; where only such records exist, a one-time RuntimeWarning
    says the static rule applies untested on this card."""
    data = load()
    rec = data.get(platform, {}).get("banded_matvec", {})
    if not rec and platform.startswith("cuda"):
        others = [p for p in data
                  if p != platform and p.startswith("cuda")
                  and data.get(p, {}).get("banded_matvec")]
        if others:
            _warn_other_card(platform, others)
        return None
    dt = _dtype_name(dtype) if dtype is not None else None
    best = None
    for wk, e in rec.items():
        try:
            wpart, _, dpart = wk.partition(":")
            wv = float(wpart)
        except ValueError:
            continue
        if not isinstance(e, dict) or e.get("winner") not in ROUTES:
            continue
        if dt is not None and dpart and dpart != dt:
            continue
        if n is not None and e.get("n"):
            nratio = max(float(e["n"]), n) / max(min(float(e["n"]), n), 1.0)
            if nratio > 8.0:
                continue
        ratio = max(wv, w) / max(min(wv, w), 1.0)
        if ratio <= 2.0 and (best is None or ratio < best[0]):
            best = (ratio, e["winner"])
    return best[1] if best else None


def measure_matvec_ms(mv, x: torch.Tensor, reps: int = 20) -> float:
    """A matvec's time in ms, the JAX package's method: a chained loop
    ``y = mv(y / max|y|)``, the 2-rep loop's time differenced from the
    (reps + 2)-rep loop's (the launch and sync costs cancel), each the
    least of three runs; timed by CUDA events on the card, by
    ``time.perf_counter`` on the CPU."""

    def loop(r):
        y = x
        for _ in range(r):
            y = mv(y / y.abs().max())
        return y

    if x.is_cuda:
        def timed(r):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            loop(r)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) * 1e-3
    else:
        def timed(r):
            t0 = time.perf_counter()
            loop(r)
            return time.perf_counter() - t0

    timed(2)                                      # warm-up (and builds)
    t1 = min(timed(2) for _ in range(3))
    t2 = min(timed(reps + 2) for _ in range(3))
    sm = max(t2 - t1, 1e-9) / reps
    return (t1 / 2.0 if sm < 1e-5 else sm) * 1e3

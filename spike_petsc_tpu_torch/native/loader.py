"""Native C++ engine loader: compile-on-demand + ctypes bindings.

The reference's native layer is the f2c'd MC64 C code plus external HSL
Fortran (SURVEY.md §2); ours is a small C++ library built with g++ on first
use into ``build/torch_native/`` at the repository root.  The library's file
name carries a hash of its sources and flags, and a build writes a private
temporary file that ``os.replace`` moves into place, so processes building
at once never load a half-written library.  Python fallbacks exist for every
native entry point, so a missing compiler only costs speed; ``engine()``
says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_LOCK = threading.Lock()
_lib = None
_tried = False

_SOURCES = ["assignment.cpp", "hopcroft_karp.cpp", "bottleneck_sorted.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_SRC / s).read_bytes())
    return BUILD_DIR / f"libspike_native_{h.hexdigest()[:16]}.so"


def _compile() -> Optional[str]:
    lib = _lib_path()
    if lib.exists():
        return str(lib)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError:
        return None
    os.close(fd)
    cmd = ["g++"] + _FLAGS + ["-o", tmp] + [str(_SRC / s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, lib)
        return str(lib)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.spike_assignment.restype = ctypes.c_int
        lib.spike_assignment.argtypes = [
            ctypes.c_int64, i64p, i64p, f64p, i64p, f64p, f64p]
        lib.spike_hopcroft_karp.restype = ctypes.c_int64
        lib.spike_hopcroft_karp.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_double,
            i64p]
        lib.spike_bottleneck_sorted.restype = ctypes.c_int
        lib.spike_bottleneck_sorted.argtypes = [
            ctypes.c_int64, i64p, i64p, f64p, i64p,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def engine() -> str:
    """Which matching engine runs: ``"native"`` (the C++ library, built or
    loaded here) or ``"python"`` (the NumPy/SciPy fallbacks)."""
    return "native" if get_lib() is not None else "python"


def get_assignment():
    """Returns fn(n, col_ptr, row_ind, cost) -> (match, u, v, feasible)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    def assignment(n, col_ptr, row_ind, cost):
        col_ptr = np.ascontiguousarray(col_ptr, np.int64)
        row_ind = np.ascontiguousarray(row_ind, np.int64)
        cost = np.ascontiguousarray(cost, np.float64)
        match = np.empty(n, np.int64)
        u = np.empty(n, np.float64)
        v = np.empty(n, np.float64)
        ok = lib.spike_assignment(n, col_ptr, row_ind, cost, match, u, v)
        return match, u, v, bool(ok)

    return assignment


def get_hopcroft_karp():
    """Returns fn(n, col_ptr, row_ind, weights=None, threshold=-inf)
    -> (match, cardinality), or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    def hopcroft_karp(n, col_ptr, row_ind, weights=None,
                      threshold=float("-inf")):
        col_ptr = np.ascontiguousarray(col_ptr, np.int64)
        row_ind = np.ascontiguousarray(row_ind, np.int64)
        match = np.empty(n, np.int64)
        if weights is None:
            wptr = None
        else:
            weights = np.ascontiguousarray(weights, np.float64)
            wptr = weights.ctypes.data_as(ctypes.c_void_p)
        card = lib.spike_hopcroft_karp(n, col_ptr, row_ind, wptr,
                                       float(threshold), match)
        return match, int(card)

    return hopcroft_karp


def get_bottleneck_sorted():
    """Returns fn(n, col_ptr, row_ind, weights) -> (match, best_t, feasible)
    — the job-3 warm-started sorted-threshold bisection engine
    (native/src/bottleneck_sorted.cpp) — or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    def bottleneck_sorted(n, col_ptr, row_ind, weights):
        col_ptr = np.ascontiguousarray(col_ptr, np.int64)
        row_ind = np.ascontiguousarray(row_ind, np.int64)
        weights = np.ascontiguousarray(weights, np.float64)
        match = np.empty(n, np.int64)
        best_t = ctypes.c_double(0.0)
        ok = lib.spike_bottleneck_sorted(n, col_ptr, row_ind, weights,
                                         match, ctypes.byref(best_t))
        return match, float(best_t.value), bool(ok)

    return bottleneck_sorted

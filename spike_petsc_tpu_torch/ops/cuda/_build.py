"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles at first use, with ``nvcc`` for ``sm_90a``,
into a shared library with a plain C interface under ``build/torch_kernels/``
at the repository root, and loads through ``ctypes``.  The library's file
name carries a hash of its source, the headers of ``csrc/`` it includes and
the flags, so an edited source or header rebuilds and a checkout builds
everything it needs by itself.  Importing this module needs no compiler;
only a launch (or an explicit ``build_all``) does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p          # device pointers and the stream
I = ctypes.c_int
LL = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def nvcc_command(src, out) -> list:
    """The compiler's command line for ``src`` into the library ``out``:
    the port's flags, and ``csrc/`` on the include path (for a copy of a
    source built elsewhere)."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
            str(src)]


def _included(text: str) -> list:
    """The headers of csrc/ that a source includes, in order."""
    return [CSRC_DIR / name
            for name in re.findall(r'^#include "([^"]+)"', text, re.M)]


class CudaKernel:
    """One CUDA source, its C entry points and its launch count.

    ``functions`` maps each exported C function to its ``argtypes``; every
    entry point returns ``cudaGetLastError()`` as an int.  ``launches``
    counts successful launches through :meth:`launch` and nothing else.
    """

    def __init__(self, name: str, functions: dict):
        self.name = name
        self.functions = functions
        self.launches = 0
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    def library_path(self) -> Path:
        text = self.source.read_bytes()
        h = hashlib.sha256(text)
        for header in _included(text.decode()):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless the library exists.
        Returns ``(process, tmp_path)`` or ``None``."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(self.source, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> str:
        """Wait for a build from :meth:`start_build`; returns the compiler's
        output (``-Xptxas -v`` register and shared-memory report)."""
        if started is None:
            return ""
        proc, tmp = started
        log, _ = proc.communicate()
        out = self.library_path()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        return log

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = I
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes, err.restype = [I], ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call entry point ``fn``; raise if the launch reported an error."""
        lib = self.lib()
        code = getattr(lib, fn)(*args)
        if code != 0:
            msg = getattr(lib, f"{self.name}_error_string")(code).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {code} ({msg})")
        self.launches += 1


def build_all(kernels) -> tuple:
    """Build every kernel's library, one ``nvcc`` per source, all started
    together.  Returns ``(seconds, {name: compiler output})``, the output
    '' for a library that was already built."""
    t0 = time.perf_counter()
    started = [(k, k.start_build()) for k in kernels]
    logs, errors = {}, []
    for k, s in started:         # wait for every compiler before raising
        try:
            logs[k.name] = k.finish_build(s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0, logs

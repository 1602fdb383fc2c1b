"""The import guard: a run loads neither JAX nor the JAX package, and the
reference loads nothing of the program.  Each check in a fresh process;
top-level module names compared whole (``spike_petsc_tpu_torch`` is not
``spike_petsc_tpu``)."""

import json
import re
import subprocess
import sys

from benchmark.tests.conftest import ROOT

LIST_TOPS = ("import json, sys; print(json.dumps(sorted("
             "{m.split('.')[0] for m in sys.modules})))")


def top_level_modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", f"{code}\n{LIST_TOPS}"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, check=True)
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    tops = top_level_modules(
        "import pkgutil, benchmark, benchmark.run, benchmark.control\n"
        "from benchmark import harness\n"
        "harness.import_port()\n"
        "for kind in ('metrics', 'problems', 'reference'):\n"
        "    for m in pkgutil.iter_modules([f'benchmark/{kind}']):\n"
        "        harness.load_module(harness.ROOT, kind, m.name)")
    assert "spike_petsc_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "spike_petsc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = top_level_modules("import benchmark.reference.banded")
    assert "torch" in tops
    assert not tops & {"spike_petsc_tpu_torch", "spike_petsc_tpu", "jax"}


def test_the_harness_knows_no_matrix_format():
    """The matrix, its arithmetic and what the program is given are the
    configuration's files': the harness and the control name no band, no
    band routine and no reference module."""
    banned = re.compile(r"\b(kl|ku|BandedMatrix|band_matvec|solve_band)\b"
                        r"|benchmark\.reference\b|from benchmark\.reference")
    for name in ("harness.py", "control.py"):
        text = (ROOT / "benchmark" / name).read_text()
        assert not banned.search(text), (name, banned.search(text))

"""A configuration, its cell and a metric that reads one of the program's
spans, added as new files and appended manifest entries alone, pass the
benchmark's own tests: a copy of the benchmark, its tests and the program
gains a sparse configuration, and the copy's manifest tests and the new
cell's tiny, traced, fault and control tests run there in a fresh
process."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_run import DENSE_REFERENCE, GRID_GENERATOR

CELL = "sparse_grid_gmres"
# a 5-point matrix on a grid (``GRID_GENERATOR``) under PCBANDED over a
# spike PC, cut to 40 x 50 for the CPU
CONFIG = {"name": "sparse-grid", "source": "https://example.org/grid5",
          "generator": "grid5", "reference": "dense", "nx": 80, "ny": 60,
          "n": 4800, "dtype": "float32", "tf32": False, "pc_type": "banded",
          "band_k": 4, "reduced": [],
          "options": {"pc_banded_kmax": 4, "banded_pc_type": "spike",
                      "banded_pc_spike_partitions": 8,
                      "banded_pc_spike_block": 8},
          "tiny": {"nx": 40, "ny": 50, "n": 2000,
                   "options": {"banded_pc_spike_partitions": 4}}}
# the program's operator applies per Krylov iteration, from its spans
SPAN_READER = '''
SPANS = ("MatMult",)


def read(run):
    count = run.trace.span_count.get("MatMult", 0) if run.trace else 0
    its = sum(run.call_its)
    return count / its if count and its else None
'''
NEW_FILES = {
    "benchmark/problems/grid5.py": GRID_GENERATOR,
    "benchmark/reference/dense.py": DENSE_REFERENCE,
    "benchmark/configs/sparse-grid.json": json.dumps(CONFIG),
    "benchmark/traffic/gmres-sparse.json": json.dumps(
        {"entry": "one", "ksp_type": "gmres", "columns": 1,
         "params": {"restart": 30, "rtol": 1e-8, "maxit": 300}, "pool": 2,
         "sample_calls": 2}),
    # readings of the tiny cell on the CPU (``benchmark.control``, seeds 1,
    # 2, 3, 2147483999, 4000000001): program 4.08e-7 - 5.31e-7, the TF32
    # control 8.69e-4 - 1.09e-3
    f"benchmark/workloads/{CELL}.json": json.dumps(
        {"limits": {"xerr": 1e-5},
         "set_from": {"program_max": 5.31e-7, "control_tf32_min": 8.69e-4}}),
    "benchmark/metrics/matmults_per_it.py": SPAN_READER,
}


def copy_with_tests_and_program(dest):
    """BENCHMARK.json, the benchmark with its tests, and the program."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    skip = shutil.ignore_patterns("__pycache__")
    for tree in ("benchmark", "spike_petsc_tpu_torch"):
        shutil.copytree(ROOT / tree, dest / tree, ignore=skip)
    return dest


def snapshot(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file()}


def add_the_cell(root):
    """New files, and entries appended to the manifest's lists."""
    for name, text in NEW_FILES.items():
        (root / name).write_text(text)
    path = root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["configs"].append(
        {"name": "sparse-grid", "source": CONFIG["source"],
         "file": "benchmark/configs/sparse-grid.json", "reduced": [],
         "why": "a throwaway sparse configuration"})
    manifest["workloads"].append(
        {"name": CELL, "config": "sparse-grid", "traffic": "gmres-sparse",
         "chips": 1, "why": "a throwaway sparse cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("rhs_per_s", "solve_p95_ms", "its_per_rhs"):
            m["workloads"].append(CELL)
    manifest["per_layer"].append(
        {"name": "matmults_per_it", "unit": "applies", "better": "lower",
         "source": "program_span",
         "layer": "Krylov and operator (solvers/krylov*.py, "
                  "solvers/operator.py)",
         "moves": "rhs_per_s", "workloads": [CELL]})
    path.write_text(json.dumps(manifest, indent=2))


def appended_only(old, new) -> bool:
    """``new`` is ``old`` with items appended to its lists."""
    if isinstance(old, dict):
        return (isinstance(new, dict) and old.keys() == new.keys()
                and all(appended_only(old[k], new[k]) for k in old))
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(appended_only(a, b) for a, b in zip(old, new)))
    return old == new


def test_a_cell_with_a_span_metric_added_by_new_files_alone(tmp_path):
    root = copy_with_tests_and_program(tmp_path)
    before = snapshot(root)
    add_the_cell(root)
    after = snapshot(root)
    manifest = root.joinpath("BENCHMARK.json").relative_to(root)
    assert all(after[f] == data for f, data in before.items()
               if f != manifest)
    assert appended_only(json.loads(before[manifest]),
                         json.loads(after[manifest]))

    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "benchmark/tests/test_bench_manifest.py",
         "benchmark/tests/test_bench_run.py", "-k",
         f"test_bench_manifest or {CELL}"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = {line.split("::", 1)[1] for line in proc.stdout.splitlines()
              if line.startswith("PASSED ")}
    # the manifest tests, the new cell's and configuration's among them,
    # and the cell's tiny, traced, fault and control runs
    assert {f"test_every_cell_reads_its_files_and_metrics[{CELL}]",
            "test_configurations_are_uncut[sparse-grid]",
            "test_manifest_keys_and_limits", "test_names_units_and_texts",
            f"test_tiny_cell_is_correct[{CELL}]",
            f"test_a_traced_tiny_cell_reads_what_the_cpu_can_give[{CELL}]",
            f"test_a_fault_under_the_timed_path_is_not_correct[{CELL}-"
            "unchanged]",
            f"test_a_fault_under_the_timed_path_is_not_correct[{CELL}-"
            "altered]",
            f"test_the_control_fails_and_the_program_holds[{CELL}]"} <= passed

"""The readings that the limits of a cell's check are set from.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ...

For each seed, in one process (the set-up is long): the matrix and the
pool as a run makes them; the program, set up as a run sets it up, called
once on every block of the pool; the configuration's plain reference's
float64 answers; and the gap (``xerr``, as the run's check computes it) of
three answers:

- ``program``: the program's (the lower reading, the largest over seeds);
- ``control``: the reference itself in the program's place, computed in
  TF32 (float32 storage, every product's operands rounded to TF32),
  the precision below the configuration's float32 with TF32 off (the upper
  reading, the smallest over seeds);
- ``f32``: the same reference in plain float32, for comparison.

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seed: int, device) -> dict:
    """The three gaps of one seed (see the module's docstring)."""
    import torch
    from benchmark import harness
    spec = harness.cell_spec(root, workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    port = harness.import_port()
    solve = harness.load_module(root, "reference", cfg["reference"]).solve
    n = cfg["n"]

    matrix = harness.make_matrix(root, cfg, seed, device)
    pool = harness.make_pool(root, cfg, traffic, matrix, seed, device)
    pc, solver, _ = harness.build(root, port, cfg, traffic, matrix, device)
    got, its = [], []
    for p in sorted(pool):
        res = solver(pool[p])
        got.append(res.x.reshape(n, -1))
        its += harness.column_stats(res, traffic["columns"])[0]
    del solver, pc
    X = torch.cat(got, dim=1)
    del got
    B = torch.cat([pool[p].reshape(n, -1) for p in sorted(pool)], dim=1)
    del pool
    ref = solve(cfg, matrix, B)
    out = dict(seed=seed, workload=workload, its_max=max(its),
               program=max(harness.column_gaps(X, ref)))
    del X
    out["control"] = max(harness.column_gaps(solve(
        cfg, matrix, B, dtype=torch.float32, tf32_products=True), ref))
    out["f32"] = max(harness.column_gaps(solve(
        cfg, matrix, B, dtype=torch.float32), ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

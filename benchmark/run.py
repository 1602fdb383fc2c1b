"""The benchmark's command: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the last lines
of standard error are the numbers the check compared, each beside its
limit.  Without CUDA, with fewer cards than the cell needs, without the
program in the checkout, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds
CACHE = ROOT / "build" / "bench_cache"


def power_limit_w():
    """The card's power limit (W) by ``nvidia-smi``, None where it fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.cell_spec(ROOT, args.workload)
    harness.import_port()                # the program is this checkout's
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda:0", STARTED)
    except Exception:   # the run gives no result: say why, print none
        traceback.print_exc()
        return 1
    out["device"]["power_limit_w"] = power_limit_w()
    found = harness.banned_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():         # the result's last key
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

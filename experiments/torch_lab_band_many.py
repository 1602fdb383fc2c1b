"""Lab for the multi-RHS band kernel (#11, ``csrc/band_matvec_many.cu``).

    python3 experiments/torch_lab_band_many.py [--widths 33,201] [--r 32]
        [--depths 2,3] [--dcs 34,51]
        [--variant LABEL:OLD=>NEW[|||OLD=>NEW...]] [--source LABEL:PATH]

At n = 1e6 a random f32 band of each width (kl = ku) is prepared once
(``prepare_banded_mv``) with X ``[n, r]``.  Each build of the kernel (the
source's; each ``--variant``, a copy under ``build/lab/`` with each text OLD
replaced by NEW; each ``--source``, another file of the same entry points)
is timed with CUDA events (20 launches queued back to back, median of 5)
at the plan's launch shape and at each ``--dcs`` count of diagonals a
stage (the plan's where none is given), each at every ``--depths`` ring
depth, and held to #2's column loop bit for bit.  One JSON line a
reading, beside the bound (bytes at 3.35 TB/s, FMAs at 67 TFLOP/s); the
card's name and power limit and each build's ptxas lines first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import roofline, time_ms  # noqa: E402


def variant_kernel(label, kernel, changes=(), path=None):
    """A copy of ``kernel``'s source under build/lab/ with each ``(old,
    new)`` of ``changes`` made (or the file ``path``), as a kernel of the
    same entry points."""
    from spike_petsc_tpu_torch.ops.cuda._build import CudaKernel
    text = Path(path).read_text() if path else kernel.source.read_text()
    for old, new in changes:
        if old not in text:
            raise SystemExit(f"variant {label}: {old!r} is not in the source")
        text = text.replace(old, new)
    dest = ROOT / "build/lab" / f"band_matvec_many_{label}.cu"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(text)

    class Variant(CudaKernel):
        @property
        def source(self):
            return dest
    return Variant(kernel.name, kernel.functions)


def launch(kern, prep, X, Y, dc, stages):
    """One launch of ``kern`` as ``banded_matvec_many_prepared`` makes it."""
    import torch
    from spike_petsc_tpu_torch.ops.cuda import band_matvec_many as cbmm
    stream = torch.cuda.current_stream(X.device).cuda_stream
    kern.launch(cbmm._ENTRY[prep.d3.dtype], prep.d3.data_ptr(), X.data_ptr(),
                Y.data_ptr(), prep.n, prep.d3.shape[1], prep.kl, prep.ku,
                X.shape[1], X.stride(0), dc, stages, stream)


def main() -> int:
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import band_matvec_many as cbmm
    from spike_petsc_tpu_torch.ops.cuda._build import build_all
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="33,201")
    ap.add_argument("--r", type=int, default=32)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--depths", default="", help="ring depths")
    ap.add_argument("--dcs", default="", help="diagonals a stage")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--source", action="append", default=[])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    builds = {"": cbmm.KERNEL}
    for spec in args.variant:
        label, change = spec.split(":", 1)
        builds[label] = variant_kernel(label, cbmm.KERNEL, [
            c.split("=>") for c in change.split("|||")])
    for spec in args.source:
        label, path = spec.split(":", 1)
        builds[label] = variant_kernel(label, cbmm.KERNEL, path=path)
    for label, kern in list(builds.items()):
        try:
            _, logs = build_all([kern])
        except RuntimeError as exc:
            print(json.dumps({"build": label, "error": str(exc)[-1500:]}))
            del builds[label]
            continue
        print(json.dumps({"build": label, "ptxas": [
            ln.strip() for ln in logs.get(kern.name, "").splitlines()
            if "registers" in ln or "spill" in ln]}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)
    n, r = args.n, args.r
    X = torch.randn((n, r), generator=gen, device=dev)
    depths = [int(s) for s in args.depths.split(",") if s]
    dcs = [int(s) for s in args.dcs.split(",") if s]
    bad = 0
    for w in (int(v) for v in args.widths.split(",")):
        k = (w - 1) // 2
        band = BandedMatrix(data=torch.randn((n, w), generator=gen,
                                             device=dev), kl=k, ku=w - 1 - k)
        prep = cbm.prepare_banded_mv(band)
        ref = torch.stack([cbm.banded_matvec_prepared(prep, X[:, j]
                                                      .contiguous())
                           for j in range(r)], dim=1)
        bound, by = roofline(n * w * 4 + 2 * n * r * 4, 2 * n * w * r)
        base = cbmm.band_many_plan(band.kl, band.ku, 4)
        shapes = [(base["dc"], base["stages"])] + [
            (min(dc, w), depth) for dc in dcs or [base["dc"]]
            for depth in depths or [base["stages"]]]
        for label, kern in builds.items():
            for dc, stages in dict.fromkeys(shapes):
                Y = torch.empty_like(X)
                try:
                    launch(kern, prep, X, Y, dc, stages)
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    print(json.dumps({"w": w, "build": label, "dc": dc,
                                      "stages": stages, "error": str(exc)}))
                    continue
                same = bool(torch.equal(Y, ref))
                bad += not same
                ms = time_ms(lambda: launch(kern, prep, X, Y, dc, stages),
                             iters=20)
                print(json.dumps({
                    "w": w, "r": r, "build": label or "source",
                    "dc": dc, "chunks": -(-w // dc), "stages": stages,
                    "ms": round(ms[0], 4), "spread": round(ms[1], 4),
                    "bound_ms": round(bound, 4), "by": by,
                    "time_over_bound": round(ms[0] / bound, 3),
                    "equal": same}), flush=True)
        del band, prep, ref
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the benchmark's cells spend the device's time, read through the
port's hot-path spans (``utils.profiling.span``), and what tracing costs.

    python3 experiments/torch_lab_spans.py --workload <cell> --seed <n> \\
        [--seconds 10] [--trace-seconds 3]

One process a cell, on one CUDA card.  The cell is built as
``benchmark/harness.py`` builds it (its band, PC, composed solver, pool of
right-hand sides and warm-up).  Then three windows of whole calls: one
untraced, one under ``torch.profiler`` (CPU and CUDA activity, each call in
``bench.call`` and each PC apply in ``bench.pc_apply``, as a traced run of
the benchmark has them), and a second untraced one.

The spans are host-side events.  A device operation belongs to a span when
the host call that launched it (the CUDA API call of the same correlation
id: ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``...) ran
inside the span; so the kernels the port launches through ``ctypes``
count too.  For each span name: its count, the device seconds and
operations launched inside it, and the summed length of its device-side
intervals (from the first such operation's start to the last one's end,
an instance at a time).  From them the six readings a later benchmark
metric would take:

- ``operator_ms``: device ms under ``MatMult``, per ``MatMult``;
- ``host_syncs_per_it``: ``KSPHostSync`` spans over the window's
  iterations (a call's iterations the most of its columns');
- ``sweep_ms``, ``reduced_solve_ms``, ``correct_ms``: device ms under
  ``SPIKESweep``, ``SPIKEReduced``, ``SPIKECorrect``, per span;
- ``pc_apply_wait_ms``: the device's idle time inside a ``PCApply``
  interval, per apply (interval less device time);
- ``pc_launches_per_apply``: device operations under ``PCApply``, per
  apply.

Beside them: the benchmark's own per-layer readers on the same trace
(``benchmark/trace.py``), the device's idle gaps by the host operation
running and by the innermost span running, the device-to-host copies
inside the ``KSPHostSync`` spans (one a read), and the mean call time of
each window (the on-cost of tracing).  One JSON line, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402

SPANS = ("MatMult", "PCApply", "SPIKESweep", "SPIKEReduced", "SPIKECorrect",
         "KSPHostSync", trace.CALL_SPAN, trace.PC_SPAN)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def span_table(events, names=SPANS) -> dict:
    """Per span name: ``count``, ``device_s``, ``ops``, ``interval_s`` and
    ``dtoh`` (device-to-host copies), attributing each device operation to
    the spans around the host call that launched it; and ``unmatched``,
    the device operations whose launch was not found."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not e.is_user_annotation]
    # the CUDA API calls (cudaLaunchKernel, cuLaunchKernelEx,
    # cudaMemcpyAsync, ...) carry the correlation id of what they launch
    launched_at = {e.id: e.time_range.start for e in cpu
                   if e.name.startswith("cu")}
    spans = {}
    for name in names:
        iv = sorted((e.time_range.start, e.time_range.end) for e in cpu
                    if e.name == name)
        spans[name] = ([s for s, _ in iv], [e for _, e in iv])
    inst = {name: {} for name in names}     # index -> [ops, s, first, last]
    unmatched = defaultdict(int)
    for op in dev:
        t = launched_at.get(op.id)
        if t is None:
            unmatched[op.name[:60]] += 1
            continue
        o0, o1 = op.time_range.start, op.time_range.end
        for name in names:
            starts, ends = spans[name]
            i = bisect_right(starts, t) - 1
            if i < 0 or t > ends[i]:
                continue
            rec = inst[name].setdefault(i, [0, 0.0, o0, o1, 0])
            rec[0] += 1
            rec[1] += o1 - o0
            rec[2], rec[3] = min(rec[2], o0), max(rec[3], o1)
            rec[4] += "DtoH" in op.name or "Device -> Host" in op.name
    out = {}
    for name in names:
        recs = inst[name].values()
        out[name] = dict(count=len(spans[name][0]),
                         ops=sum(r[0] for r in recs),
                         device_s=sum(r[1] for r in recs) / 1e6,
                         interval_s=sum(r[3] - r[2] for r in recs) / 1e6,
                         dtoh=sum(r[4] for r in recs))
    out["unmatched"] = dict(sorted(unmatched.items(), key=lambda kv: -kv[1]))
    out["device_ops"] = len(dev)
    return out


def idle_by_span(events, names=SPANS) -> dict:
    """The device's idle seconds inside the window's calls, by the
    innermost of the spans ``names`` running on the host at each gap's
    middle (``benchmark/trace.py``'s attribution, spans alone)."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ops = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type != DeviceType.CPU
                 and not e.is_user_annotation)
    calls = [e for e in cpu if e.name == trace.CALL_SPAN]
    if not calls or not ops:
        return {}
    lo = min(e.time_range.start for e in calls)
    hi = max(e.time_range.end for e in calls)
    gaps = [g for g in trace.idle_gaps(ops) if g[0] >= lo and g[1] <= hi]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
            if e.thread == calls[0].thread and e.name in names]
    out = defaultdict(float)
    for (g0, g1), name in zip(gaps, trace.host_op_at(
            host, [(g0 + g1) / 2 for g0, g1 in gaps])):
        out[name] += (g1 - g0) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def readings(table: dict, call_its: list) -> dict:
    """The six span readings (module docstring) and the correction's."""
    def per(name, key="device_s", scale=1e3):
        c = table[name]["count"]
        return table[name][key] / c * scale if c else None

    pca = table["PCApply"]
    its = sum(call_its)
    return dict(
        operator_ms=per("MatMult"),
        host_syncs_per_it=(table["KSPHostSync"]["count"] / its
                           if its else None),
        sweep_ms=per("SPIKESweep"),
        reduced_solve_ms=per("SPIKEReduced"),
        correct_ms=per("SPIKECorrect"),
        pc_apply_wait_ms=((pca["interval_s"] - pca["device_s"])
                          / pca["count"] * 1e3 if pca["count"] else None),
        pc_launches_per_apply=per("PCApply", "ops", 1))


def untraced(solver, pool, seconds, device, run):
    harness.window(solver, pool, seconds, device, random.Random(0), 0, run,
                   span=False)
    return statistics.mean(run.call_s) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace-seconds", type=float,
                    default=harness.TRACE_WINDOW_S)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cuda:0")
    spec = harness.cell_spec(ROOT, args.workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    port = harness.import_port()
    data = harness.make_band(ROOT, cfg, args.seed, device)
    band = port.BandedMatrix(data=data, kl=cfg["kl"], ku=cfg["ku"])
    pc = port.make_pc(cfg["pc_type"], band,
                      port.Options(dict(cfg["options"])))
    solver = harness.compose(port, cfg, traffic, band,
                             harness.traced_pc(pc, True))
    pool = harness.make_pool(cfg, traffic, data, args.seed)
    for p in range(min(2, len(pool))):
        solver(pool[p])
    harness.sync(device)

    def fresh():
        return harness.Run(cfg=cfg, traffic=traffic)

    before = untraced(solver, pool, args.seconds, device, fresh())
    run = fresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        harness.window(solver, pool, args.trace_seconds, device,
                       random.Random(0), 0, run, span=True)
    traced_ms = statistics.mean(run.call_s) * 1e3
    events = prof.events()
    run.trace = trace.summarize(prof, run.window_s)
    table = span_table(events)
    idle_spans = idle_by_span(events)
    del prof, events
    after = untraced(solver, pool, args.seconds, device, fresh())

    bench = {}
    for m in spec["per_layer"]:
        value = harness.load_module(ROOT, "metrics", m["name"]).read(run)
        if value is not None:
            bench[m["name"]] = value
    out = dict(workload=args.workload, seed=args.seed, card=card(),
               calls=len(run.call_s), its=sum(run.call_its),
               mean_call_ms=dict(untraced_before=before, traced=traced_ms,
                                 untraced_after=after),
               spans=readings(table, run.call_its), table=table,
               bench=bench, idle_gaps=run.trace.idle_gaps,
               idle_by_span=idle_spans,
               busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

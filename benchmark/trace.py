"""The reduction of a ``torch.profiler`` trace of the window to the numbers
the per-layer readers take.

The harness traces whole calls of the window with CPU and CUDA activity and
marks its own spans with ``record_function``: ``bench.call`` around each
call and ``bench.pc_apply`` around each preconditioner apply.  The profiler
draws each span on the device's timeline too, from the start of the first
operation launched inside it to the end of the last; the window's work runs
on one stream, so a device operation belongs to a span when it starts
inside that span's interval there.  (The host-side tree does not serve:
it does not link the kernels the program launches through ``ctypes``.)

The program's own spans (``spike_petsc_tpu_torch.utils.profiling.span``:
``MatMult``, ``PCApply``, ``SPIKESweep``...) are host-side events only, with
no interval on the device's timeline.  A reader names those it reads in its
``SPANS``, and for each such name a device operation counts under the span
when the CUDA call that launched it (the host event of the same
correlation id: ``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``...) ran while an instance of the span was open; so the
kernels launched through ``ctypes`` count too, and an operation launched
inside nested spans counts under each of them.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass, field

CALL_SPAN = "bench.call"
PC_SPAN = "bench.pc_apply"
TOP = 10                # entries of each breakdown list
NAME_CHARS = 100        # a kernel's name, cut to keep the result line short


@dataclass
class TraceSummary:
    """What one traced window gives.  Times in seconds."""

    window_s: float                 # host clock, first call to last return
    device_ops: int = 0             # kernels, copies and sets on the device
    busy_s: float = 0.0             # the union of their intervals
    span_count: dict = field(default_factory=dict)
    span_device_s: dict = field(default_factory=dict)
    span_ops: dict = field(default_factory=dict)    # the program's spans
    unmatched_ops: int = 0          # device operations with no launch found
    top_ops: list = field(default_factory=list)     # [[name, s], ...]
    idle_gaps: list = field(default_factory=list)   # [[host op, s], ...]


def _device_time_us(event) -> float:
    total = getattr(event, "device_time_total", None)
    return event.cuda_time_total if total is None else total


def union_length(intervals) -> float:
    """The length covered by ``(start, end)`` pairs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals):
    """The gaps between the union of ``(start, end)`` pairs, in order."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def host_op_at(host, points):
    """For each of the sorted ``points``, the name of the innermost host
    operation running then; ``host`` holds ``(start, end, name)`` of one
    thread, whose operations nest."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    names, stack, i = [], [], 0
    for t in points:
        j = bisect_right(starts, t)
        while i < j:
            stack.append(host[i])
            i += 1
        # an operation that ended under the top is popped once exposed
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host op)")
    return names


def summarize(prof, window_s: float, program_spans=()) -> TraceSummary:
    """Reduce a finished profiler's events to a ``TraceSummary``, the
    program's spans named in ``program_spans`` by their launches."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = (CALL_SPAN, PC_SPAN)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    marks = [e for e in events
             if e.device_type != DeviceType.CPU and e.name in spans]
    dev = [e for e in events
           if e.device_type != DeviceType.CPU and e.name not in spans]
    out = TraceSummary(window_s=window_s, device_ops=len(dev))
    ops = sorted((e.time_range.start, e.time_range.end) for e in dev)
    out.busy_s = union_length(ops) / 1e6
    out.span_count = dict(Counter(e.name for e in cpu if e.name in spans))
    for name in spans:
        out.span_device_s[name] = span_device_s(
            ops, [(e.time_range.start, e.time_range.end) for e in marks
                  if e.name == name])
    launched_under(out, cpu, dev,
                   [n for n in dict.fromkeys(program_spans) if n not in spans])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:NAME_CHARS]] += (e.time_range.end
                                         - e.time_range.start) / 1e6
    out.top_ops = [[k, v] for k, v in
                   sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    calls = [e for e in cpu if e.name == CALL_SPAN]
    if calls and ops:
        thread = calls[0].thread
        lo = min(e.time_range.start for e in calls)
        hi = max(e.time_range.end for e in calls)
        gaps = [g for g in idle_gaps(ops) if g[0] >= lo and g[1] <= hi]
        host = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
                if e.thread == thread]
        # at a gap's middle the device waits for the host, so the host
        # operation running then is what the device waited on
        mids = [(g0 + g1) / 2 for g0, g1 in gaps]
        by_op = defaultdict(float)
        for (g0, g1), name in zip(gaps, host_op_at(host, mids)):
            by_op[name] += (g1 - g0) / 1e6
        out.idle_gaps = [[k, v] for k, v in
                         sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]
    return out


def span_device_s(ops, marks) -> float:
    """Seconds of the device operations ``ops`` (sorted ``(start, end)``)
    that start inside one of the span intervals ``marks``."""
    total, i = 0.0, 0
    for m0, m1 in sorted(marks):
        while i < len(ops) and ops[i][0] < m0:
            i += 1
        while i < len(ops) and ops[i][0] <= m1:
            total += ops[i][1] - ops[i][0]
            i += 1
    return total / 1e6


def launched_under(out: TraceSummary, cpu, dev, names) -> None:
    """For each span name of ``names``, into ``out``: how many times it ran
    on the host, and the device operations of ``dev`` launched while one
    of its instances was open and their device seconds; and how many
    device operations matched no launch.  ``cpu`` holds the host events."""
    launched_at, intervals = {}, {name: [] for name in names}
    for e in cpu:
        # the CUDA API calls carry the correlation id of what they launch
        if e.name.startswith("cu"):
            launched_at[e.id] = e.time_range.start
        elif e.name in intervals:
            intervals[e.name].append((e.time_range.start, e.time_range.end))
    open_at = {}                # name -> (starts, ends) of merged instances
    for name, iv in intervals.items():
        out.span_count[name] = len(iv)
        merged = []
        for s, e in sorted(iv):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        open_at[name] = ([m[0] for m in merged], [m[1] for m in merged])
    ops, busy = Counter(), defaultdict(float)
    for op in dev:
        t = launched_at.get(op.id)
        if t is None:
            out.unmatched_ops += 1
            continue
        for name, (starts, ends) in open_at.items():
            i = bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                ops[name] += 1
                busy[name] += op.time_range.end - op.time_range.start
    for name in names:
        out.span_ops[name] = ops[name]
        out.span_device_s[name] = busy[name] / 1e6

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


def summarize(prof, window_s: float) -> TraceSummary:
    """Reduce a finished profiler's events to a ``TraceSummary``."""
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

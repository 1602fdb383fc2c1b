"""Device time of one preconditioner apply, ms: the device operations
launched under the harness's span around ``pc.apply`` / ``pc.apply_many``,
over the spans."""

from benchmark.trace import PC_SPAN


def read(run):
    t = run.trace
    count = t.span_count.get(PC_SPAN, 0) if t else 0
    busy = t.span_device_s.get(PC_SPAN, 0.0) if t else 0.0
    return busy / count * 1e3 if count and busy > 0 else None

"""What the readers of the program's spans share."""


def device_ms_per_span(run, name):
    """Device ms of the operations launched inside the program's span
    ``name``, per instance of it in the traced window; None where the span
    did not run or launched no device time (a trace with no device
    activity)."""
    t = run.trace
    count = t.span_count.get(name, 0) if t else 0
    busy = t.span_device_s.get(name, 0.0) if t else 0.0
    return busy / count * 1e3 if count and busy > 0 else None

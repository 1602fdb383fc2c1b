"""Device time of one preconditioner apply, ms: the device operations
launched under the harness's span around ``pc.apply`` / ``pc.apply_many``,
over the spans."""

from benchmark.metrics._spans import device_ms_per_span
from benchmark.trace import PC_SPAN


def read(run):
    return device_ms_per_span(run, PC_SPAN)

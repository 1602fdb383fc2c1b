"""Device time of one partition sweep, ms: the device operations launched
inside the program's ``SPIKESweep`` span (``ops/spike.py``: the sweep
kernel, #1, #3, #4, #5 or #9, or the plain sweep), per span."""

from benchmark.metrics._spans import device_ms_per_span

SPANS = ("SPIKESweep",)


def read(run):
    return device_ms_per_span(run, "SPIKESweep")

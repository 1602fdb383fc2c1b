"""Device time of one SPIKE reduced solve, ms: the device operations
launched inside the program's ``SPIKEReduced`` span (``ops/spike.py``:
#10, or the truncated system's block products), per span."""

from benchmark.metrics._spans import device_ms_per_span

SPANS = ("SPIKEReduced",)


def read(run):
    return device_ms_per_span(run, "SPIKEReduced")

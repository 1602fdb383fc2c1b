"""Device time of one operator apply, ms: the device operations launched
inside the program's ``MatMult`` span (the composed operator of
``solvers/ksp.py``, every route, the true residual's too), per span."""

from benchmark.metrics._spans import device_ms_per_span

SPANS = ("MatMult",)


def read(run):
    return device_ms_per_span(run, "MatMult")

"""Device time a Krylov iteration outside the preconditioner, ms: the
device operations launched in the window's calls less those under the PC
apply spans, over the iterations (a call's iterations are the most of its
columns')."""

from benchmark.trace import CALL_SPAN, PC_SPAN


def read(run):
    t = run.trace
    if t is None or not run.call_its:
        return None
    rest = t.span_device_s.get(CALL_SPAN, 0.0) - t.span_device_s.get(
        PC_SPAN, 0.0)
    its = sum(run.call_its)
    return rest / its * 1e3 if rest > 0 and its else None

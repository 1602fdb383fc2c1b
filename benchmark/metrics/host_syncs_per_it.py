"""The Krylov loop's host reads per iteration: the program's
``KSPHostSync`` spans (one a device-to-host read the loop waits on,
``_host`` of ``solvers/krylov.py`` and ``solvers/krylov_many.py``) in the
traced window, over the window's iterations (a call's iterations the most
of its columns').  The reads a call makes outside its iterations (the
initial norms, the final residual) count too."""

SPANS = ("KSPHostSync",)


def read(run):
    t = run.trace
    count = t.span_count.get("KSPHostSync", 0) if t else 0
    its = sum(run.call_its)
    return count / its if count and its else None

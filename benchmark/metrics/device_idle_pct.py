"""The device's idle share of the traced window, %: one less the union of
its operations' intervals over the window (host clock).  Tracing's own
cost on the host is in it."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100

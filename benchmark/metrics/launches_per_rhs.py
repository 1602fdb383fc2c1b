"""Device operations (kernels, copies, sets) in the traced window per
right-hand side the window solved."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops or not run.columns:
        return None
    return t.device_ops / run.columns

"""Right-hand sides solved per second: the columns that converged and held
the check, over the window's whole length (host clock)."""


def read(run):
    return run.columns_ok / run.window_s if run.window_s > 0 else None

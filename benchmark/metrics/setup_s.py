"""Set-up: the harness's start to the end of warm-up, s (host clock)."""


def read(run):
    return run.setup_s

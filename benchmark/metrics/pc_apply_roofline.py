"""The preconditioner apply's share of its roofline, %: the least time the
apply's bytes take at the card's peak bandwidth (``_roofline.apply_bytes``,
from the configuration's sizes and stored dtypes) over ``pc_apply_ms``."""

from benchmark.metrics import _roofline, pc_apply_ms


def read(run):
    ms = pc_apply_ms.read(run)
    if ms is None:
        return None
    least = _roofline.least_ms(_roofline.apply_bytes(
        _roofline.spike_geometry(run.cfg), run.traffic["columns"]))
    return least / ms * 100

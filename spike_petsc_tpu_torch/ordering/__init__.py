"""Reordering/scaling pipeline (MatOrdering registry equivalent).

Importing this package registers the built-in orderings — natural, wbm (MC64
job 5), awbm, rcm, fiedler, spectral — mirroring the reference's LoadModules
registration (reference/src/testbed2.c:61-73).
"""

from .base import OrderingResult, identity_ordering, invert_permutation
from .mc64 import mc64
from .awbm import awbm
from .rcm import rcm
from .fiedler import fiedler, fiedler_vector, graph_laplacian
from .partition import PartitionResult, spectral_partition
from ..utils.registry import ORDERINGS
from ..utils.options import Options


def get_ordering(a, name: str, options: Options = None) -> OrderingResult:
    """MatGetOrdering equivalent (reference/src/testbed.c:205)."""
    return ORDERINGS.get(name)(a, options)


__all__ = [
    "OrderingResult", "identity_ordering", "invert_permutation",
    "mc64", "awbm", "rcm", "fiedler", "fiedler_vector", "graph_laplacian",
    "PartitionResult", "spectral_partition", "get_ordering",
]

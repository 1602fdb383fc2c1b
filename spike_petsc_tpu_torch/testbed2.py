"""Composable-solver testbed (reference testbed2.c equivalent).

The reference's second testbed exists only to register the full plugin set —
fiedler, PCBANDED, KSPREORDER — so they are reachable from the options
database inside composed solvers (reference/src/testbed2.c:4, 61-73).
In this framework registration is import-time, so testbed2 shares testbed's
implementation; it exists so reference users find the same entry point:

    python -m spike_petsc_tpu_torch.testbed2 -problem spd:2000:4 \\
        -ksp_type cg -pc_type lu -ksp_rtol 1e-10

Symmetry is reported like the reference's check (reference/src/
testbed2.c:97-99).
"""

from __future__ import annotations

import sys
from typing import Optional

from .testbed import main as _main


def main(argv=None, record: Optional[dict] = None) -> int:
    """The testbed on ``argv`` with the symmetry report; ``record`` as for
    ``testbed.main``."""
    argv = sys.argv[1:] if argv is None else argv
    return _main(list(argv) + ["-report_symmetry", "1"], record=record)


if __name__ == "__main__":
    raise SystemExit(main())

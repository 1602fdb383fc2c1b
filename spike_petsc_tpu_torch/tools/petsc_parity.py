"""PETSc residual-history parity harness (SURVEY.md §4: "reference-parity
integration tests ... same residual histories ±1 iteration"), the port's
copy of the JAX package's ``tools/petsc_parity.py``: the same cases,
tolerances and comparison; ``run_ours`` runs the port's Krylov solvers on
the card unless ``device`` names another.

The reference's oracle is PETSc's own KSP (reference/src/testbed.c:316
with the canned GMRES recipe reference/src/makefile:17-18).  Where no
PETSc build exists, the harness has three operating modes:

1. **Recorder** (run where petsc4py IS available)::

       python -m spike_petsc_tpu_torch.tools.petsc_parity record \
           [-o tests/golden/petsc_histories.json]

   runs every parity case through PETSc KSP and writes the residual
   histories as a golden file.

2. **Golden comparison** (tests/test_torch_petsc_parity.py): when the
   golden file exists, our solvers are compared against the recorded
   histories with no PETSc dependency.

3. **Live comparison**: when petsc4py is importable, the same cases run
   through both stacks in-process.

Norm semantics: every case uses the PETSc DEFAULT monitor norm for its KSP
type (gmres: PRECONDITIONED — identical to our left-pc gmres history;
cg: PRECONDITIONED aka natural-equivalent monitoring).  bcgs cases compare
iteration counts only (BiCGStab's half-step recurrences make per-iteration
histories implementation-defined).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

import numpy as np

from ..models import problems

GOLDEN_PATH = "tests/golden/petsc_histories.json"

# (name, fixture builder, ksp, pc, rtol, maxit, restart)
CASES = [
    # 1-D Laplacian under FULL (unrestarted) GMRES — restarted GMRES(30)
    # famously stalls on this spectrum, in PETSc just as here
    ("lap1d_gmres_none", lambda: problems.tridiag_laplacian(120),
     "gmres", "none", 1e-8, 130, 130),
    ("lap1d_gmres_jacobi", lambda: problems.tridiag_laplacian(120),
     "gmres", "jacobi", 1e-8, 130, 130),
    ("spd_cg_jacobi", lambda: problems.spd_banded(300, 4, seed=1),
     "cg", "jacobi", 1e-8, 300, 0),
    ("nonsym_gmres_jacobi", lambda: problems.nonsym_banded(300, 3, 3,
                                                           seed=2),
     "gmres", "jacobi", 1e-8, 300, 30),
    ("nonsym_bcgs_jacobi", lambda: problems.nonsym_banded(300, 3, 3, seed=3),
     "bcgs", "jacobi", 1e-8, 300, 0),
]

# histories are compared only while the residual is safely above the f64
# noise floor; PETSc CGS+refinement vs our MGS orthogonalization diverge in
# the last digits near machine precision
HIST_RTOL = 0.05
HIST_FLOOR = 1e-12


def _rhs_for(a) -> np.ndarray:
    """Manufactured u=1 RHS, as the testbeds (testbed.c:300-310)."""
    return np.asarray(a @ np.ones(a.shape[0]))


def run_ours(a, ksp: str, pc: str, rtol: float, maxit: int,
             restart: int, device=None) -> Dict:
    """Run our KSP on fixture ``a`` (a dense f64 operator on ``device``,
    the card by default); returns {its, history}."""
    import torch

    from ..solvers import krylov

    device = torch.device(device or "cuda")
    dense = torch.as_tensor(a.toarray()).to(device)
    b = torch.as_tensor(_rhs_for(a)).to(device)
    mv = lambda v: dense @ v  # noqa: E731
    if pc == "jacobi":
        dinv = 1.0 / torch.as_tensor(a.diagonal()).to(device)
        pc_apply = lambda r: dinv * r  # noqa: E731
    elif pc == "none":
        pc_apply = None
    else:
        raise ValueError(pc)
    fn = {"gmres": krylov.gmres, "cg": krylov.cg,
          "bcgs": krylov.bicgstab}[ksp]
    kwargs = dict(rtol=rtol, maxit=maxit)
    if ksp == "gmres":
        kwargs["restart"] = restart
    res = fn(mv, b, None, pc_apply, **kwargs)
    its = int(res.its)
    hist = torch.as_tensor(res.history).cpu().numpy()[:its + 1]
    return {"its": its, "history": [float(h) for h in hist]}


def run_petsc(a, ksp: str, pc: str, rtol: float, maxit: int,
              restart: int) -> Dict:
    """Run PETSc KSP on fixture ``a`` (requires petsc4py)."""
    from petsc4py import PETSc

    a = a.tocsr()
    A = PETSc.Mat().createAIJ(size=a.shape,
                              csr=(a.indptr.astype(np.int32),
                                   a.indices.astype(np.int32),
                                   a.data.astype(np.float64)))
    A.assemble()
    b = A.createVecLeft()
    b.setArray(_rhs_for(a))
    x = A.createVecRight()

    k = PETSc.KSP().create()
    k.setOperators(A)
    k.setType({"gmres": "gmres", "cg": "cg", "bcgs": "bcgs"}[ksp])
    k.getPC().setType({"none": "none", "jacobi": "jacobi"}[pc])
    k.setTolerances(rtol=rtol, max_it=maxit)
    if ksp == "gmres" and restart:
        k.setGMRESRestart(restart)
    hist: List[float] = []
    k.setMonitor(lambda _k, it, rn: hist.append(float(rn)))
    k.solve(b, x)
    return {"its": int(k.getIterationNumber()), "history": hist}


def compare(ours: Dict, ref: Dict, ksp: str) -> List[str]:
    """Parity assertion logic shared by the live and golden tests.
    Returns a list of mismatch descriptions (empty = parity)."""
    errs = []
    if abs(ours["its"] - ref["its"]) > (2 if ksp == "bcgs" else 1):
        errs.append(f"iterations {ours['its']} vs {ref['its']}")
    if ksp == "bcgs":
        return errs          # iteration-count-only comparison
    h0 = max(ref["history"][0], 1e-300)
    for i, (ho, hr) in enumerate(zip(ours["history"], ref["history"])):
        if hr / h0 < HIST_FLOOR or ho / h0 < HIST_FLOOR:
            break
        if abs(ho - hr) > HIST_RTOL * max(abs(hr), abs(ho)):
            errs.append(f"history[{i}]: {ho:.6e} vs {hr:.6e}")
    return errs


def record(path: str = GOLDEN_PATH) -> None:
    out = {}
    for name, fix, ksp, pc, rtol, maxit, restart in CASES:
        out[name] = {"ksp": ksp, "pc": pc, "rtol": rtol, "maxit": maxit,
                     "restart": restart,
                     **run_petsc(fix(), ksp, pc, rtol, maxit, restart)}
        print(f"recorded {name}: {out[name]['its']} its")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "record":
        path = GOLDEN_PATH
        if "-o" in argv:
            path = argv[argv.index("-o") + 1]
        record(path)
        return 0
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())

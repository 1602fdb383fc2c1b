#!/usr/bin/env python3
"""Where BASELINE config 4's Fiedler LOBPCG and the device auction spend
their time on one CUDA card, and how LOBPCG's stopping test behaves.

    python3 experiments/torch_lab_config4.py --trace
    python3 experiments/torch_lab_config4.py --profile

``--trace``: LOBPCG's residual ratio |A v - theta v| / (10 n (theta +
|A v|)) at every iteration (the quantity its test holds against ``tol``)
and lambda2, on config 4's Laplacian (``problems.general_sparse(n,
seed=6)`` scrambled as ``chip_smoke.py`` scrambles it), at n = 5000 on the
card and on the CPU (700 iterations) and at n = 1e5 on the card (1200
iterations), the seeded start of ``fiedler._fiedler_lobpcg_jax``; per run,
the first iteration whose ratio falls below each of 1e-9 ... 1e-14, a few
iterations' values and the smallest ratio; then the Fiedler ordering's own
LOBPCG at tol 1e-14 on both devices at n = 5000 (iterations, lambda2).

``--profile``: 20 LOBPCG iterations at n = 1e5 (no early exit), timed by
CUDA events and in one torch.profiler window (device busy, idle share, the
largest items); and 16 auction rounds on config 3's matrix
(``illscaled_nonsym(n, 6, 6)``) at n = 1e5 and 1e6 from the unmatched
start, likewise.

Every line printed follows the card's name and power limit.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spike_petsc_tpu_torch import sparse as hsp  # noqa: E402
from spike_petsc_tpu_torch.models import problems  # noqa: E402
from spike_petsc_tpu_torch.ordering import lobpcg as lob  # noqa: E402

fiedler = importlib.import_module("spike_petsc_tpu_torch.ordering.fiedler")
RATIOS = (1e-9, 1e-10, 1e-11, 1e-12, 1e-13, 1e-14)
SHOWN = (1, 2, 5, 10, 20, 47, 50, 100, 200, 300, 400, 500, 600, 700, 1000)


def laplacian(n):
    """Config 4's Laplacian at ``n``, scrambled as in chip_smoke.py."""
    a = problems.general_sparse(n, seed=cs.CONFIG4_SEED)
    p = np.random.default_rng(cs.CONFIG4_PERM_SEED).permutation(n)
    return fiedler.graph_laplacian(sp.csr_matrix(hsp.permute(a, p, p)))


def start(n, device):
    x0 = np.random.default_rng(0).standard_normal((n, 1))
    return torch.as_tensor(x0 - x0.mean()).to(device)


def trace(lap, device, iters):
    """``lobpcg.lobpcg_standard``'s loop (k = 1) without its exit, with
    each iteration's (ratio, lambda2)."""
    n = lap.shape[0]
    c = fiedler._gershgorin(lap)
    op = fiedler._laplacian_operator(lap, c, device)
    X = lob._orthonormalize(start(n, device))
    P = lob._extend_basis(X, 1)
    AX = op(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    out = []
    for _ in range(iters):
        R = lob._project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = lob._rayleigh_ritz_orth(op, XPR)
        B = Q[:, :1] / torch.linalg.vector_norm(Q[:, :1], dim=0,
                                                keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:1, 1:].T)
        P = XPR @ (Q[:, 1:] @ q)
        normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)
        AX = op(X)
        R = AX - theta[None, :1] * X
        rn = float(torch.linalg.vector_norm(R))
        scale = float((torch.linalg.vector_norm(AX) + theta[0]) * n * 10)
        out.append((rn / scale, c - float(theta[0])))
        theta = theta[None, :1]
    return out


def report(tag, out):
    first = {t: next(((i + 1, lam) for i, (r, lam) in enumerate(out)
                      if r < t), None) for t in RATIOS}
    print(f"{tag}: first iteration below each ratio (iteration, lambda2): "
          + ", ".join(f"{t:.0e} {v[0] if v else None}"
                      + (f" ({v[1]:.15e})" if v else "")
                      for t, v in first.items()))
    for i in SHOWN:
        if i <= len(out):
            r, lam = out[i - 1]
            print(f"  {tag} {i:5d} ratio {r:.3e} lambda2 {lam:.15e}")
    print(f"  {tag} smallest ratio {min(r for r, _ in out):.3e}")


def run_trace():
    from spike_petsc_tpu_torch.utils import profiling
    lap = laplacian(cs.CONFIG4_REF_N)
    for device in ("cuda", "cpu"):
        report(f"n={cs.CONFIG4_REF_N} {device}", trace(lap, device, 700))
        _, lam = fiedler._fiedler_lobpcg_jax(lap, tol=1e-14, seed=0,
                                             maxiter=1000, device=device)
        ev = [e for e in profiling.event_log()
              if e["event"] == "fiedler_lobpcg"][-1]
        print(f"  fiedler LOBPCG at tol 1e-14 on {device}: "
              f"{ev['iterations']} its, lambda2 {lam:.15e}")
    t0 = time.perf_counter()
    lap = laplacian(cs.CONFIG4_N)
    print(f"n={cs.CONFIG4_N} Laplacian (nnz {lap.nnz}) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    report(f"n={cs.CONFIG4_N} cuda", trace(lap, "cuda", 1200))


def lobpcg_profile(iters=20):
    """``iters`` LOBPCG iterations at config 4's n (no early exit)."""
    lap = laplacian(cs.CONFIG4_N)
    op = fiedler._laplacian_operator(lap, fiedler._gershgorin(lap), "cuda")
    X = start(lap.shape[0], "cuda")

    def run():
        return lob.lobpcg_standard(op, X, m=iters, tol=0.0)
    ms = cs.time_ms(run, reps=3)
    busy, items = cs.device_profile(run)
    print(f"LOBPCG (config 4, n={lap.shape[0]}, Laplacian nnz {lap.nnz}): "
          f"{ms[0] / iters:.3f} ms an iteration over {iters} (spread "
          f"{ms[1]:.3f} ms); device busy {busy / iters:.3f} ms an "
          f"iteration, idle share {1 - busy / ms[0]:.3f}")
    for key, count, dms in items:
        print(f"  {dms:8.3f} ms  {count:5d} x  {key}")


def auction_profile(n, rounds=16):
    """``rounds`` auction rounds at ``n`` from the unmatched start (the
    host checks the exit every ``CHECK_EVERY`` rounds, so 16 run)."""
    from spike_petsc_tpu_torch.parallel.matching_dev import (_auction_rounds,
                                                             csc_to_ell)
    rows_np, logw_np, _ = csc_to_ell(problems.illscaled_nonsym(n, 6, 6))
    rows = torch.as_tensor(rows_np.astype(np.int64)).to("cuda")
    ben = torch.as_tensor(-np.where(np.isfinite(logw_np), logw_np,
                                    np.inf)).to("cuda")

    def run():
        return _auction_rounds(rows, ben, n=n, eps=1e-3 / n,
                               max_rounds=rounds)
    ms = cs.time_ms(run, reps=3)
    busy, items = cs.device_profile(run)
    print(f"auction rounds (n={n}): {ms[0] / rounds:.3f} ms a round over "
          f"{rounds} (CUDA events), device busy {busy / rounds:.3f} ms a "
          f"round, idle share {1 - busy / ms[0]:.3f}")
    for key, count, dms in items:
        print(f"  {dms:8.3f} ms  {count:5d} x  {key}")


def main(argv):
    if not torch.cuda.is_available():
        print("torch_lab_config4: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if "--trace" in argv:
        run_trace()
    if "--profile" in argv:
        lobpcg_profile()
        for n in cs.AUCTION_N:
            auction_profile(n)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

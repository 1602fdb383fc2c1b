"""Rank programs and inputs of the distributed parity tests.

The inputs are numpy arrays made from a seed (``band``, ``rhs``), so the
JAX side of a test (in the pytest worker, on the virtual CPU devices) and
the ranks (spawned by ``torch_dist_worker.run_ranks``) see the same
matrices.  A rank program runs every case of its test file on gloo ranks
and returns ``{case: {key: array}}``; the global results are the same on
every rank.  This module imports torch, numpy and the port only.
"""

import contextlib
import io

import numpy as np
import torch

from spike_petsc_tpu_torch import sparse as hsp
from spike_petsc_tpu_torch.models import problems
from spike_petsc_tpu_torch.ops.band import BandedMatrix
from spike_petsc_tpu_torch.parallel import (dist_spike_factor,
                                            dist_spike_solve,
                                            dist_spike_solve_many,
                                            dist_spike_transpose,
                                            make_dist_solver,
                                            make_dist_solver_batched,
                                            make_mesh, make_mesh_2d)
from torch_dist_worker import run_case

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Inputs (shared with the JAX side)
# ---------------------------------------------------------------------------

def band(kind: str, n: int, k: int, seed: int, kl: int = None):
    """``(data, kl, ku)`` of a band in diagonal-offset storage: "spd"
    (``problems.spd_banded``), "nonsym" (``problems.nonsym_banded`` with
    kl = ``kl or k``, ku = k), "laplace" (the Neumann Laplacian of
    ``dryrun_multichip`` stage 4), "complex" (the diagonally dominant
    complex band of the JAX package's ``tests/test_complex.py``),
    "indefinite" (the JAX package's safety-net matrix), or "poisson" /
    "convdiff": k interleaved 1-D Poisson chains (-1, 2 + 1e-3, -1 at
    offsets -k, 0, k; "convdiff" skews them by 0.3) with small random
    inner diagonals, so barely dominant that a truncated SPIKE PC leaves a
    handful of Krylov iterations."""
    if kind == "laplace":
        lo, hi, dg = -np.ones(n), -np.ones(n), 2.0 * np.ones(n)
        dg[0] = dg[-1] = 1.0
        return np.stack([lo, dg, hi], axis=1), 1, 1
    if kind == "complex":
        rng = np.random.default_rng(seed)
        a = np.zeros((n, n), dtype=np.complex128)
        for i in range(n):
            lo, hi = max(0, i - k), min(n, i + k + 1)
            a[i, lo:hi] = rng.standard_normal(hi - lo) + \
                1j * rng.standard_normal(hi - lo)
        a[np.arange(n), np.arange(n)] = np.abs(a).sum(1) + 1.0
        data = np.zeros((n, 2 * k + 1), dtype=a.dtype)
        for d in range(-k, k + 1):
            rows = np.arange(max(0, -d), min(n, n - d))
            data[rows, d + k] = a[rows, rows + d]
        return data, k, k
    if kind in ("poisson", "convdiff"):
        rng = np.random.default_rng(seed)
        c = 0.3 if kind == "convdiff" else 0.0
        data = np.zeros((n, 2 * k + 1))
        data[:, 0], data[:, 2 * k] = -1.0 - c, -1.0 + c
        for d in range(1, k):
            rows = np.arange(n - d)
            data[rows, k + d] = rng.uniform(-0.01, 0.01, rows.size)
            data[rows + d, k - d] = (data[rows, k + d] if kind == "poisson"
                                     else rng.uniform(-0.01, 0.01, rows.size))
        for d in range(-k, k + 1):           # zero the slots off the matrix
            data[:max(0, -d), d + k] = 0.0
            data[n - max(0, d):, d + k] = 0.0
        data[:, k] = 2.0 + 1e-3 + np.abs(data[:, 1:k]).sum(1) \
            + np.abs(data[:, k + 1:2 * k]).sum(1)
        return data, k, k
    if kind == "indefinite":
        # JAX test_dist_inverter_safety_net: Newton-Schulz from the Jacobi
        # start diverges on it
        rng = np.random.default_rng(seed)
        data = np.zeros((n, 5))
        data[:, 2] = 0.05 * rng.standard_normal(n) + 0.1
        data[:-1, 3] = data[1:, 1] = 1.0
        data[:-2, 4] = data[2:, 0] = 0.8
        return data, 2, 2
    a = (problems.spd_banded(n, k, seed=seed) if kind == "spd"
         else problems.nonsym_banded(n, kl or k, k, seed=seed))
    data, kl_, ku_ = hsp.csr_to_banded_arrays(a)
    return np.asarray(data), kl_, ku_


def band_matvec_np(data, kl, ku, x):
    """A x of a diagonal-offset band, in numpy."""
    n = data.shape[0]
    y = np.zeros((n,) + x.shape[1:], dtype=np.result_type(data, x))
    for d in range(-kl, ku + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        col = data[rows, d + kl]
        y[rows] += col.reshape((-1,) + (1,) * (x.ndim - 1)) * x[rows + d]
    return y


def rhs(n: int, seed: int, r: int = None, complex_: bool = False):
    rng = np.random.default_rng(seed)
    shape = (n,) if r is None else (n, r)
    v = rng.standard_normal(shape)
    if complex_:
        v = v + 1j * rng.standard_normal(shape)
    return v


#: dist_spike_solve cases: name -> (band args, factor options)
SOLVE_CASES = {
    "inv_ppd1": (("nonsym", 600, 3, 11, 2), dict(block_b=8)),
    "inv_ppd2": (("nonsym", 600, 3, 12, 2), dict(block_b=8,
                                                 parts_per_device=2)),
    "spd_ppd2": (("spd", 600, 3, 13), dict(block_b=8, parts_per_device=2,
                                           method="spd")),
    "lu_ppd2": (("nonsym", 600, 3, 14, 2), dict(block_b=8, parts_per_device=2,
                                                method="lu")),
    "cr_ppd2": (("nonsym", 600, 3, 15, 2), dict(block_b=8, parts_per_device=2,
                                                method="cr")),
    "truncated": (("spd", 600, 3, 16), dict(block_b=8, parts_per_device=2,
                                            truncated=True)),
    "shift": (("nonsym", 600, 3, 17, 2), dict(block_b=8, parts_per_device=2,
                                              shift="nonzero")),
    "stored_bf16": (("nonsym", 600, 3, 18, 2), dict(
        block_b=8, parts_per_device=2, store_spikes=True,
        spike_dtype="bf16")),
    "reduced_cr": (("nonsym", 600, 3, 19, 2), dict(
        block_b=8, parts_per_device=2, reduced="cr", store_spikes=True)),
}

#: make_dist_solver cases: name -> (band args, factor options, ksp options)
KRYLOV_CASES = {
    "gmres": (("nonsym", 800, 3, 21, 2), dict(block_b=8, parts_per_device=2),
              dict(ksp_type="gmres", rtol=1e-10, maxit=50)),
    "gmres_ifneeded": (("convdiff", 800, 3, 22), dict(
        block_b=8, truncated=True),
        dict(ksp_type="gmres", rtol=1e-10, maxit=50, restart=4,
             cgs_refinement="ifneeded")),
    "gmres_truncated": (("convdiff", 800, 3, 27), dict(
        block_b=8, parts_per_device=2, truncated=True),
        dict(ksp_type="gmres", rtol=1e-10, maxit=50)),
    "bcgs": (("convdiff", 800, 3, 23), dict(block_b=8, truncated=True),
             dict(ksp_type="bcgs", rtol=1e-10, maxit=50)),
    "cg": (("poisson", 800, 3, 24), dict(block_b=8, parts_per_device=2,
                                         truncated=True, method="spd"),
           dict(ksp_type="cg", rtol=1e-10, maxit=50)),
    "tfqmr": (("convdiff", 800, 3, 25), dict(block_b=8, truncated=True),
              dict(ksp_type="tfqmr", rtol=1e-10, maxit=50)),
    "bicg": (("convdiff", 800, 3, 26), dict(block_b=8, parts_per_device=2,
                                            truncated=True),
             dict(ksp_type="bicg", rtol=1e-10, maxit=50)),
}

#: 2-D (rhs x p) serving cases: name -> (band, factor options, solver
#: options, float32?)
BATCHED_CASES = {
    "preonly": (("nonsym", 512, 3, 31, 2), dict(block_b=8, parts_per_device=2),
                dict(ksp_type="preonly"), False),
    "richardson_bf16": (("nonsym", 512, 3, 32, 2), dict(
        block_b=8, parts_per_device=2, store_dtype="bf16"),
        dict(ksp_type="richardson", rtol=1e-6, maxit=40), True),
    "gmres": (("convdiff", 512, 3, 33), dict(block_b=8, truncated=True),
              dict(ksp_type="gmres", rtol=1e-10, maxit=40), False),
    "bcgs": (("convdiff", 512, 3, 34), dict(block_b=8, truncated=True),
             dict(ksp_type="bcgs", rtol=1e-10, maxit=40), False),
    "cg": (("poisson", 512, 3, 35), dict(block_b=8, truncated=True,
                                         method="spd"),
           dict(ksp_type="cg", rtol=1e-10, maxit=40), False),
    "tfqmr_per_rhs": (("convdiff", 512, 3, 36), dict(block_b=8,
                                                     truncated=True),
                      dict(ksp_type="tfqmr", rtol=1e-10, maxit=40), False),
}
BATCHED_R = 4                    # right-hand sides, two a mesh row


def torch_options(opts: dict) -> dict:
    """Factor options with the dtype names resolved for the port."""
    names = {"bf16": torch.bfloat16}
    return {k: names.get(v, v) if k.endswith("dtype") else v
            for k, v in opts.items()}


def _band_t(args, dtype=torch.float64):
    data, kl, ku = band(*args)
    t = torch.as_tensor(data)
    if not t.is_complex():
        t = t.to(dtype)
    return BandedMatrix(data=t, kl=kl, ku=ku), data, kl, ku


def _np(t):
    return t.detach().cpu().to(torch.complex128 if t.is_complex()
                               else torch.float64).numpy()


def _gathered(mesh, t):
    return _np(mesh.axis("p").all_gather(t).reshape((-1,) + t.shape[1:]))


def _krylov_out(res):
    return dict(x=_np(res.x), its=res.its, reason=res.reason,
                rnorm=res.rnorm, history=_np(res.history))


# ---------------------------------------------------------------------------
# tests/test_torch_dist.py: factor pieces and direct solves
# ---------------------------------------------------------------------------

def _factor_pieces(mesh):
    bm, *_ = _band_t(("nonsym", 640, 3, 1, 2))
    out = {}
    for trunc in (False, True):
        dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                                truncated=trunc)
        tag = "t_" if trunc else ""
        out[tag + "Btip"] = _gathered(mesh, dsf.Btip)
        out[tag + "Ctip"] = _gathered(mesh, dsf.Ctip)
        if trunc:
            out["red_Dinv"] = _np(dsf.red_Dinv)
        else:
            for f in ("F", "U", "Sinv"):
                out["red_" + f] = _np(getattr(dsf.red_fact, f))
    return out


def _solve_case(mesh, case):
    args, opts = SOLVE_CASES[case]
    bm, data, *_ = _band_t(args)
    dsf = dist_spike_factor(bm, mesh, **torch_options(opts))
    return dict(x=_np(dist_spike_solve(dsf, torch.as_tensor(
        rhs(bm.n, 100)), mesh)))


def _solve_many(mesh, r):
    bm, *_ = _band_t(("nonsym", 512, 3, 47, 2))
    dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                            store_spikes=True)
    return dict(x=_np(dist_spike_solve_many(
        dsf, torch.as_tensor(rhs(bm.n, 101, r)), mesh)))


def _safety_net(mesh):
    bm, *_ = _band_t(("indefinite", 320, 2, 5))
    dsf = dist_spike_factor(bm, mesh, block_b=4, inverter="newton")
    x = dist_spike_solve(dsf, torch.as_tensor(rhs(320, 102)), mesh)
    return dict(x=_np(x))


def _safety_net_healthy(mesh):
    bm, *_ = _band_t(("spd", 256, 3, 43))
    net = dist_spike_factor(bm, mesh, block_b=4, inverter="newton")
    raw = dist_spike_factor(bm, mesh, block_b=4, inverter="newton",
                            safety_net=False)
    return dict(equal=torch.equal(net.fact.Sinv, raw.fact.Sinv),
                Sinv=_gathered(mesh, net.fact.Sinv))


def _complex_solve(mesh):
    bm, *_ = _band_t(("complex", 384, 3, 21))
    dsf = dist_spike_factor(bm, mesh, block_b=8)
    b = torch.as_tensor(rhs(384, 103, complex_=True))
    x = dist_spike_solve(dsf, b, mesh)
    res = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-10,
                           maxit=20)(b)
    return dict(x=_np(x), **{"k_" + k: v
                             for k, v in _krylov_out(res).items()})


def _one_rank(mesh1):
    """P = 1 (no send or recv) against the single-device spike_solve on the
    same factor settings, and the Krylov reduction hook bit-identical to
    the call without an axis on a one-rank group."""
    from spike_petsc_tpu_torch.ops.spike import spike_factor, spike_solve
    from spike_petsc_tpu_torch.parallel.spike_dist import (local_matvec,
                                                           local_spike_solve)
    from spike_petsc_tpu_torch.solvers import krylov
    bm, *_ = _band_t(("nonsym", 600, 3, 51, 2))
    b = torch.as_tensor(rhs(600, 104))
    dsf = dist_spike_factor(bm, mesh1, block_b=8, parts_per_device=4,
                            store_spikes=True)
    sf = spike_factor(bm, 4, block_b=8, store_spikes=True)
    out = dict(x_dist=_np(dist_spike_solve(dsf, b, mesh1)),
               x_single=_np(spike_solve(sf, b)))
    # the hook on a truncated PC, which leaves several iterations
    bm, *_ = _band_t(("poisson", 600, 3, 52))
    dsf = dist_spike_factor(bm, mesh1, block_b=8, parts_per_device=8,
                            truncated=True, method="spd")
    ax = mesh1.axis("p")
    bl = torch.zeros(dsf.K * dsf.m, dtype=b.dtype)
    bl[:600] = b

    def mv(v):
        return local_matvec(dsf, v, ax)

    def pc(v):
        return local_spike_solve(dsf, v, ax)
    for name, fn in (("gmres", krylov.gmres), ("bcgs", krylov.bicgstab),
                     ("cg", krylov.cg)):
        kw = dict(rtol=1e-12, maxit=30)
        a = fn(mv, bl, None, pc, axis_name=ax, **kw)
        z = fn(mv, bl, None, pc, **kw)
        hist_a, hist_z = _np(a.history), _np(z.history)
        out[name + "_bits"] = bool(
            torch.equal(a.x, z.x) and a.its == z.its
            and np.array_equal(hist_a, hist_z, equal_nan=True)
            and a.rnorm == z.rnorm)
        out[name + "_its"] = a.its
        out[name + "_reason"] = a.reason
    return out


def dist_program(rank, world):
    """tests/test_torch_dist.py on ``world`` ranks."""
    mesh = make_mesh(device="cpu")
    res = {}
    run_case(res, "factor_pieces", _factor_pieces, mesh)
    for case in SOLVE_CASES:
        run_case(res, "solve_" + case, _solve_case, mesh, case)
    for r in (2, 5):
        run_case(res, f"solve_many_{r}", _solve_many, mesh, r)
    run_case(res, "safety_net", _safety_net, mesh)
    run_case(res, "safety_net_healthy", _safety_net_healthy, mesh)
    run_case(res, "complex", _complex_solve, mesh)
    try:
        mesh1 = make_mesh(1, device="cpu")        # every rank makes it
    except ValueError:
        mesh1 = None                              # ranks outside the mesh
    if mesh1 is not None:
        run_case(res, "one_rank", _one_rank, mesh1)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_krylov.py: make_dist_solver
# ---------------------------------------------------------------------------

def _krylov_case(mesh, case):
    args, fopts, kopts = KRYLOV_CASES[case]
    bm, data, kl, ku = _band_t(args)
    dsf = dist_spike_factor(bm, mesh, **fopts)
    kw = dict(kopts)
    if kw["ksp_type"] == "bicg":
        kw["dsf_transpose"] = dist_spike_transpose(dsf, mesh)
    res = make_dist_solver(dsf, mesh, **kw)(
        torch.as_tensor(band_matvec_np(data, kl, ku, np.ones(bm.n))))
    out = _krylov_out(res)
    if kw["ksp_type"] == "bicg":
        out["xt"] = _np(dist_spike_solve(kw["dsf_transpose"], torch.as_tensor(
            rhs(bm.n, 105)), mesh))
    return out


def nullspace_input(n: int):
    """The Neumann solve of ``dryrun_multichip`` stage 4: ``(data, u, b)``
    with u the mean-free solution and b = A u + 0.5 (inconsistent)."""
    data, _, _ = band("laplace", n, 1, 0)
    u = rhs(n, 0)
    u = u - u.mean()
    return data, u, band_matvec_np(data, 1, 1, u) + 0.5


def nullspace_geometry(world: int):
    """``(n, ppd)`` of the Neumann solve: 16-row partitions, n >= 256."""
    ppd = max(1, 256 // (world * 16))
    return world * ppd * 16, ppd


def _nullspace(mesh):
    from spike_petsc_tpu_torch.solvers.nullspace import make_nullspace
    n, ppd = nullspace_geometry(mesh.shape["p"])
    data, _, b = nullspace_input(n)
    bm = BandedMatrix(data=torch.as_tensor(data), kl=1, ku=1)
    ns = make_nullspace(n, constant=True, dtype=torch.float64, device=CPU)
    dsf = dist_spike_factor(bm, mesh, block_b=4, parts_per_device=ppd,
                            shift="nonzero", shift_amount=1e-2)
    res = make_dist_solver(dsf, mesh, ksp_type="cg", nullspace=ns,
                           rtol=1e-6, maxit=100)(torch.as_tensor(b))
    return _krylov_out(res)


def banded_route_input(world: int):
    """The banded-route problem of ``dryrun_multichip`` stage 2, f32:
    ``(data, kl, ku)`` with 2 partitions of 128 rows a rank."""
    return band("spd", world * 2 * 128, 2, 3)


def _banded_route(mesh, world):
    data, kl, ku = banded_route_input(world)
    bm = BandedMatrix(data=torch.as_tensor(data, dtype=torch.float32),
                      kl=kl, ku=ku)
    b = torch.as_tensor(band_matvec_np(data, kl, ku, np.ones(bm.n)),
                        dtype=torch.float32)
    out = {}
    for impl in ("banded_pallas", "blocks"):
        dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                                matvec_impl=impl)
        out[impl + "_route"] = dsf.matvec_route
        res = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-6,
                               maxit=10)(b)
        out.update({f"{impl}_{k}": v for k, v in _krylov_out(res).items()})
    return out


def krylov_program(rank, world):
    """tests/test_torch_dist_krylov.py on ``world`` ranks."""
    mesh = make_mesh(device="cpu")
    res = {}
    for case in KRYLOV_CASES:
        run_case(res, case, _krylov_case, mesh, case)
    run_case(res, "nullspace", _nullspace, mesh)
    run_case(res, "banded_route", _banded_route, mesh, world)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_batched.py: the 2-D (rhs x p) mesh
# ---------------------------------------------------------------------------

def batched_input(case: str):
    args, fopts, sopts, f32 = BATCHED_CASES[case]
    data, kl, ku = band(*args)
    R = np.stack([band_matvec_np(data, kl, ku, rhs(data.shape[0], 200 + j))
                  for j in range(BATCHED_R)])
    return data, kl, ku, R


def _batched(mesh2, case):
    args, fopts, sopts, f32 = BATCHED_CASES[case]
    data, kl, ku, R = batched_input(case)
    dt = torch.float32 if f32 else torch.float64
    bm = BandedMatrix(data=torch.as_tensor(data, dtype=dt), kl=kl, ku=ku)
    dsf = dist_spike_factor(bm, mesh2, axis="p", **torch_options(fopts))
    solve = make_dist_solver_batched(dsf, mesh2, **sopts)
    return dict(x=_np(solve(torch.as_tensor(R, dtype=dt))))


def batched_program(rank, world):
    """tests/test_torch_dist_batched.py on the (2, 2) mesh."""
    mesh2 = make_mesh_2d((2, world // 2), axes=("rhs", "p"), device="cpu")
    res = {}
    for case in BATCHED_CASES:
        run_case(res, case, _batched, mesh2, case)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_sync_print.py
# ---------------------------------------------------------------------------

def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def sync_print_program(rank, world):
    from spike_petsc_tpu_torch.utils.sync_print import sync_print
    ax = make_mesh(device="cpu").axis("p")
    res = {}
    run_case(res, "values", lambda: dict(out=_printed(lambda: sync_print(
        "value = {:.1f}", torch.tensor(rank * 10.0), axis=ax))))
    run_case(res, "no_args", lambda: dict(out=_printed(
        lambda: sync_print("here", axis=ax))))
    return res

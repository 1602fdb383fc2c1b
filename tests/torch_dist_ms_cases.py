"""Rank programs and inputs of the parity tests of the multislice and 3-D
meshes, the mesh autodiff, the elastic solves and the mesh auction
(tests/test_torch_dist_multislice.py, test_torch_dist_3d.py,
test_torch_dist_autodiff.py, test_torch_elastic.py,
test_torch_elastic_serve.py, test_torch_dist_auction.py).

As in ``torch_dist_cases``: the inputs are numpy arrays made from a seed,
shared with the JAX side of each test; a rank program runs every case of
its file on gloo ranks (``torch_dist_worker.run_ranks``) and returns
``{case: {key: array}}``.  This module imports torch, numpy and the port
only.
"""

import os
import shutil

import numpy as np
import torch

from spike_petsc_tpu_torch.models import problems
from spike_petsc_tpu_torch.ops.band import BandedMatrix
from spike_petsc_tpu_torch.parallel import (
    dist_solve_banded_diff, dist_solve_banded_diff_multislice,
    dist_spike_factor, dist_spike_factor_multislice,
    dist_spike_transpose_multislice, make_dist_solver,
    make_dist_solver_3d, make_dist_solver_multislice,
    make_dist_solver_multislice_batched, make_mesh, make_mesh_3d,
    make_mesh_multislice)
from torch_dist_cases import (_krylov_out, _np, band, band_matvec_np, rhs,
                              torch_options)
from torch_dist_worker import run_case

CPU = torch.device("cpu")
#: the directory the elastic checkpoints are exchanged through
CKPT_DIR_ENV = "SPIKE_TEST_CKPT_DIR"


def _band_t(args, dtype=torch.float64):
    data, kl, ku = band(*args)
    return BandedMatrix(data=torch.as_tensor(data).to(dtype), kl=kl,
                        ku=ku), data, kl, ku


def _plane_gather(mesh, t):
    """This plane's ``[K, ...]`` from every rank's ``[ppd, ...]``."""
    return _np(mesh.axis(("slice", "p")).all_gather(t).reshape(
        (-1,) + tuple(t.shape[1:])))


def member(make, *args):
    """``make(*args)`` on every rank; None on the ranks outside it."""
    try:
        return make(*args, device="cpu")
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# tests/test_torch_dist_multislice.py: the (2, 2) mesh
# ---------------------------------------------------------------------------

#: the factor pieces: band, factor options
MS_FACTOR = (("nonsym", 640, 2, 9, 3),
             dict(block_b=8, parts_per_device=2, store_spikes=True))

#: make_dist_solver_multislice: band, factor options, ksp options, u seed
MS_KRYLOV = {
    "gmres_stored": (("spd", 768, 4, 61), dict(
        block_b=8, parts_per_device=2, store_spikes=True),
        dict(ksp_type="gmres", rtol=1e-10, maxit=40), 13),
    "gmres_bf16": (("spd", 768, 4, 61), dict(
        block_b=8, parts_per_device=2, store_spikes=True,
        spike_dtype="bf16"),
        dict(ksp_type="gmres", rtol=1e-10, maxit=40), 13),
    "gmres_lu": (("nonsym", 512, 2, 64, 3), dict(
        block_b=8, parts_per_device=2, method="lu"),
        dict(ksp_type="gmres", rtol=1e-10, maxit=40), 14),
}

#: make_dist_solver_multislice_batched: band, factor options, ksp options,
#: columns, mesh
MS_BATCHED = {
    "richardson": (("spd", 768, 4, 71), dict(
        block_b=8, parts_per_device=2, store_spikes=True),
        dict(ksp_type="richardson", rtol=1e-9, maxit=40), 5, (2, 2)),
    "preonly_one_slice": (("spd", 512, 3, 73), dict(block_b=8),
                          dict(ksp_type="preonly"), 3, (1, 4)),
    "preonly": (("spd", 512, 3, 73), dict(block_b=8),
                dict(ksp_type="preonly"), 3, (2, 2)),
    "gmres": (("nonsym", 512, 2, 75, 3), dict(block_b=8),
              dict(ksp_type="gmres", rtol=1e-10, maxit=40), 3, (2, 2)),
    "bcgs": (("nonsym", 512, 2, 63, 3), dict(
        block_b=8, parts_per_device=2, store_spikes=True),
        dict(ksp_type="bcgs", rtol=1e-11, maxit=40), 5, (2, 2)),
    "tfqmr_per_rhs": (("nonsym", 512, 2, 76, 3), dict(block_b=8),
                      dict(ksp_type="tfqmr", rtol=1e-10, maxit=40), 2,
                      (2, 2)),
}

#: the transpose: band, factor options, the seeds of g and u
MS_TRANSPOSE = (("nonsym", 640, 2, 9, 3),
                dict(block_b=8, parts_per_device=2, store_spikes=True), 42,
                43)


def batched_input(case):
    args, _, _, r, _ = MS_BATCHED[case]
    data, kl, ku = band(*args)
    U = np.stack([rhs(data.shape[0], 300 + j) for j in range(r)], axis=1)
    return data, kl, ku, U, band_matvec_np(data, kl, ku, U)


def neumann_band(n):
    """The Neumann Laplacian of the JAX package's nullspace tests."""
    data, _, _ = band("laplace", n, 1, 0)
    return data


def nullspace_u(n):
    u = rhs(n, 8)
    return u - u.mean()


#: the null-space solve: n, factor options, ksp options
MS_NULLSPACE = (512, dict(method="lu", shift="nonzero", shift_amount=1e-2),
                dict(ksp_type="gmres", rtol=1e-12, maxit=200, restart=60))
#: the banded route (f32): n, band args
MS_BANDED = ("nonsym", 2048, 2, 5, 3)


def _ms_factor(mesh):
    args, opts = MS_FACTOR
    bm, *_ = _band_t(args)
    dsf = dist_spike_factor_multislice(bm, mesh, **opts)
    ax_s = mesh.axis("slice")
    out = {f: _plane_gather(mesh, getattr(dsf, f))
           for f in ("Btip", "Ctip", "V", "W")}
    for f in ("F", "U", "Sinv"):
        out["red_" + f] = _np(ax_s.all_gather(getattr(dsf.red_fact, f)))
    out["red_type"] = type(dsf.red_fact).__name__
    return out


def _ms_krylov(mesh, case):
    args, fopts, kopts, seed = MS_KRYLOV[case]
    bm, data, kl, ku = _band_t(args)
    dsf = dist_spike_factor_multislice(bm, mesh, **torch_options(fopts))
    b = band_matvec_np(data, kl, ku, rhs(bm.n, seed))
    res = make_dist_solver_multislice(dsf, mesh, **kopts)(torch.as_tensor(b))
    return _krylov_out(res)


def _ms_batched(case):
    args, fopts, sopts, r, shape = MS_BATCHED[case]
    mesh = make_mesh_multislice(shape, device="cpu")
    data, kl, ku, U, B = batched_input(case)
    bm = BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku)
    dsf = dist_spike_factor_multislice(bm, mesh, **fopts)
    X = make_dist_solver_multislice_batched(dsf, mesh, **sopts)(
        torch.as_tensor(B))
    return dict(x=_np(X))


def _ms_transpose(mesh):
    args, fopts, g_seed, u_seed = MS_TRANSPOSE
    bm, data, kl, ku = _band_t(args)
    dsf = dist_spike_factor_multislice(bm, mesh, **fopts)
    dsft = dist_spike_transpose_multislice(dsf, mesh)
    g = torch.as_tensor(rhs(bm.n, g_seed))
    res = make_dist_solver_multislice(dsft, mesh, ksp_type="gmres",
                                      rtol=1e-11, maxit=30)(g)
    b = torch.as_tensor(band_matvec_np(data, kl, ku, rhs(bm.n, u_seed)))
    res_b = make_dist_solver_multislice(dsf, mesh, ksp_type="bicg",
                                        dsf_transpose=dsft, rtol=1e-11,
                                        maxit=40)(b)
    out = {"t_" + k: v for k, v in _krylov_out(res).items()}
    out.update({"b_" + k: v for k, v in _krylov_out(res_b).items()})
    out["Vt"] = _plane_gather(mesh, dsft.V)
    return out


def _ms_nullspace(mesh):
    from spike_petsc_tpu_torch.solvers.nullspace import make_nullspace
    n, fopts, kopts = MS_NULLSPACE
    data = neumann_band(n)
    bm = BandedMatrix(data=torch.as_tensor(data), kl=1, ku=1)
    ns = make_nullspace(n, constant=True, dtype=torch.float64, device=CPU)
    dsf = dist_spike_factor_multislice(bm, mesh, **fopts)
    b = band_matvec_np(data, 1, 1, nullspace_u(n))
    res = make_dist_solver_multislice(dsf, mesh, nullspace=ns, **kopts)(
        torch.as_tensor(b))
    return _krylov_out(res)


def _ms_banded(mesh):
    bm, data, kl, ku = _band_t(MS_BANDED, torch.float32)
    b = torch.as_tensor(band_matvec_np(data, kl, ku, rhs(bm.n, 6)),
                        dtype=torch.float32)
    out = {}
    for impl in ("banded_pallas", "blocks"):
        dsf = dist_spike_factor_multislice(bm, mesh, block_b=8,
                                           matvec_impl=impl)
        out[impl + "_route"] = dsf.matvec_route
        res = make_dist_solver_multislice(dsf, mesh, ksp_type="gmres",
                                          rtol=1e-5)(b)
        out.update({f"{impl}_{k}": v for k, v in _krylov_out(res).items()})
    return out


def _ms_one_rank(mesh1, mesh11):
    """(1, 1) against the 1-D mesh of one rank on the same options."""
    args, fopts, kopts, seed = MS_KRYLOV["gmres_stored"]
    bm, data, kl, ku = _band_t(args)
    fopts = dict(fopts, parts_per_device=4)
    b = torch.as_tensor(band_matvec_np(data, kl, ku, rhs(bm.n, seed)))
    d1 = dist_spike_factor(bm, mesh1, **fopts)
    dm = dist_spike_factor_multislice(bm, mesh11, **fopts)
    r1 = make_dist_solver(d1, mesh1, **kopts)(b)
    rm = make_dist_solver_multislice(dm, mesh11, **kopts)(b)
    same = all(torch.equal(getattr(d1, f), getattr(dm, f))
               for f in ("Btip", "Ctip", "V", "W"))
    same &= all(torch.equal(getattr(d1.red_fact, f), getattr(dm.red_fact, f))
                for f in ("F", "U", "Sinv"))
    return dict(factor_bits=same, x_bits=torch.equal(r1.x, rm.x),
                its=rm.its, its_1d=r1.its)


def multislice_program(rank, world):
    """tests/test_torch_dist_multislice.py on four ranks."""
    mesh = make_mesh_multislice((2, 2), device="cpu")
    res = {}
    run_case(res, "factor", _ms_factor, mesh)
    for case in MS_KRYLOV:
        run_case(res, "krylov_" + case, _ms_krylov, mesh, case)
    for case in MS_BATCHED:
        run_case(res, "batched_" + case, _ms_batched, case)
    run_case(res, "transpose", _ms_transpose, mesh)
    run_case(res, "nullspace", _ms_nullspace, mesh)
    run_case(res, "banded", _ms_banded, mesh)
    mesh1 = member(make_mesh, 1)
    mesh11 = member(make_mesh_multislice, (1, 1))
    if mesh1 is not None:
        run_case(res, "one_rank", _ms_one_rank, mesh1, mesh11)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_3d.py: (2, 2, 1) and (2, 1, 2)
# ---------------------------------------------------------------------------

D3_SHAPES = ((2, 2, 1), (2, 1, 2))
#: richardson serving: band, ppd, R, U seed
D3_SERVE = (("spd", 512, 3, 81), 2, 4, 82)
#: preonly and gmres: band, ppd, u seed
D3_PREONLY = (("nonsym", 384, 2, 83, 3), 2, 84)
#: the trip-count regression: band, partitions a slice (JAX's repro: two,
#: one a rank), rows, the scaled rows' factor
D3_TRIPS = (("spd", 512, 3, 5), 2, 6, 1e6)


def d3_trips_ppd(shape):
    """Partitions a rank that give D3_TRIPS's partitions a slice (the JAX
    package's multislice factor needs two or more)."""
    return D3_TRIPS[1] // shape[2]


def d3_serve_input():
    args, _, R, seed = D3_SERVE
    data, kl, ku = band(*args)
    U = np.stack([rhs(data.shape[0], seed + j) for j in range(R)])
    return data, kl, ku, U, band_matvec_np(data, kl, ku, U.T).T


def d3_trips_input():
    args, _, R, scale = D3_TRIPS
    data, kl, ku = band(*args)
    U = np.stack([rhs(data.shape[0], 400 + j) for j in range(R)])
    U[R // 2:] *= scale
    return data, kl, ku, U, band_matvec_np(data, kl, ku, U.T).T


def _d3_serve(shape):
    mesh3 = make_mesh_3d(shape, device="cpu")
    data, kl, ku, U, B = d3_serve_input()
    bm = BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku)
    ppd = D3_SERVE[1]
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8,
                                       parts_per_device=ppd,
                                       store_spikes=True)
    X = make_dist_solver_3d(dsf, mesh3, ksp_type="richardson", rtol=1e-9,
                            maxit=40)(torch.as_tensor(B))
    out = dict(x=_np(X))
    # the single-replica engine on the same (slice, p) shape, all columns
    single = member(make_mesh_multislice, shape[1:])
    if single is not None:
        d1 = dist_spike_factor_multislice(bm, single, block_b=8,
                                          parts_per_device=ppd,
                                          store_spikes=True)
        out["x_single"] = _np(make_dist_solver_multislice_batched(
            d1, single, ksp_type="richardson", rtol=1e-9, maxit=40)(
                torch.as_tensor(B.T)).T)
    return out


def _d3_preonly(shape):
    mesh3 = make_mesh_3d(shape, device="cpu")
    args, ppd, seed = D3_PREONLY
    bm, data, kl, ku = _band_t(args)
    b = band_matvec_np(data, kl, ku, rhs(bm.n, seed))
    B = torch.as_tensor(np.stack([b, b]))
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8,
                                       parts_per_device=ppd)
    Xp = make_dist_solver_3d(dsf, mesh3, ksp_type="preonly")(B)
    Xk = make_dist_solver_3d(dsf, mesh3, ksp_type="gmres", rtol=1e-10,
                             maxit=40)(B)
    return dict(xp=_np(Xp), xk=_np(Xk))


def _d3_trips(shape):
    mesh3 = make_mesh_3d(shape, device="cpu")
    data, kl, ku, U, B = d3_trips_input()
    bm = BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku)
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8,
                                       parts_per_device=d3_trips_ppd(shape))
    return {kt: _np(make_dist_solver_3d(dsf, mesh3, ksp_type=kt, rtol=1e-10,
                                        maxit=60)(torch.as_tensor(B)))
            for kt in ("richardson", "gmres")}


def d3_program(rank, world):
    """tests/test_torch_dist_3d.py on four ranks."""
    res = {}
    for shape in D3_SHAPES:
        tag = "".join(map(str, shape))
        run_case(res, "serve_" + tag, _d3_serve, shape)
        run_case(res, "preonly_" + tag, _d3_preonly, shape)
        run_case(res, "trips_" + tag, _d3_trips, shape)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_autodiff.py
# ---------------------------------------------------------------------------

def autodiff_input(seed, n=256, kl=2, ku=2):
    """The diagonally dominant random band of the JAX package's
    tests/test_autodiff.py and a right-hand side."""
    rng = np.random.default_rng(seed)
    w = kl + ku + 1
    data = rng.standard_normal((n, w))
    col = np.arange(n)[:, None] + np.arange(w)[None, :] - kl
    data = np.where((col >= 0) & (col < n), data, 0)
    data[:, kl] = np.sum(np.abs(data), axis=1) + 1.0
    return data, rng.standard_normal(n), kl, ku


def _grads(fn, data, b):
    d = torch.tensor(data, requires_grad=True)
    r = torch.tensor(b, requires_grad=True)
    loss = torch.sum(fn(d, r) ** 2)
    gd, gb = torch.autograd.grad(loss, (d, r))
    return dict(gd=_np(gd), gb=_np(gb), loss=float(loss))


def _autodiff_1d(mesh):
    data, b, kl, ku = autodiff_input(7)
    return _grads(lambda d, r: dist_solve_banded_diff(d, r, kl, ku, mesh,
                                                      block_b=8), data, b)


def _autodiff_ms(mesh):
    from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff
    data, b, kl, ku = autodiff_input(17)
    out = _grads(lambda d, r: dist_solve_banded_diff_multislice(
        d, r, kl, ku, mesh, block_b=8, rtol=1e-13), data, b)
    ref = _grads(lambda d, r: solve_banded_diff(d, r, kl, ku, K=8), data, b)
    out.update({"single_" + k: v for k, v in ref.items()})
    return out


def autodiff_program(rank, world):
    """tests/test_torch_dist_autodiff.py on ``world`` ranks."""
    res = {}
    run_case(res, "dist", _autodiff_1d, make_mesh(device="cpu"))
    if world == 4:
        run_case(res, "multislice", _autodiff_ms,
                 make_mesh_multislice((2, 2), device="cpu"))
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py: the JAX package's 13 scenarios on 4 ranks
# ---------------------------------------------------------------------------

def elastic_problem(n=512, k=3, seed=7):
    """``(data, kl, ku, u, b)``: JAX test_elastic's ``_problem``."""
    data, kl, ku = band("spd", n, k, seed)
    u = np.random.default_rng(seed).standard_normal(n)
    return data, kl, ku, u, band_matvec_np(data, kl, ku, u)


def serve_problem(kind, n, k, seed, u_seed, R, *kl):
    """``(data, kl, ku, U, B)`` of the serving scenarios (``band(kind, n,
    k, seed, *kl)``), ``B = A U`` row by row."""
    data, kl_, ku = band(kind, n, k, seed, *kl)
    U = np.random.default_rng(u_seed).standard_normal((R, n))
    return data, kl_, ku, U, band_matvec_np(data, kl_, ku, U.T).T


class Stop(RuntimeError):
    """The simulated process death of the checkpoint scenario."""


def fail_at(segment_wanted, times, message):
    """A fault injector raising at ``segment_wanted`` (None: any segment
    from 1 on) at most ``times`` times."""
    fired = []

    def inject(segment):
        hit = (segment >= 1) if segment_wanted is None \
            else (segment == segment_wanted)
        if hit and len(fired) < times:
            fired.append(True)
            raise RuntimeError(message)
    return inject


def _trail(res):
    out = dict(failures=res.failures,
               meshes=np.array([list(m) for m in res.meshes_used]))
    if hasattr(res, "x"):
        out.update(x=res.x, its=res.its, reason=res.reason,
                   segments=res.segments, rnorm=res.rnorm)
    else:
        out.update(X=res.X, attempts=res.attempts)
    return out


def _bm(data, kl, ku):
    return BandedMatrix(data=torch.as_tensor(data), kl=kl, ku=ku)


#: resilient_solve scenarios: name -> (problem args, options, injector)
ELASTIC_SOLVE = {
    "segmented": ((), dict(n_devices=4, parts_per_device=1, block_b=8,
                           rtol=1e-10, maxit=60, segment_its=5), None),
    "device_failure": ((768, 4, 3), dict(
        n_devices=4, block_b=8, rtol=1e-10, maxit=80, segment_its=4,
        max_failures=2, on_failure="halve"), (0, 1, "injected: "
                                               "DEVICE_SHUTTING_DOWN")),
    "transient": ((768, 4, 3), dict(
        n_devices=4, block_b=8, rtol=1e-10, maxit=80, segment_its=4,
        max_failures=2), (0, 1, "injected: transient collective timeout")),
    "in_segment": ((768, 4, 5), dict(
        n_devices=4, block_b=8, rtol=1e-10, maxit=80, segment_its=4,
        max_failures=2, on_failure="halve"), None),
    "maxit_clamped": ((), dict(n_devices=4, block_b=8, rtol=1e-14, maxit=7,
                               segment_its=5, ksp_type="cg", use_pc=False),
                      None),
    "persistent": ((768, 4, 5), dict(
        n_devices=4, block_b=8, rtol=1e-10, maxit=80, segment_its=4,
        max_failures=3), (0, 2, "injected: persistent fault, healthy "
                                "probe")),
    "slice_loss": ((768, 4, 8), dict(
        mesh_shape=(2, 2), block_b=8, rtol=1e-10, maxit=80, segment_its=4,
        max_failures=3), (0, 2, "injected: slice fault")),
}
#: the checkpoint scenario: problem args, first run, resumed run
CKPT_SOLVE = ((512, 3, 9), dict(n_devices=4, block_b=8, rtol=1e-8,
                                maxit=400, segment_its=3, ksp_type="cg",
                                use_pc=False, max_failures=0),
              dict(n_devices=4, block_b=8, rtol=1e-8, maxit=400,
                   segment_its=50, ksp_type="cg", use_pc=False))
CKPT_MS = ((512, 3, 9), dict(mesh_shape=(2, 2), block_b=8, rtol=1e-30,
                             maxit=3, segment_its=3),
           dict(mesh_shape=(2, 2), block_b=8, rtol=1e-10, maxit=80,
                segment_its=8))
#: resilient_serve scenarios: name -> (problem, options, injector)
ELASTIC_SERVE = {
    # two partitions a rank keep JAX's two a slice (its multislice factor
    # needs two or more)
    "replica_loss_3d": (("spd", 512, 3, 5, 0, 5), dict(
        mesh_shape=(2, 2, 1), parts_per_device=2, block_b=8,
        ksp_type="richardson", rtol=1e-10,
        maxit=40, on_failure="drop_replica"),
        (0, 1, "injected replica loss")),
    "pads_batch_2d": (("spd", 512, 3, 5, 1, 5), dict(
        mesh_shape=(2, 2), block_b=8, ksp_type="preonly"), None),
    "transient_2d": (("spd", 384, 3, 6, 2, 4), dict(
        mesh_shape=(2, 2), block_b=8, ksp_type="preonly"),
        (0, 1, "transient blip")),
    "persistent_2d": (("spd", 384, 3, 6, 2, 4), dict(
        mesh_shape=(2, 2), block_b=8, ksp_type="preonly", max_failures=3),
        ("upto1", 2, "persistent fault the probe cannot see")),
    "bcgs_2d": (("nonsym", 384, 3, 21, 9, 4, 3), dict(
        mesh_shape=(2, 2), parts_per_device=2, block_b=8, ksp_type="bcgs",
        rtol=1e-11, maxit=30), None),
}
POLICIES = {"halve": lambda ndev, exc: ndev // 2,
            "drop_replica": lambda c, exc: (1,) + tuple(c[1:])}


def serve_injector(spec):
    if spec is None:
        return None
    at, times, message = spec
    if at == "upto1":
        def inject(i):
            if i <= 1:
                raise RuntimeError(message)
        return inject
    return fail_at(at, times, message)


def _options(opts):
    opts = dict(opts)
    if "on_failure" in opts:
        opts["on_failure"] = POLICIES[opts["on_failure"]]
    return opts


def _elastic_solve(name):
    from spike_petsc_tpu_torch.parallel import elastic
    args, opts, inj = ELASTIC_SOLVE[name]
    data, kl, ku, u, b = elastic_problem(*args)
    fault = None if inj is None else fail_at(*inj)
    real = elastic.make_dist_solver
    if name == "in_segment":
        calls = []

        def flaky_make(dsf, mesh, **kw):
            solver = real(dsf, mesh, **kw)

            def wrapped(r, x0=None):
                calls.append(True)
                if len(calls) == 1:
                    raise RuntimeError("injected: in-segment "
                                       "DEVICE_UNAVAILABLE")
                return solver(r, x0)
            return wrapped
        elastic.make_dist_solver = flaky_make
    try:
        res = elastic.resilient_solve(_bm(data, kl, ku), b,
                                      fault_injector=fault, device="cpu",
                                      **_options(opts))
    finally:
        elastic.make_dist_solver = real
    return _trail(res)


def _ckpt(spec, tag):
    """The first run dies after its first segment (or ends at its maxit),
    then a resumed run from the port's file and one from the JAX
    package's file in the exchange directory."""
    from spike_petsc_tpu_torch.parallel import SolveCheckpoint
    from spike_petsc_tpu_torch.parallel.elastic import resilient_solve
    args, first, again = spec
    data, kl, ku, u, b = elastic_problem(*args)
    bm = _bm(data, kl, ku)
    outdir = os.environ[CKPT_DIR_ENV]
    path = os.path.join(outdir, f"torch_{tag}.npz")
    out = {}
    try:
        res1 = resilient_solve(bm, b, ckpt_path=path, device="cpu",
                               fault_injector=None if "mesh_shape" in first
                               else _stop_after_first, **first)
        out["first_its"] = res1.its
    except Stop:
        out["stopped"] = True
    torch.distributed.barrier()               # rank 0 has written the file
    st = SolveCheckpoint.load(path)
    out.update(ck_segments=st.segments, ck_its=st.its_done, ck_x=st.x)
    for src in ("torch", "jax"):
        # a resumed run writes its checkpoints over the file it resumed:
        # it resumes a copy, and the first runs' files stay for the test
        copy = os.path.join(outdir, f"{src}_{tag}_resumed_by_torch.npz")
        if torch.distributed.get_rank() == 0:
            shutil.copyfile(os.path.join(outdir, f"{src}_{tag}.npz"), copy)
        torch.distributed.barrier()
        res = resilient_solve(bm, b, ckpt_path=copy, resume=True,
                              device="cpu", **again)
        out.update({f"{src}_{k}": v for k, v in _trail(res).items()})
    return out


def _stop_after_first(segment):
    if segment >= 1:
        raise Stop("simulated process death")


def _elastic_serve(name):
    from spike_petsc_tpu_torch.parallel.elastic import resilient_serve
    prob, opts, inj = ELASTIC_SERVE[name]
    data, kl, ku, U, B = serve_problem(*prob)
    res = resilient_serve(_bm(data, kl, ku), B,
                          fault_injector=serve_injector(inj), device="cpu",
                          **_options(opts))
    return _trail(res)


def elastic_program(rank, world):
    """tests/test_torch_elastic.py on four ranks."""
    res = {}
    for name in ELASTIC_SOLVE:
        run_case(res, "solve_" + name, _elastic_solve, name)
    run_case(res, "ckpt_1d", _ckpt, CKPT_SOLVE, "1d")
    run_case(res, "ckpt_ms", _ckpt, CKPT_MS, "ms")
    return res


def elastic_serve_program(rank, world):
    """tests/test_torch_elastic_serve.py on four ranks."""
    res = {}
    for name in ELASTIC_SERVE:
        run_case(res, "serve_" + name, _elastic_serve, name)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_auction.py
# ---------------------------------------------------------------------------

AUCTION = (96, 3, 3, 2)          # n, kl, ku, seed of illscaled_nonsym


def auction_matrix():
    n, kl, ku, seed = AUCTION
    return problems.illscaled_nonsym(n, kl, ku, seed=seed)


def _auction_dist(a, mesh, eps=None):
    from spike_petsc_tpu_torch.parallel import auction_match_dist
    res = auction_match_dist(a, mesh, eps=eps)
    return dict(rperm=res.rperm, rounds=res.info["rounds"],
                devices=res.info["devices"], row_scale=res.row_scale,
                col_scale=res.col_scale,
                completed=res.info.get("completed", 0))


def auction_program(rank, world):
    """tests/test_torch_dist_auction.py on ``world`` ranks."""
    a = auction_matrix()
    res = {}
    run_case(res, "auction", _auction_dist, a, make_mesh(device="cpu"),
             1e-6 / a.shape[0])
    return res


def auction_doc_program(rank, world):
    """tests/test_torch_auction.py: MC64's documentation example on a
    one-rank mesh, the default eps and round budget."""
    res = {}
    run_case(res, "doc", _auction_dist, problems.mc64_doc_example(),
             make_mesh(device="cpu"))
    return res

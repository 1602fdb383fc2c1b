"""Top-level KSP interface: options-driven solver composition (PyTorch).

    result = solve(A, b, ksp_type="gmres", pc_type="spike",
                   options=Options({...}), rtol=1e-8)

    result = solve_many(A, B, ksp_type="bcgs", pc_type="spike", ...)

    result = solve(A, b, ksp_type="cg", pc_type="cholesky", ...)  # SPD A

    # f64-grade refinement: f64 band, f32 factors
    result = solve(A64, b64, ksp_type="richardson", pc_type="spike",
                   options=Options({"pc_spike_factor_dtype": "f32"}),
                   rtol=1e-12)

    # a singular Neumann Laplacian: the minimal-norm solution
    result = solve(L, b, ksp_type="cg", pc_type="jacobi",
                   options=Options({"ksp_nullspace_constant": 1}))

    # A^T x = b on A's factors (KSPSolveTranspose), and BiCG
    result = solve(A, b, ksp_type="gmres", pc_type="spike", transpose=True)
    result = solve(A, b, ksp_type="bicg", pc_type="spike")

Ported: a ``BandedMatrix``, ``BlockTridiagonal``, host SciPy sparse (a
band+outliers split or a sparse CSR product), dense or callable operator,
a BandedMatrix or host PC matrix, every KSP type of ``krylov`` (``bicg``,
``cgne``/``cgnr``/``cgls`` and ``lsqr`` get A^T and M^-T from the operator
and ``PC.transpose``), the batched engines of ``krylov_many``, every PC
type of the JAX package (``none``, ``jacobi``, ``lu``, ``spike``,
``cholesky``, ``bjacobi``, ``banded``, ``sor``, ``ksp``, ``asm``;
``composite`` and ``fieldsplit`` in ``fieldsplit.py``, ``mg`` in
``mg.py``), ``transpose=True`` (KSPSolveTranspose: A^T x = b, the
operator transposed on the host and the PC applying M^-T on its stored
factors), null spaces (``nullspace=``, ``transpose_nullspace=``,
``-ksp_nullspace_constant``), and the flags
``-ksp_monitor_true_residual``, ``-ksp_compute_eigenvalues``,
``-ksp_compute_singularvalues``, ``-ksp_diagonal_scale[_fix]``,
``-ksp_chebyshev_eigenvalues``, ``-ksp_chebyshev_esteig[_steps]``,
``-ksp_lgmres_augment``, ``-ksp_bcgsl_ell`` and
``-ksp_richardson_scale``. A host operator or PC matrix is placed where the
right-hand side lies, in its dtype (``make_solver(..., device=, dtype=)``).
``solve(..., monitor=True)`` prints the residual history after the solve
(``-ksp_monitor``) and ``view=True`` the solver hierarchy before it
(``-ksp_view``), as the JAX package prints them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.band import BandedMatrix, banded_diagonal, banded_diagonal_scale
from ..ops.blocktri import BlockTridiagonal
from ..utils.options import Options
from ..utils.profiling import span
from ..utils.registry import SOLVERS
from . import krylov  # noqa: F401  (registers the ported solvers)
from . import fieldsplit  # noqa: F401  (registers composite/fieldsplit PCs)
from . import mg  # noqa: F401  (registers the multigrid PC)
from .operator import as_matvec, as_matvec_many, transpose_operator
from .nullspace import make_nullspace
from .pc import PC, make_pc
from .types import KSPResult, reason_str

_DEFAULTS = dict(rtol=1e-5, atol=1e-50, divtol=1e4, maxit=10000, restart=30)

# the KSP types that iterate on A^T: make_solver gives them
# matvec_transpose and pc_apply_transpose
_TRANSPOSE_TYPES = ("bicg", "cgne", "cgnr", "cgls", "lsqr")


def _params_from_options(opts: Options, overrides: dict) -> dict:
    p = dict(
        rtol=opts.get_real("ksp_rtol", _DEFAULTS["rtol"]),
        atol=opts.get_real("ksp_atol", _DEFAULTS["atol"]),
        divtol=opts.get_real("ksp_divtol", _DEFAULTS["divtol"]),
        maxit=opts.get_int("ksp_max_it", _DEFAULTS["maxit"]),
        restart=opts.get_int("ksp_gmres_restart", _DEFAULTS["restart"]),
    )
    for key, param in (("ksp_pc_side", "side"), ("ksp_norm_type", "norm_type"),
                       ("ksp_gmres_cgs_refinement_type", "cgs_refinement")):
        value = opts.get_string(key, None)
        if value:
            p[param] = value
    if opts.get_bool("ksp_monitor_true_residual", False):
        p["monitor_true"] = True
    p.update({k: v for k, v in overrides.items() if v is not None})
    return p


def _richardson_scale(opts: Options, ksp_type: str, kw: dict) -> None:
    """``-ksp_richardson_scale``: richardson's damping, unless the caller
    passed ``scale`` itself."""
    if ksp_type == "richardson":
        scale = opts.get_real("ksp_richardson_scale", None)
        if scale is not None:
            kw.setdefault("scale", scale)


def _placement(A, device, dtype):
    """(device, dtype) of the operator: a band's or blocktri's own, a
    tensor's own, else the caller's (for a host operator: where ``b``
    lies), the card by default."""
    if isinstance(A, BandedMatrix):
        return A.device, A.dtype
    if isinstance(A, BlockTridiagonal):
        return A.D.device, A.D.dtype
    if isinstance(A, torch.Tensor):
        return A.device, A.dtype
    return torch.device(device or "cuda"), dtype


def _transposed(A, pc: PC, nullspace, transpose_nullspace):
    """``transpose=True``: (A^T, the PC applying M^-T, and the null-space
    pair swapped, since A^T's null space is A's transpose null space and
    the other way round)."""
    pct = pc.transpose() if pc.name != "none" else pc
    ns = transpose_nullspace if transpose_nullspace is not None else nullspace
    return transpose_operator(A), pct, ns, nullspace


def _nullspaces(opts: Options, nullspace, transpose_nullspace, n,
                device, dtype):
    """(ns, tns): the null space (``nullspace``, else the constant one
    under ``-ksp_nullspace_constant``) and the transpose null space (by
    default the null space itself, the symmetric case)."""
    if nullspace is None and opts.get_bool("ksp_nullspace_constant", False):
        nullspace = make_nullspace(n, constant=True, dtype=dtype,
                                   device=device)
    tns = transpose_nullspace if transpose_nullspace is not None \
        else nullspace
    return nullspace, tns


def _projected(fn: Optional[Callable], ns) -> Optional[Callable]:
    """``fn`` with its outputs projected by ``ns`` (None: unchanged)."""
    if fn is None or ns is None:
        return fn
    return lambda v: ns.remove(fn(v))


def _spanned(name: str, fn: Optional[Callable]) -> Optional[Callable]:
    """``fn`` with each call inside ``span(name)`` (None: unchanged)."""
    if fn is None:
        return None

    def call(v):
        with span(name):
            return fn(v)
    return call


def _chebyshev_bounds(opts: Options, kw: dict, matvec, n, dtype, device,
                      pc_apply) -> None:
    """``-ksp_chebyshev_eigenvalues emin,emax`` pins chebyshev's bounds;
    ``-ksp_chebyshev_esteig [a,b,c,d]`` estimates them from the Ritz values
    of a set-up Arnoldi run on M^-1 A (``-ksp_chebyshev_esteig_steps``,
    default 10; KSPChebyshevEstEig), transformed as
    ``(a lmin + b lmax, c lmin + d lmax)``.  Explicit bounds win, and the
    caller's ``emin`` wins over both, as in JAX."""
    if "emin" in kw:
        return
    ev = opts.get_list("ksp_chebyshev_eigenvalues")
    if ev is not None:
        if len(ev) != 2:
            raise ValueError("-ksp_chebyshev_eigenvalues expects "
                             f"'emin,emax', got {ev!r}")
        kw["emin"], kw["emax"] = float(ev[0]), float(ev[1])
    elif opts.has("ksp_chebyshev_esteig"):
        tr = opts.get_list("ksp_chebyshev_esteig") or []
        if tr and len(tr) != 4:
            raise ValueError("-ksp_chebyshev_esteig expects 'a,b,c,d' (or no "
                             f"value for the default transform), got {tr!r}")
        transform = (tuple(float(t) for t in tr) if tr
                     else krylov.ESTEIG_DEFAULT_TRANSFORM)
        eigs = krylov.estimate_extreme_eigs(
            matvec, n, dtype, m=opts.get_int("ksp_chebyshev_esteig_steps", 10),
            pc_apply=pc_apply, device=device)
        kw["emin"], kw["emax"] = krylov.chebyshev_esteig_bounds(eigs,
                                                                transform)


def make_solver(A, *, pmat=None, options: Optional[Options] = None,
                ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
                pc: Optional[PC] = None, n_hint: Optional[int] = None,
                jit: bool = True, transpose: bool = False, nullspace=None,
                transpose_nullspace=None, device=None, dtype=None,
                **params) -> Callable:
    """Compose (operator, preconditioner, method) once; return
    ``solve(b, x0=None) -> KSPResult``.  The operator's prepared layout and
    the PC's factorization are built here, once.  A host operator or PC
    matrix is placed on the operator's device and dtype, which for a host
    operator are ``device`` (default the card) and ``dtype`` (default the
    matrix's own).  ``jit`` is accepted for the JAX package's signature and
    changes nothing: PyTorch runs eagerly, so the closure is the same
    either way.

    ``nullspace`` (``solvers.nullspace.NullSpace``, or
    ``-ksp_nullspace_constant`` for the constant vector): b is projected by
    ``transpose_nullspace`` (default ``nullspace``), every matvec output by
    it too (residual space is range(A), orthogonal to the left null space),
    every PC output and the returned x by ``nullspace`` (PETSc's
    MatNullSpaceRemove in KSP_PCApply and KSPSolve).

    ``transpose=True`` solves A^T x = b (KSPSolveTranspose): the operator
    transposes on the host, the PC applies M^-T through ``PC.transpose()``
    (its stored factors, no refactorization), and ``nullspace`` and
    ``transpose_nullspace`` swap.  The types that iterate on A^T
    (``bicg``, ``cgne``/``cgnr``/``cgls``, ``lsqr``) get the transposed
    operator and ``PC.transpose().apply``, unless the caller passes
    ``matvec_transpose``/``pc_apply_transpose``."""
    opts = options or Options()
    device, dtype = _placement(A, device, dtype)
    ksp_type = ksp_type or opts.get_string("ksp_type", "gmres")
    method = SOLVERS.get(ksp_type)
    if pc is None:
        name = pc_type or opts.get_string("pc_type", "none")
        pc = make_pc(name, A if pmat is None else pmat, opts, device=device,
                     dtype=dtype)
    shown_pc = pc
    if transpose:
        A, pc, nullspace, transpose_nullspace = _transposed(
            A, pc, nullspace, transpose_nullspace)
    # -mat_matvec_impl auto|banded_pallas|banded_cuda|blocktri|xla: the
    # operator's SpMV route
    impl = opts.get_string("mat_matvec_impl", "auto")
    matvec, n, op_dtype = as_matvec(A, n_hint=n_hint, impl=impl,
                                    device=device, dtype=dtype)
    ns, tns = _nullspaces(opts, nullspace, transpose_nullspace, n, device,
                          op_dtype or dtype or torch.float32)
    # PETSc's log events, around every route of the operator and the PC
    matvec = _spanned("MatMult", _projected(matvec, tns))
    pc_apply = _spanned("PCApply", _projected(
        pc.apply if pc.name != "none" else None, ns))
    kw = _params_from_options(opts, params)
    if ksp_type in _TRANSPOSE_TYPES:
        # A^T and M^-T, each unless the caller gave it: A^T's residual
        # space drops null(A) (projected by ns), and the solution space of
        # a transpose solve drops null(A^T) (by tns)
        if "matvec_transpose" not in kw:
            mvt, _, _ = as_matvec(transpose_operator(A), n_hint=n_hint,
                                  impl=impl, device=device, dtype=dtype)
            kw["matvec_transpose"] = _projected(mvt, ns)
        if pc_apply is not None and "pc_apply_transpose" not in kw:
            kw["pc_apply_transpose"] = _projected(pc.transpose().apply, tns)
    _richardson_scale(opts, ksp_type, kw)
    if ksp_type == "chebyshev":
        _chebyshev_bounds(opts, kw, matvec, n, op_dtype or dtype, device,
                          pc_apply)
    if ksp_type == "lgmres":
        # -ksp_lgmres_augment: the error approximations appended to each
        # restart cycle (KSPLGMRESSetAugDim)
        kw.setdefault("aug", opts.get_int("ksp_lgmres_augment", 2))
    if ksp_type == "bcgsl":
        # -ksp_bcgsl_ell: the MR-polynomial degree (KSPBCGSLSetEll)
        kw.setdefault("ell", opts.get_int("ksp_bcgsl_ell", 2))

    def _solve(b, x0=None):
        if tns is not None:
            b = tns.remove(b)            # consistency: drop the left-null part
        res = method(matvec, b, x0, pc_apply, **kw)
        if ns is not None:               # the minimal-norm representative
            res = dataclasses.replace(res, x=ns.remove(res.x))
        return res

    _solve.pc = shown_pc    # the composed PC (before any transpose), for
    #                         solve's -ksp_view and its post-solve estimates
    return _solve


def make_solver_many(A, *, pmat=None, options: Optional[Options] = None,
                     ksp_type: Optional[str] = None,
                     pc_type: Optional[str] = None, pc: Optional[PC] = None,
                     n_hint: Optional[int] = None, jit: bool = True,
                     transpose: bool = False, nullspace=None,
                     transpose_nullspace=None, device=None, dtype=None,
                     **params) -> Callable:
    """Compose a batched multi-RHS solver: ``solve(B [n, r], X0=None)``
    returns a column-batched KSPResult (x [n, r]; its, reason, rnorm per
    column).

    One iteration loop drives all columns (``krylov_many``).  The operator
    is applied as a true ``[n, r]`` block (``as_matvec_many``) and the PC
    through its native ``apply_many`` where it has one, else a column loop
    of ``apply``.  ``ksp_type`` (default ``bcgs``) is one of
    ``krylov_many.MANY_SOLVERS``.  ``jit``, ``device``, ``dtype``,
    ``nullspace``, ``transpose_nullspace`` and ``transpose`` are as in
    :func:`make_solver` (``NullSpace.remove`` takes ``[n, r]`` blocks; the
    transposed PC has no multi-RHS apply, so its columns take ``apply`` one
    by one)."""
    from .krylov_many import MANY_SOLVERS
    opts = options or Options()
    device, dtype = _placement(A, device, dtype)
    ksp_type = ksp_type or opts.get_string("ksp_type", "bcgs")
    if ksp_type not in MANY_SOLVERS:
        raise ValueError(
            f"no batched engine for ksp_type {ksp_type!r}: available "
            f"{sorted(set(MANY_SOLVERS))} (other methods: call a "
            "make_solver closure per column)")
    method = MANY_SOLVERS[ksp_type]
    if pc is None:
        name = pc_type or opts.get_string("pc_type", "none")
        pc = make_pc(name, A if pmat is None else pmat, opts, device=device,
                     dtype=dtype)
    if transpose:
        A, pc, nullspace, transpose_nullspace = _transposed(
            A, pc, nullspace, transpose_nullspace)
    matvec_many, n, op_dtype = as_matvec_many(
        A, n_hint=n_hint, impl=opts.get_string("mat_matvec_impl", "auto"),
        device=device, dtype=dtype)
    ns, tns = _nullspaces(opts, nullspace, transpose_nullspace, n, device,
                          op_dtype or dtype or torch.float32)
    matvec_many = _spanned("MatMult", _projected(matvec_many, tns))
    if pc.name == "none":
        pc_apply_many = None
    elif pc.apply_many is not None:
        pc_apply_many = pc.apply_many
    else:
        def pc_apply_many(R):
            return torch.stack([pc.apply(R[:, j]) for j in range(R.shape[1])],
                               dim=1)
    pc_apply_many = _spanned("PCApply", _projected(pc_apply_many, ns))
    kw = _params_from_options(opts, params)
    for extra in ("norm_type", "monitor_true"):    # not in the batched
        kw.pop(extra, None)                        # engines' surface
    _richardson_scale(opts, ksp_type, kw)

    def _solve(B, X0=None):
        if tns is not None:
            B = tns.remove(B)
        res = method(matvec_many, B, X0, pc_apply_many, **kw)
        if ns is not None:
            res = dataclasses.replace(res, x=ns.remove(res.x))
        return res

    return _solve


def solve_many(A, B, X0=None, *, pmat=None, options: Optional[Options] = None,
               ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
               pc: Optional[PC] = None, transpose: bool = False,
               **params) -> KSPResult:
    """One-shot batched multi-RHS solve (PETSc KSPMatSolve role):
    ``solve_many(A, B [n, r])`` -> column-batched KSPResult, options-driven
    like ``solve``."""
    solver = make_solver_many(A, pmat=pmat, options=options,
                              ksp_type=ksp_type, pc_type=pc_type, pc=pc,
                              n_hint=B.shape[0], transpose=transpose,
                              device=B.device, dtype=B.dtype, **params)
    return solver(B, X0)


def solve(A, b, x0=None, *, pmat=None, options: Optional[Options] = None,
          ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
          pc: Optional[PC] = None, monitor: bool = False,
          view: bool = False, transpose: bool = False,
          record: Optional[dict] = None, **params) -> KSPResult:
    """One-shot options-driven solve (KSPSolve equivalent).  ``pmat`` is the
    preconditioning matrix when it differs from A (KSPSetOperators(A, B)).
    ``view=True`` prints the configured solver hierarchy before solving
    (``-ksp_view``); ``monitor=True`` prints the residual history and the
    converged reason after it (``-ksp_monitor``).  ``transpose=True``
    solves A^T x = b (see :func:`make_solver`).  ``record``, when given,
    receives the PC the solve built (or was given) under ``"pc"``.

    ``-ksp_diagonal_scale`` (KSPSetDiagonalScale) scales the system
    symmetrically by s = 1/sqrt(|diag(pmat)|): it solves
    (S A S)(S^-1 x) = S b and returns x = S y, with the scaled system's
    residual history, as PETSc.  It needs banded operators and no
    ready-made ``pc``.  ``-ksp_diagonal_scale_fix`` is accepted and changes
    nothing: the caller's operators are never mutated.
    ``-ksp_compute_singularvalues`` prints the extreme singular values of
    the preconditioned operator after the solve."""
    opts = options or Options()
    unscale = None
    if opts.get_bool("ksp_diagonal_scale", False):
        A, pmat, b, x0, unscale = _diagonal_scale(opts, A, pmat, b, x0, pc)
    solver = make_solver(A, pmat=pmat, options=opts, ksp_type=ksp_type,
                         pc_type=pc_type, pc=pc, n_hint=b.shape[0],
                         transpose=transpose, device=b.device, dtype=b.dtype,
                         **params)
    if record is not None:
        record["pc"] = solver.pc
    if view:
        kt = ksp_type or opts.get_string("ksp_type", "gmres")
        print(view_str(kt, _params_from_options(opts, params), solver.pc,
                       n=b.shape[0]))
    res = solver(b, x0)
    if unscale is not None:
        res = dataclasses.replace(res, x=res.x * unscale)
    if opts.get_bool("ksp_error_if_not_converged", False) and res.reason <= 0:
        raise RuntimeError(
            f"KSPSolve did not converge: {reason_str(res.reason)} after "
            f"{res.its} iterations (rnorm {res.rnorm:.3e})")
    if monitor:
        print_monitor(res, bnorm=float(torch.linalg.norm(b)))
    if opts.get_bool("ksp_compute_eigenvalues", False):
        print_eigenvalues(A, b, res, solver.pc, opts, transpose)
    if opts.get_bool("ksp_compute_singularvalues", False):
        print_singular_values(A, b, res, solver.pc, opts, transpose)
    return res


def _diagonal_scale(opts: Options, A, pmat, b, x0, pc):
    """-ksp_diagonal_scale: (S A S, S pmat S, S b, S^-1 x0, s) with
    s = 1/sqrt(|diag(pmat or A)|), 1 where the diagonal is 0."""
    opts.get_bool("ksp_diagonal_scale_fix", True)
    if pc is not None:
        raise ValueError(
            "-ksp_diagonal_scale with an explicitly constructed PC is "
            "ambiguous (the PC was built from the UNSCALED operators); "
            "pass pc_type/options and let solve build it")
    base = A if pmat is None else pmat
    if not (isinstance(A, BandedMatrix) and isinstance(base, BandedMatrix)):
        raise ValueError(
            "-ksp_diagonal_scale needs banded operators (a matrix-free "
            "operator has no accessible diagonal); scale the system "
            "yourself for callable operators")
    ad = banded_diagonal(base).abs()
    s = torch.where(ad > 0, 1.0 / torch.sqrt(torch.where(ad > 0, ad, 1)),
                    torch.ones_like(ad))
    A = banded_diagonal_scale(A, s, s)
    if pmat is not None:
        pmat = banded_diagonal_scale(pmat, s, s)
    return A, pmat, s * b, None if x0 is None else x0 / s, s


def _post_solve_operators(A, b, pc: PC, opts: Options, transpose: bool):
    """(matvec, n, dtype, the operator, the PC) the post-solve estimates
    run on: those of the system solved, A^T and M^-T under ``transpose``."""
    op = transpose_operator(A) if transpose else A
    mv, n, dt = as_matvec(op, n_hint=b.shape[0],
                          impl=opts.get_string("mat_matvec_impl", "auto"),
                          device=b.device, dtype=b.dtype)
    pcx = pc.transpose() if transpose and pc.name != "none" else pc
    return mv, n, dt or b.dtype, op, pcx


def print_eigenvalues(A, b, res: KSPResult, pc: PC, opts: Options,
                      transpose: bool = False) -> None:
    """-ksp_compute_eigenvalues: Ritz estimates of the preconditioned
    operator's spectrum after the solve, from an Arnoldi run of
    ``min(n, max(its, 2), 30)`` steps on the same operator and PC started
    from b (PETSc reads them from the solver's own Hessenberg; for GMRES
    the estimates are the same, and this serves every KSP type)."""
    mv, n, dt, _, pcx = _post_solve_operators(A, b, pc, opts, transpose)
    eigs = krylov.estimate_extreme_eigs(
        mv, n, dt, m=min(n, max(int(res.its), 2), 30),
        pc_apply=pcx.apply if pcx.name != "none" else None, v0=b.to(dt))
    print("Iteratively computed eigenvalues")
    for e in eigs[np.argsort(eigs.real)]:
        print(f"{e.real:g} + {e.imag:g}i")


def print_singular_values(A, b, res: KSPResult, pc: PC, opts: Options,
                          transpose: bool = False) -> None:
    """-ksp_compute_singularvalues (KSPComputeExtremeSingularValues): the
    extreme singular values and their ratio (a condition estimate) of the
    preconditioned operator, from a Golub-Kahan run of
    ``min(n, max(2 max(its, 2), 10), 60)`` steps started from b on the
    operator, its transpose, the PC and the PC's transpose (the
    involution under ``transpose``: the original PC)."""
    mv, n, dt, op, pcx = _post_solve_operators(A, b, pc, opts, transpose)
    mvt, _, _ = as_matvec(transpose_operator(op), n_hint=b.shape[0],
                          impl=opts.get_string("mat_matvec_impl", "auto"),
                          device=b.device, dtype=b.dtype)
    none = pcx.name == "none"
    smax, smin = krylov.estimate_extreme_singular_values(
        mv, mvt, n, dt, m=min(n, max(2 * max(int(res.its), 2), 10), 60),
        pc_apply=None if none else pcx.apply,
        pc_apply_transpose=None if none else pcx.transpose().apply,
        v0=b.to(dt))
    cond = smax / smin if smin > 0 else float("inf")
    print(f"Iteratively computed extreme singular values: "
          f"max {smax:g} min {smin:g} max/min {cond:g}")


def view_str(ksp_type: str, params: dict, pc: Optional[PC],
             n: Optional[int] = None) -> str:
    """-ksp_view text: the configured solver hierarchy, PETSc
    KSPView/PCView style."""
    lines = ["KSP Object:", f"  type: {ksp_type}"]
    if ksp_type in ("gmres", "fgmres"):
        lines.append(f"    restart={params.get('restart', 30)}, modified "
                     "Gram-Schmidt, Givens-rotation least squares")
    if ksp_type == "chebyshev":
        lines.append("    eigenvalue bounds from preset/power estimates")
    lines.append(f"  maximum iterations={params.get('maxit')}")
    lines.append(f"  tolerances: relative={params.get('rtol'):g}, "
                 f"absolute={params.get('atol'):g}, "
                 f"divergence={params.get('divtol'):g}")
    side = params.get("side", "right" if ksp_type == "fgmres" else "left")
    lines.append(f"  {side} preconditioning")
    if n is not None:
        lines.append(f"  operator size: {n} x {n}")
    if pc is None or pc.name == "none":
        lines.append("PC Object:\n  type: none")
    else:
        lines.append("PC Object:")
        lines.append(pc.describe(1))
    return "\n".join(lines)


def print_monitor(res: KSPResult, bnorm=None) -> None:
    """-ksp_monitor style residual printout of a single-RHS result; where
    the solver recorded unpreconditioned norms (``true_history``), both
    columns, as PETSc's -ksp_monitor_true_residual prints them.

    ``bnorm``: ||b|| for the ||r(i)||/||b|| column; without it the initial
    true residual is used."""
    h = res.history.tolist()
    th = None if res.true_history is None else res.true_history.tolist()
    tb = None
    if th is not None:
        tb = float(bnorm) if bnorm is not None else float(th[0])
        if not math.isfinite(tb) or tb <= 0:
            tb = 1.0
    for i in range(int(res.its) + 1):
        if math.isfinite(h[i]):
            if th is not None and math.isfinite(th[i]):
                print(f"{i:5d} KSP preconditioned resid norm {h[i]:.12e} "
                      f"true resid norm {th[i]:.12e} ||r(i)||/||b|| "
                      f"{th[i] / tb:.12e}")
            else:
                print(f"{i:5d} KSP Residual norm {h[i]:.12e}")
    print(f"Converged reason: {reason_str(res.reason)} after {int(res.its)} its")

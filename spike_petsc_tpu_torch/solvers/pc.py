"""Preconditioners (the PC layer), PyTorch.

A PC is a small object with an ``apply`` closure over device factorization
state (and, where the type has one, a multi-RHS ``apply_many``); factories
are registered by name and read their parameters from a prefix-scoped
options database.  Here: ``none``, ``jacobi``, ``lu``, ``spike``,
``cholesky`` (the symmetric ``spd`` factorization of the spike family),
``bjacobi``, ``banded`` (PCBANDED: a norm-fraction band extracted from a
host matrix, preconditioned by an inner PC under the ``banded_`` prefix),
``sor`` (block SSOR, each sweep one block-Thomas solve on a factor built
at set-up), ``ksp`` (an inner Krylov solve) and ``asm`` (additive Schwarz
with overlap); ``composite`` and ``fieldsplit`` live in ``fieldsplit.py``,
``mg`` in ``mg.py``.  Forward apply and, where the type has one, multi-RHS
apply, with the Newton safety net; and the transpose apply M^{-T} of every
one (``PC.transpose``, PCApplyTranspose), built once from the stored
factors.  On the card a
factor that names no block gets the smallest block the sweep kernels take
(``default_block``).

A host (SciPy or NumPy) preconditioning matrix is placed on the device and
in the dtype that ``make_pc`` is given (``make_solver`` gives the
operator's); without them, on the card in the matrix's own dtype.  A dense
2-D tensor is taken as a host matrix of its values, placed on its own
device in its own dtype.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field as dfield
from functools import partial
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import sparse as hsp
from ..ops.band import BandedMatrix, banded_diagonal, banded_matvec
from ..ops.cuda.fused_sweep_spd import require_spd_feasible
from ..ops.cuda.sweeps import default_block
from ..ops.blocktri import (BlockTridiagonal, BlockTriFactor,
                            TransposedBlockTriFactor, band_to_blocktri,
                            batched_inverse, sweep_precision)
from ..ops.spike import (_batched_solver, partition_solver, spike_factor,
                         spike_solve, spike_solve_many, spike_transpose)
from ..utils.debug import SINGULAR, factor_health
from ..utils.options import Options
from ..utils.profiling import scope
from ..utils.registry import PRECONDITIONERS, register_pc
from .operator import as_matvec, as_matvec_many, transpose_operator


@dataclass
class PC:
    """A configured preconditioner: ``apply`` maps residual -> correction."""

    name: str
    apply: Callable
    info: dict = dfield(default_factory=dict)
    inner: Optional["PC"] = None
    # native multi-RHS apply ([n, r] -> [n, r]) where the PC type has one
    # (the spike PC: spike_solve_many streams the factors once for all r
    # columns); None: callers apply ``apply`` column by column
    apply_many: Optional[Callable] = dfield(default=None, repr=False)
    # host-side builder for the M^{-T} apply (PCApplyTranspose)
    make_transpose: Optional[Callable] = dfield(default=None, repr=False)
    _transposed: Optional["PC"] = dfield(default=None, repr=False)

    def describe(self, indent: int = 0) -> str:
        """PCView-style description: ``PC <name>: key=value, ...``, then
        the inner PC's, one level deeper.  A factorization PC's ``block``
        is the block it factored with: on the card, where the options name
        none, the kernel block of ``default_block`` (64 or 128) for every
        method, ``lu`` and ``cr`` too; ``shifted_pivots`` (under
        ``-pc_factor_shift_type``) is the count of raised pivots."""
        pad = "  " * indent
        s = f"{pad}PC {self.name}: " + ", ".join(
            f"{k}={v}" for k, v in self.info.items())
        if self.inner is not None:
            s += "\n" + self.inner.describe(indent + 1)
        return s

    def transpose(self) -> "PC":
        """A PC applying M^{-T} (PETSc PCApplyTranspose), built once on the
        host and cached; factorization PCs reuse their stored factors
        (``spike_transpose``, no refactorization).  An involution: the
        transposed PC's transpose is this PC."""
        if self._transposed is None:
            if self.make_transpose is None:
                raise ValueError(
                    f"pc '{self.name}' has no transpose apply "
                    "(PCApplyTranspose unsupported for this type)")
            self._transposed = self.make_transpose()
            if self._transposed._transposed is None:
                self._transposed._transposed = self
        return self._transposed


@dataclass(frozen=True)
class HostMatrix:
    """A host preconditioning matrix and where the PC built from it lives."""

    csr: sp.csr_matrix
    device: torch.device
    dtype: torch.dtype

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(device=self.device, dtype=self.dtype)


def _place(pmat, device=None, dtype=None):
    """A host matrix as a ``HostMatrix`` on ``device`` (default the card)
    in ``dtype`` (default its own); a dense 2-D tensor as a ``HostMatrix``
    of its values on its own device in its own dtype (JAX's PCs take a
    dense array through ``as_csr(np.asarray(a))``); anything else
    unchanged."""
    if isinstance(pmat, torch.Tensor) and pmat.dim() == 2:
        vals = pmat.detach().cpu()
        if vals.dtype == torch.bfloat16:        # numpy has no bfloat16
            vals = vals.float()
        return HostMatrix(csr=hsp.as_csr(vals.numpy()), device=pmat.device,
                          dtype=pmat.dtype)
    if not (sp.issparse(pmat) or isinstance(pmat, np.ndarray)):
        return pmat
    csr = hsp.as_csr(pmat)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, csr.dtype)).dtype
    return HostMatrix(csr=csr, device=torch.device(device or "cuda"),
                      dtype=dtype)


def _as_banded(pmat, opts: Options) -> BandedMatrix:
    if isinstance(pmat, BandedMatrix):
        return pmat
    if isinstance(pmat, HostMatrix):
        # host sparse/dense -> band storage (full bandwidth)
        data, kl, ku = hsp.csr_to_banded_arrays(pmat.csr)
        return BandedMatrix(data=pmat.tensor(data), kl=kl, ku=ku)
    raise NotImplementedError(
        f"preconditioning matrices of type {type(pmat).__name__} are not yet "
        "ported to spike_petsc_tpu_torch (BandedMatrix, host SciPy/NumPy "
        "matrices and dense 2-D tensors are)")


def make_pc(name: str, pmat, options: Optional[Options] = None,
            prefix: str = "", *, device=None, dtype=None) -> PC:
    """Build a preconditioner by registry name, PETSc ``PCSetType`` style.
    A host ``pmat`` is placed on ``device`` in ``dtype`` (see the module
    docstring).  The build is the ``PCSetUp`` stage
    (``utils.profiling.scope``), a sub-PC's (PCBANDED's inner PC, mg's
    smoother) part of its parent's."""
    opts = (options or Options()).scoped(prefix)
    with scope("PCSetUp"):
        return PRECONDITIONERS.get(name)(_place(pmat, device, dtype), opts)


@register_pc("none")
def pc_none(pmat, opts: Options) -> PC:
    pc = PC(name="none", apply=lambda x: x)
    pc.make_transpose = lambda: pc                  # identity is symmetric
    return pc


@register_pc("jacobi")
def pc_jacobi(pmat, opts: Options) -> PC:
    """Diagonal scaling (PCJACOBI).

    ``-pc_jacobi_type diagonal|rowmax|rowsum`` (PCJacobiSetType): scale by
    the inverse diagonal (default), the row's max |a_ij|, or the row's
    sum of |a_ij|.  ``-pc_jacobi_abs`` (PCJacobiSetUseAbs): use
    |diagonal|.  The PC matrix is diagonal, hence self-transpose."""
    jtype = opts.get_string("pc_jacobi_type", "diagonal")
    if jtype not in ("diagonal", "rowmax", "rowsum"):
        raise ValueError(f"unknown -pc_jacobi_type {jtype!r}: expected "
                         "diagonal, rowmax, or rowsum")
    if isinstance(pmat, BandedMatrix):
        if jtype == "rowmax":
            d = pmat.data.abs().amax(dim=1)
        elif jtype == "rowsum":
            d = pmat.data.abs().sum(dim=1)
        else:
            d = banded_diagonal(pmat)
    elif isinstance(pmat, HostMatrix):
        acsr = pmat.csr
        if jtype == "rowmax":
            d = abs(acsr).max(axis=1).toarray().ravel()
        elif jtype == "rowsum":
            d = np.asarray(abs(acsr).sum(axis=1)).ravel()
        else:
            d = acsr.diagonal()
        d = pmat.tensor(d)
    else:
        raise NotImplementedError(
            f"pc 'jacobi' on a {type(pmat).__name__} is not yet ported")
    if jtype == "diagonal" and opts.get_bool("pc_jacobi_abs", False):
        d = d.abs()
    one = torch.ones_like(d)
    dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, one), one)
    pc = PC(name="jacobi", apply=lambda x: dinv * x,
            apply_many=lambda X: dinv[:, None] * X)
    pc.make_transpose = lambda: pc                  # diagonal is symmetric
    return pc


def _newton_probe_active(inverter: str) -> bool:
    return inverter in ("newton", "newton_fixed", "newton_pan")


def _probe_tolerance(store_dtype, spike_dtype) -> float:
    """Probe-residual acceptance threshold: reduced-precision storage
    legitimately floors the probe residual."""
    if store_dtype is not None:
        return 5e-2
    if spike_dtype is not None:
        return 5e-3
    return 1e-3


def _newton_safety_net(band, sf, inverter, store_dtype, spike_dtype,
                       refactor, exact: bool = True):
    """The Newton inverters assume the near-diagonally dominant regime (and
    'newton_fixed' has no convergence check at all): verify the
    factorization on a probe solve and re-factor with the pivoted blocked
    recursion if the result is junk.  ``exact=False`` (truncated
    factorizations, which drop coupling on purpose) rejects only
    non-finite or exploding probes.  Returns (sf, fell_back)."""
    if not _newton_probe_active(inverter):
        return sf, False
    probe = banded_matvec(band, torch.ones(band.n, dtype=band.dtype,
                                           device=band.device))
    xs = spike_solve(sf, probe)
    err = float(torch.linalg.norm(banded_matvec(band, xs) - probe)
                / torch.linalg.norm(probe))
    tol = _probe_tolerance(store_dtype, spike_dtype)
    bad = not math.isfinite(err) or (exact and err > tol) or err > 1e6
    if bad:
        return refactor(), True
    return sf, False


_DTYPES = {"": None, "none": None, "bf16": torch.bfloat16,
           "f32": torch.float32, "f64": torch.float64}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cast_apply(fn: Callable, factor_dtype: torch.dtype,
                dtype: torch.dtype) -> Callable:
    """``fn`` on a residual cast to the factors' dtype, its result cast back
    (``-pc_<name>_factor_dtype``).  The JAX package traces the inner solve
    with x64 off there, a Pallas lowering workaround with no counterpart
    here."""
    return lambda r: fn(r.to(factor_dtype)).to(dtype)


def _check_health(opts: Options, name: str, sf, info: dict) -> None:
    """``-pc_<name>_check`` (JAX ``solvers/pc.py:377-387``): the typed
    factor status of ``utils.debug.factor_health`` in ``info["health"]``;
    singular Schur pivots raise ``FloatingPointError``."""
    if not opts.get_bool(f"pc_{name}_check", False):
        return
    status = factor_health(sf.fact).status
    info["health"] = status
    if status == SINGULAR:
        raise FloatingPointError(
            f"pc '{name}': factorization has singular Schur pivots "
            f"(reorder/scale the matrix first)")


def _shift_options(opts: Options) -> tuple:
    """``-pc_factor_shift_type`` and ``-pc_factor_shift_amount`` (JAX
    ``solvers/pc.py:327-328``): the factor's ``shift`` and
    ``shift_amount``."""
    return (opts.get_string("pc_factor_shift_type", "none"),
            opts.get_real("pc_factor_shift_amount", 0.0))


def _shift_info(info: dict, shift: str, sf) -> None:
    """``shifted_pivots``, the count of raised pivots, where shifting."""
    if shift != "none":
        info["shifted_pivots"] = int(sf.fact.nshift.sum())


def _block_option(band: BandedMatrix, opts: Options, name: str,
                  method: str):
    return default_block(opts.get_int(f"pc_{name}_block", None),
                         max(band.kl, band.ku, 1), method, band.data.is_cuda)


def _spike_pc(pmat, opts: Options, *, name: str, default_K: int,
              default_method: str = "inv") -> PC:
    band = _as_banded(pmat, opts)
    k = max(band.kl, band.ku, 1)
    K = opts.get_int(f"pc_{name}_partitions", default_K)
    K = max(1, min(K, band.n // (2 * k)))   # partitions must cover 2k rows
    method = opts.get_string(f"pc_{name}_method", default_method)
    block = _block_option(band, opts, name, method)
    # real spd factors take the spd kernels; complex Hermitian ones the
    # plain sweep (sweep_route)
    on_card = (method == "spd" and band.data.is_cuda
               and not band.data.is_complex())
    truncated = opts.get_bool(f"pc_{name}_truncated", False)
    store = opts.get_bool(f"pc_{name}_store_spikes", False)
    # -pc_<name>_store_lt: keep the L blocks at factor time, so that the
    # regular-form transpose builds with no band conversion
    store_lt = opts.get_bool(f"pc_{name}_store_lt", False)
    inverter = opts.get_string(f"pc_{name}_inverter", "auto")
    shift, shift_amount = _shift_options(opts)
    store_dtype = _DTYPES[opts.get_string(f"pc_{name}_store_dtype", "")]
    spike_dtype = _DTYPES[opts.get_string(f"pc_{name}_spike_dtype", "")]
    # -pc_<name>_factor_dtype casts the BAND before factoring (store_dtype
    # casts the finished factor): an f64 operator with f32 factors, the
    # refinement recipe; every apply casts at the boundary
    orig_dtype = band.dtype
    factor_dtype = _DTYPES[opts.get_string(f"pc_{name}_factor_dtype", "")]
    cast = factor_dtype is not None and factor_dtype != orig_dtype
    if cast:
        band = BandedMatrix(data=band.data.to(factor_dtype), kl=band.kl,
                            ku=band.ku)

    def factor(inv):
        return spike_factor(band, K=K, block_b=block, method=method,
                            truncated=truncated, store_spikes=store,
                            shift=shift, shift_amount=shift_amount,
                            inverter=inv, store_dtype=store_dtype,
                            spike_dtype=spike_dtype, store_lt=store_lt)

    sf = factor(inverter)
    if on_card:                         # every apply runs the spd kernels
        require_spd_feasible(sf.fact, sf.b, band.dtype,
                             f"pc '{name}' on the card: the spd sweep kernel")
    info = dict(partitions=K, block=sf.b, tip=sf.k, method=method,
                truncated=truncated)
    if cast:
        info["factor_dtype"] = _dtype_name(factor_dtype)
    if store_dtype is not None:
        info["store_dtype"] = _dtype_name(store_dtype)
    if spike_dtype is not None and store:
        info["spike_dtype"] = _dtype_name(spike_dtype)
    if store_lt:
        info["store_lt"] = True
    sf, fb = _newton_safety_net(band, sf, inverter, store_dtype, spike_dtype,
                                lambda: factor("blocked"),
                                exact=not truncated)
    if fb:
        info["inverter_fallback"] = "blocked"
    _shift_info(info, shift, sf)
    _check_health(opts, name, sf, info)

    def boundary(fn):
        return _cast_apply(fn, factor_dtype, orig_dtype) if cast else fn

    fast = opts.get_bool(f"pc_{name}_transpose_fast", True)

    def make_transpose():
        sft = _transpose_factor(sf, band, fast, inverter, fb)
        return PC(name=name + "_transpose",
                  apply=boundary(partial(spike_solve, sft)), info=info)

    return PC(name=name, apply=boundary(partial(spike_solve, sf)), info=info,
              apply_many=boundary(partial(spike_solve_many, sf)),
              make_transpose=make_transpose)


def _transpose_factor(sf, band, fast: bool, inverter: str, fell_back: bool):
    """The factorization of A^T on ``sf``'s stored factors
    (``spike_transpose``): the regular form from the kept L blocks or the
    (factor-dtype) band, unless ``fast`` is off
    (``-pc_<name>_transpose_fast 0``: the storage-sharing marker).  The
    reduced system of A^T takes the forward factor's resolved inverter:
    'blocked' where the Newton safety net fell back, so the unguarded
    engine never sees the matrices that broke it."""
    return spike_transpose(sf, inverter="blocked" if fell_back else inverter,
                           band=band if fast else None, fast=fast)


@register_pc("spike")
def pc_spike(pmat, opts: Options) -> PC:
    return _spike_pc(pmat, opts, name="spike", default_K=16)


@register_pc("cholesky")
def pc_cholesky(pmat, opts: Options) -> PC:
    """Symmetric direct factorization, PETSc's ``-pc_type cholesky`` role:
    ``method='spd'`` block-LDL^T factors (F and Sinv stored, 2/3 of
    ``inv``'s block arrays).  The matrix must be symmetric: the factor reads
    only the diagonal and subdiagonal blocks.  The ``pc_cholesky_*``
    options of the spike family apply (partitions, default 1; block,
    default the tip size k, and on the card the smallest block the spd
    sweep kernels take, 64 or 128; truncated; store_spikes; inverter;
    store_dtype; factor_dtype); ``-pc_cholesky_method inv`` overrides the
    method.  On the card a factor the kernels refuse (another block size,
    an f64 band without ``-pc_cholesky_factor_dtype f32``) raises here."""
    return _spike_pc(pmat, opts, name="cholesky", default_K=1,
                     default_method="spd")


@register_pc("lu")
def pc_lu(pmat, opts: Options) -> PC:
    """Direct banded factorization (single-partition block-Thomas) — the
    role PETSc's -pc_type lu plays in the reference's canned recipe
    (reference/src/makefile:18).  ``-pc_lu_method`` (``inv``),
    ``-pc_lu_block`` (default the tip size; on the card 64 or 128, the
    smallest block the sweep kernels take, so that a long single partition
    runs the two-pass kernels #9), ``-pc_lu_inverter``, ``-pc_lu_store_lt``
    and ``-pc_lu_transpose_fast`` (as for the spike PC), and
    ``-pc_factor_shift_type`` / ``-pc_factor_shift_amount`` apply;
    ``-pc_lu_method lu`` keeps pivoted LU factors, whose sweeps are plain.
    The transpose of a K = 1 ``inv`` factor on the card runs #9 like the
    forward one."""
    band = _as_banded(pmat, opts)
    method = opts.get_string("pc_lu_method", "inv")
    block = _block_option(band, opts, "lu", method)
    inverter = opts.get_string("pc_lu_inverter", "auto")
    store_lt = opts.get_bool("pc_lu_store_lt", False)
    shift, shift_amount = _shift_options(opts)

    def factor(inv):
        return spike_factor(band, K=1, block_b=block, method=method,
                            shift=shift, shift_amount=shift_amount,
                            inverter=inv, store_lt=store_lt)

    sf = factor(inverter)
    info = dict(block=sf.b, method=method)
    if store_lt:
        info["store_lt"] = True
    sf, fb = _newton_safety_net(band, sf, inverter, None, None,
                                lambda: factor("blocked"))
    if fb:
        info["inverter_fallback"] = "blocked"
    _shift_info(info, shift, sf)
    fast = opts.get_bool("pc_lu_transpose_fast", True)

    def make_transpose():
        sft = _transpose_factor(sf, band, fast, inverter, fb)
        return PC(name="lu_transpose", apply=partial(spike_solve, sft),
                  info=info)

    return PC(name="lu", apply=partial(spike_solve, sf), info=info,
              apply_many=partial(spike_solve_many, sf),
              make_transpose=make_transpose)


@register_pc("bjacobi")
def pc_bjacobi(pmat, opts: Options) -> PC:
    """Per-partition solves with interface coupling dropped entirely — the
    cheapest member of the spike family.  ``-pc_bjacobi_blocks`` (default
    16), ``-pc_bjacobi_block`` (default as ``-pc_lu_block``),
    ``-pc_bjacobi_method``, ``-pc_bjacobi_inverter``.  On the card each
    apply is the sweep dispatch of ``spike_solve`` (``sweep_route``: #1
    where its rule admits the factor, else #9).  With the coupling dropped,
    the transpose is the per-block transpose solves on the same factors,
    in the storage-sharing marker form as in JAX (plain sweeps)."""
    band = _as_banded(pmat, opts)
    K = opts.get_int("pc_bjacobi_blocks", 16)
    K = max(1, min(K, band.n // (2 * max(band.kl, band.ku, 1))))
    method = opts.get_string("pc_bjacobi_method", "inv")
    block = _block_option(band, opts, "bjacobi", method)
    inverter = opts.get_string("pc_bjacobi_inverter", "auto")

    def factor(inv):
        return spike_factor(band, K=K, block_b=block, method=method,
                            truncated=True, inverter=inv)

    sf, _ = _newton_safety_net(band, factor(inverter), inverter, None, None,
                               lambda: factor("blocked"), exact=False)

    def block_apply(f):
        def apply(x):
            rp = torch.zeros(f.K * f.m, dtype=x.dtype, device=x.device)
            rp[:f.n] = x
            sweep = _batched_solver(f, "auto", x)
            return sweep(rp.reshape(f.K, f.nb, f.b)).reshape(-1)[:f.n]
        return apply

    info = dict(blocks=K, block=sf.b, method=method)

    def make_transpose():
        sft = dataclasses.replace(sf, fact=TransposedBlockTriFactor(sf.fact))
        return PC(name="bjacobi_transpose", apply=block_apply(sft),
                  info=info)

    return PC(name="bjacobi", apply=block_apply(sf), info=info,
              make_transpose=make_transpose)


@register_pc("banded")
def pc_banded(pmat, opts: Options) -> PC:
    """PCBANDED: extract the norm-fraction band of a host pmat, precondition
    with an embedded PC on the band (reference/src/matbanded.c:165-192).

    Options: -pc_banded_kmax (default 50), -pc_banded_frac (default 0.95)
    (reference/src/matbanded.c:156-157, 261-262); the embedded PC is
    configured under the ``banded_`` prefix (default: spike), mirroring
    PCCreate_Banded's prefix plumbing (reference/src/matbanded.c:278-281).
    The band is built on the host matrix's device and dtype.
    """
    kmax = opts.get_int("pc_banded_kmax", 50)
    frac = opts.get_real("pc_banded_frac", 0.95)
    if isinstance(pmat, BandedMatrix):
        raise TypeError("pc 'banded' extracts a band from a general sparse "
                        "pmat; the operator is already banded")
    if not isinstance(pmat, HostMatrix):
        raise NotImplementedError(
            f"pc 'banded' on a {type(pmat).__name__} is not yet ported")
    ext = hsp.extract_banded(pmat.csr, kmax=kmax, frac=frac)
    data, kl, ku = hsp.csr_to_banded_arrays(ext.matrix, kl=ext.k, ku=ext.k)
    band = BandedMatrix(data=pmat.tensor(data), kl=kl, ku=ku)
    inner_opts = opts.scoped("banded_")
    inner = make_pc(inner_opts.get_string("pc_type", "spike"), band,
                    inner_opts)
    info = dict(k=ext.k, frac=round(ext.frac, 6), kmax=kmax)

    def make_transpose():
        it = inner.transpose()
        return PC(name="banded_transpose", apply=it.apply, info=info,
                  inner=it)

    return PC(name="banded", apply=inner.apply, info=info, inner=inner,
              apply_many=inner.apply_many, make_transpose=make_transpose)


def _sor_factor(T: BlockTridiagonal, Dinv: torch.Tensor, omega: float,
                stype: str) -> BlockTriFactor:
    """The block SOR sweep of ``stype`` as one ``inv`` block-Thomas factor
    (K = 1), so that the sweep kernels run it.  With F_i = ω L_i Dinv_{i-1},
    Sinv_i = ω Dinv_i and the blocks' own U_i, the solve's forward
    recurrence v_i = r_i - F_i v_{i-1} is r_i - L_i y_{i-1} for the SOR
    iterate y_i = ω Dinv_i v_i.  So ``forward`` is the solve with U = 0,
    ``backward`` the solve with F = 0, and ``symmetric`` the solve with
    both: its v is JAX's middle step D t / ω (D_i Dinv_i = I), and the
    caller scales the result by (2 - ω) / ω."""
    zero = torch.zeros_like(T.D)
    F = zero
    if stype != "backward":
        prec = sweep_precision(T.L, Dinv)
        FL = omega * (T.L[1:].to(prec) @ Dinv[:-1].to(prec))
        F = torch.cat([zero[:1], FL.to(T.dtype)])
    U = zero if stype == "forward" else T.U
    return BlockTriFactor(F=F[None].contiguous(), U=U[None].contiguous(),
                          Sinv=(omega * Dinv)[None].contiguous(),
                          method="inv")


def _sor_applies(T: BlockTridiagonal, Dinv: torch.Tensor, omega: float,
                 stype: str, its: int, n: int) -> tuple:
    """(apply, apply_many) of block SOR on the blocks ``T``: ``its`` sweeps
    of ``_sor_factor``'s solve, the later ones on the residual
    r - T z (the blocktri operator of ``as_matvec``, #7 on the card)."""
    fact = _sor_factor(T, Dinv, omega, stype)
    nb, b = T.nb, T.b
    scale = (2.0 - omega) / omega if stype == "symmetric" else 1.0
    mv = as_matvec(T)[0]
    mv_many = as_matvec_many(T)[0]

    def run(rp, matvec, many):
        solve = partition_solver(fact, b, "auto", rp, many=many)

        def sweep(v):
            x = solve(v.reshape(1, nb, b, *v.shape[1:])).reshape(v.shape)
            return x if scale == 1.0 else scale * x

        z = sweep(rp)
        for _ in range(its - 1):
            z = z + sweep(rp - matvec(z))
        return z

    def apply(r):
        rp = r.new_zeros(nb * b)
        rp[:n] = r
        return run(rp, mv, False)[:n]

    def apply_many(R):
        rp = R.new_zeros((nb * b, R.shape[1]))
        rp[:n] = R
        return run(rp, mv_many, True)[:n]

    return apply, apply_many


@register_pc("sor")
def pc_sor(pmat, opts: Options) -> PC:
    """Block SSOR (PETSc ``-pc_type sor`` role, JAX ``solvers/pc.py:151``):
    the band viewed as block-tridiagonal with blocks of ``-pc_sor_block``
    (default the bandwidth), one symmetric sweep applying
    M^-1 = ((2-ω)/ω) (D/ω + U)^-1 D (D/ω + L)^-1 from the batched D^-1
    blocks.  Options: ``-pc_sor_omega`` (1.0), ``-pc_sor_its`` (1; extra
    sweeps iterate z += M^-1 (r - A z)), ``-pc_sor_type
    symmetric|forward|backward``, ``-pc_sor_block``, ``-pc_sor_inverter``.

    Each sweep is one block-Thomas solve on a factor built once at set-up
    (``_sor_factor``), so on the card it takes the sweep kernels' route
    (#1, else #9, for ``inv`` factors) where the block is 64 or 128; at
    any other block the plain sweep runs.  The block is the
    preconditioner, so it is not changed for the card.  The transpose is
    JAX's: the same sweep type on the transposed blocks, which is the
    sweep on A^T.  That is the adjoint M^-T for the symmetric sweep only;
    for a forward (backward) sweep the adjoint is the backward (forward)
    sweep on A^T."""
    band = _as_banded(pmat, opts)
    omega = float(opts.get_real("pc_sor_omega", 1.0))
    if not 0.0 < omega < 2.0:
        raise ValueError(f"-pc_sor_omega must be in (0, 2), got {omega}")
    its = opts.get_int("pc_sor_its", 1)
    stype = opts.get_string("pc_sor_type", "symmetric")
    if stype not in ("symmetric", "forward", "backward"):
        raise ValueError(f"unknown -pc_sor_type {stype!r}")
    block = opts.get_int("pc_sor_block", None)
    inverter = opts.get_string("pc_sor_inverter", "auto")
    b = block or max(band.kl, band.ku, 1)
    T = band_to_blocktri(band, b)
    Dinv = batched_inverse(T.D, inverter)
    info = dict(omega=omega, its=its, type=stype, block=b)
    apply, apply_many = _sor_applies(T, Dinv, omega, stype, its, band.n)

    def make_transpose():
        # JAX's M(A^T): the same sweep on the transposed blocks
        at, amt = _sor_applies(transpose_operator(T),
                               Dinv.transpose(-1, -2).contiguous(), omega,
                               stype, its, band.n)
        return PC(name="sor_transpose", apply=at, apply_many=amt, info=info)

    return PC(name="sor", apply=apply, apply_many=apply_many, info=info,
              make_transpose=make_transpose)


def operator_of(pmat) -> tuple:
    """(operator, device, dtype) of a placed PC matrix, for ``make_solver``
    and ``as_matvec``: a host matrix's CSR where it was placed, a band or
    another operator where it lies."""
    if isinstance(pmat, HostMatrix):
        return pmat.csr, pmat.device, pmat.dtype
    if isinstance(pmat, BandedMatrix):
        return pmat, pmat.device, pmat.dtype
    return pmat, None, None


@register_pc("ksp")
def pc_ksp(pmat, opts: Options) -> PC:
    """PCKSP: a full inner Krylov solve as the preconditioner apply (JAX
    ``solvers/pc.py:593``).  The inner solver reads the ``ksp_`` prefix,
    PETSc's convention (``-ksp_ksp_type`` default gmres, ``-ksp_pc_type``
    default none, ``-ksp_ksp_rtol`` default 1e-2, ``-ksp_ksp_max_it``
    default 50; nested prefixes compose, e.g. ``-ksp_banded_pc_type``).
    The PC varies between applies: use ``-ksp_type fgmres`` outside.
    The transpose solves A^T z = r with the same configuration
    (``make_solver(..., transpose=True)``, the inner PC's transpose)."""
    from . import ksp as _ksp
    inner_opts = opts.scoped("ksp_")
    inner_ksp = inner_opts.get_string("ksp_type", "gmres")
    inner_pc_name = inner_opts.get_string("pc_type", "none")
    rtol = inner_opts.get_real("ksp_rtol", 1e-2)
    maxit = inner_opts.get_int("ksp_max_it", 50)
    inner_pc = PRECONDITIONERS.get(inner_pc_name)(pmat, inner_opts)
    op, device, dtype = operator_of(pmat)

    def inner_solver(transpose: bool):
        return _ksp.make_solver(op, options=inner_opts, ksp_type=inner_ksp,
                                pc=inner_pc, jit=False, transpose=transpose,
                                rtol=rtol, maxit=maxit, device=device,
                                dtype=dtype)

    solver = inner_solver(False)
    info = dict(ksp=inner_ksp, rtol=rtol, maxit=maxit)

    def make_transpose():
        solver_t = inner_solver(True)
        return PC(name="ksp_transpose", apply=lambda r: solver_t(r).x,
                  info=info,
                  inner=(inner_pc.transpose()
                         if inner_pc.name != "none" else inner_pc))

    return PC(name="ksp", apply=lambda r: solver(r).x, info=info,
              inner=inner_pc if inner_pc.name != "none" else None,
              make_transpose=make_transpose)


@register_pc("asm")
def pc_asm(pmat, opts: Options) -> PC:
    """PCASM: restricted (default) or basic additive Schwarz with overlap
    (JAX ``solvers/pc.py:646``).  Each of K row blocks is extended by
    ``overlap`` rows on both sides; the windows concatenate into one band
    factored by ``spike_factor(K, truncated=True)``, whose partitions are
    the windows, so the apply is one batched partition solve (on the card
    ``sweep_route``: #1, else #9).  Options: ``-pc_asm_blocks`` (16),
    ``-pc_asm_overlap`` (default max(kl, ku)), ``-pc_asm_type
    restrict|basic``, ``-pc_asm_method``, ``-pc_asm_inverter``,
    ``-pc_asm_store_dtype``, ``-pc_asm_block`` (default as
    ``-pc_bjacobi_block``: the tip size, on the card 64 or 128).  The
    window length rounds up to a multiple of the block, so on the card
    the windows are not those of the CPU at the default block.  The
    transpose is the exact adjoint on the same factors, in the
    storage-sharing marker form (plain sweeps)."""
    band = _as_banded(pmat, opts)
    k = max(band.kl, band.ku, 1)
    n, w = band.n, band.width
    K = opts.get_int("pc_asm_blocks", 16)
    K = max(1, min(K, n // (2 * k) if n >= 2 * k else 1))
    overlap = opts.get_int("pc_asm_overlap", k)
    if overlap < 0:
        raise ValueError(f"pc_asm_overlap must be >= 0, got {overlap}")
    asm_type = opts.get_string("pc_asm_type", "restrict")
    if asm_type not in ("restrict", "basic"):
        raise ValueError(f"-pc_asm_type must be restrict or basic, "
                         f"got {asm_type!r}")
    method = opts.get_string("pc_asm_method", "inv")
    inverter = opts.get_string("pc_asm_inverter", "auto")
    store_dtype = _DTYPES[opts.get_string("pc_asm_store_dtype", "")]
    bb = _block_option(band, opts, "asm", method) or k
    m_int = -(-n // K)                        # owned rows per block
    mloc = -(-(m_int + 2 * overlap) // bb) * bb   # window rows
    total = overlap + (K - 1) * m_int + mloc  # the padded vector's rows
    # window kk covers padded rows [kk m_int, kk m_int + mloc); rows
    # outside [0, n) get a unit diagonal (identity on the padding)
    idx = (torch.arange(K, device=band.device)[:, None] * m_int
           + torch.arange(mloc, device=band.device)[None])
    dpad = band.data.new_zeros((total, w))
    dpad[:, band.kl] = 1
    dpad[overlap:overlap + n] = band.data
    concat = BandedMatrix(data=dpad[idx].reshape(K * mloc, w), kl=band.kl,
                          ku=band.ku)

    def factor(inv):
        return spike_factor(concat, K=K, block_b=bb, method=method,
                            truncated=True, inverter=inv,
                            store_dtype=store_dtype)

    sf, fb = _newton_safety_net(concat, factor(inverter), inverter,
                                store_dtype, None, lambda: factor("blocked"),
                                exact=False)
    nb_, b_ = sf.nb, sf.b                     # nb_ * b_ == mloc
    flat = idx.reshape(-1)

    def apply_with(f, transposed: bool):
        def apply(x):
            if not transposed or asm_type == "basic":
                rp = x.new_zeros(total)
                rp[overlap:overlap + n] = x
                rw = rp[idx]
            else:
                # the adjoint of the interior restriction: each block's
                # owned rows at window rows [overlap, overlap + m_int)
                xe = x.new_zeros(K * m_int)
                xe[:n] = x
                rw = x.new_zeros((K, mloc))
                rw[:, overlap:overlap + m_int] = xe.reshape(K, m_int)
            sweep = _batched_solver(f, "auto", x)
            y = sweep(rw.reshape(K, nb_, b_)).reshape(K, mloc)
            if transposed or asm_type == "basic":
                acc = y.new_zeros(total).index_add_(0, flat, y.reshape(-1))
                return acc[overlap:overlap + n]
            return y[:, overlap:overlap + m_int].reshape(-1)[:n]
        return apply

    info = dict(blocks=K, overlap=overlap, type=asm_type, block=b_,
                window=mloc)
    if store_dtype is not None:
        info["store_dtype"] = _dtype_name(store_dtype)
    if fb:
        info["inverter_fallback"] = "blocked"

    def make_transpose():
        sft = dataclasses.replace(sf, fact=TransposedBlockTriFactor(sf.fact))
        return PC(name="asm_transpose", apply=apply_with(sft, True),
                  info=info)

    return PC(name="asm", apply=apply_with(sf, False), info=info,
              make_transpose=make_transpose)

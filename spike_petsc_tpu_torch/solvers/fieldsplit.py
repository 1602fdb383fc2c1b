"""Composite and fieldsplit preconditioners (PyTorch).

The port of ``spike_petsc_tpu.solvers.fieldsplit``: the reference's
testbed2 exists to make its plugins reachable inside PETSc's composable
solvers, its header documenting the Schur-complement fieldsplit recipe
(reference/src/testbed2.c:4, 61-73).

  composite   additive or multiplicative combination of inner PCs
              (PCCOMPOSITE): -pc_composite_type, -pc_composite_pcs
  fieldsplit  block preconditioning over 2..N fields (PCFIELDSPLIT):
              additive, multiplicative, or schur; inner PCs under the
              fieldsplit_<i>_ prefixes; the Schur complement approximated by
              A11 ("a11") or by A11 - A10 diag(A00)^-1 A01 ("selfp")

Set-up slices the host CSR; every sub-block is placed where the parent
matrix was (its device and dtype), so a CPU run stays on the CPU and an f32
card run factors in f32.  The applies gather and scatter the fields with
index tensors held on that device.  The set-up's parts are profiling
stages (``-log_view``, ``utils.profiling.stage_times``):
``FieldSplitSubMatrices`` (slicing the host CSR and placing the blocks
the applies multiply by), ``FieldSplitSchurSelfp`` (the selfp product)
and ``FieldSplitSubPCSetUp`` (the inner PCs).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.options import Options
from ..utils.profiling import scope
from ..utils.registry import PRECONDITIONERS, register_pc
from .operator import as_matvec, transpose_operator
from .pc import PC, HostMatrix, _place, operator_of


def _matvec(op, device, dtype):
    return as_matvec(op, device=device, dtype=dtype)[0]


def _sum_apply(pcs):
    def apply(r):
        z = pcs[0].apply(r)
        for p in pcs[1:]:
            z = z + p.apply(r)
        return z
    return apply


def _staged_apply(pcs, matvec):
    """z = M_0 r, then z += M_j (r - A z) for each later stage."""
    def apply(r):
        z = pcs[0].apply(r)
        for p in pcs[1:]:
            z = z + p.apply(r - matvec(z))
        return z
    return apply


@register_pc("composite")
def pc_composite(pmat, opts: Options) -> PC:
    """PCCOMPOSITE: combine inner PCs additively or multiplicatively.
    ``-pc_composite_pcs jacobi,spike``, ``-pc_composite_type
    additive|multiplicative``; inner PC i reads options under ``sub_<i>_``.
    The multiplicative stages apply the PC matrix (``as_matvec``: the band
    kernel #2 on a CUDA band).  The transpose runs term-wise (additive) or
    the stages in reversed order on A^T (multiplicative)."""
    names = opts.get_list("pc_composite_pcs", ["jacobi"])
    ctype = opts.get_string("pc_composite_type", "additive")
    if ctype not in ("additive", "multiplicative"):
        raise ValueError(f"unknown composite type {ctype!r}")
    inners = [PRECONDITIONERS.get(nm)(pmat, opts.scoped(f"sub_{i}_"))
              for i, nm in enumerate(names)]
    op, device, dtype = operator_of(pmat)
    if ctype == "additive":
        apply = _sum_apply(inners)
    else:
        apply = _staged_apply(inners, _matvec(op, device, dtype))
    info = dict(type=ctype, pcs=",".join(names))

    def make_transpose():
        inners_t = [p.transpose() for p in inners]
        if ctype == "additive":
            apply_t = _sum_apply(inners_t)
        else:
            apply_t = _staged_apply(
                inners_t[::-1], _matvec(transpose_operator(op), device,
                                        dtype))
        return PC(name="composite_transpose", apply=apply_t, info=info,
                  inner=inners_t[0])

    return PC(name="composite", apply=apply, info=info, inner=inners[0],
              make_transpose=make_transpose)


def _fieldsplit_isets(opts: Options, n: int):
    """The field index sets from the options (a host copy of JAX
    ``solvers/fieldsplit.py:92``):

    -pc_fieldsplit_sizes n0,n1,...       contiguous multi-field split
    -pc_fieldsplit_block_size bs         strided components; each
      -pc_fieldsplit_<i>_fields c0,c1    field takes components of the bs
                                         block (PCFieldSplitSetFields)
    -pc_fieldsplit_n0 n0                 two contiguous fields
    Default: two contiguous fields of n/2.
    """
    bs = opts.get_int("pc_fieldsplit_block_size", 0)
    if bs > 0:
        if n % bs:
            raise ValueError(f"n={n} not divisible by block size {bs}")
        base = np.arange(0, n, bs)
        present = [i for i in range(bs)
                   if opts.get_list(f"pc_fieldsplit_{i}_fields", None)
                   is not None]
        if present and present != list(range(len(present))):
            raise ValueError(
                f"-pc_fieldsplit_<i>_fields must be numbered contiguously "
                f"from 0; got indices {present}")
        isets = []
        for i in present:
            comps = [int(c) for c in
                     opts.get_list(f"pc_fieldsplit_{i}_fields", None)]
            idx = np.sort(np.concatenate([base + c for c in comps]))
            isets.append(idx.astype(np.int64))
        if not isets:
            isets = [(base + c).astype(np.int64) for c in range(bs)]
        return isets
    sizes = opts.get_list("pc_fieldsplit_sizes", None)
    if sizes is None:
        n0 = opts.get_int("pc_fieldsplit_n0", n // 2)
        sizes = [n0, n - n0]
    else:
        sizes = [int(s) for s in sizes]
    if sum(sizes) != n:
        raise ValueError(f"fieldsplit sizes {sizes} do not sum to n={n}")
    offs = np.cumsum([0] + sizes)
    return [np.arange(offs[i], offs[i + 1], dtype=np.int64)
            for i in range(len(sizes))]


def _host(pmat, device, dtype) -> HostMatrix:
    pmat = _place(pmat, device, dtype)
    if not isinstance(pmat, HostMatrix):
        raise TypeError("pc 'fieldsplit' slices a host (SciPy or NumPy) "
                        f"matrix or a dense tensor, got "
                        f"{type(pmat).__name__}")
    return pmat


def pc_fieldsplit_is(pmat, isets, opts: Options, *, device=None,
                     dtype=None) -> PC:
    """PCFIELDSPLIT over arbitrary index sets (PCFieldSplitSetIS):
    ``isets`` is a list of integer index arrays partitioning [0, n).

    -pc_fieldsplit_type additive|multiplicative|schur (schur: 2 fields)
    -pc_fieldsplit_schur_precondition a11|selfp
    The inner PC of field i (default ``lu``) reads ``fieldsplit_<i>_``.
    A host ``pmat`` is placed on ``device`` in ``dtype`` as ``make_pc``
    places it (default the card, its own dtype)."""
    hm = _host(pmat, device, dtype)
    a, device, dtype = hm.csr, hm.device, hm.dtype
    n = a.shape[0]
    isets = [np.asarray(ix, dtype=np.int64) for ix in isets]
    nf = len(isets)
    if nf < 2:
        raise ValueError("fieldsplit needs >= 2 fields")
    allidx = np.concatenate(isets)
    if len(allidx) != n or len(np.unique(allidx)) != n:
        raise ValueError("fieldsplit index sets must partition [0, n)")
    ftype = opts.get_string("pc_fieldsplit_type",
                            "schur" if nf == 2 else "multiplicative")
    sprec = opts.get_string("pc_fieldsplit_schur_precondition", "selfp")
    if ftype == "schur" and nf != 2:
        raise ValueError("schur fieldsplit requires exactly 2 fields")
    if ftype not in ("schur", "additive", "multiplicative"):
        raise ValueError(f"unknown fieldsplit type {ftype!r}")

    def blk(i, j):
        with scope("FieldSplitSubMatrices"):
            return a[isets[i]][:, isets[j]].tocsr()

    sub_opts = [opts.scoped(f"fieldsplit_{i}_") for i in range(nf)]

    def make_pc(i, mat):
        with scope("FieldSplitSubPCSetUp"):
            return PRECONDITIONERS.get(
                sub_opts[i].get_string("pc_type", "lu"))(
                HostMatrix(csr=mat, device=device, dtype=dtype), sub_opts[i])

    def mv(mat):
        with scope("FieldSplitSubMatrices"):
            return _matvec(mat, device, dtype)

    dev_isets = [torch.as_tensor(ix, device=device) for ix in isets]
    dev_all = torch.cat(dev_isets)

    def fields(r):
        return [r.index_select(0, ix) for ix in dev_isets]

    def scatter(zs):
        z = torch.cat(zs)
        return z.new_empty(n).index_copy_(0, dev_all, z)

    if ftype == "schur":
        A00, A01 = blk(0, 0), blk(0, 1)
        A10, A11 = blk(1, 0), blk(1, 1)
        pc0 = make_pc(0, A00)
        if sprec == "selfp":
            with scope("FieldSplitSchurSelfp"):
                d0 = A00.diagonal()
                d0inv = np.where(d0 != 0,
                                 1.0 / np.where(d0 != 0, d0, 1.0), 1.0)
                s_approx = (A11 - A10 @ sp.diags(d0inv) @ A01).tocsr()
        else:
            s_approx = A11
        pc1 = make_pc(1, s_approx)

        def schur_apply(p0, p1, m01, m10):
            # the lower-triangular Schur factorization:
            # z0' = M00^-1 r0; z1 = S^-1 (r1 - A10 z0');
            # z0 = z0' - M00^-1 A01 z1
            def apply(r):
                r0, r1 = fields(r)
                z0p = p0.apply(r0)
                z1 = p1.apply(r1 - m10(z0p))
                return scatter([z0p - p0.apply(m01(z1)), z1])
            return apply

        apply = schur_apply(pc0, pc1, mv(A01), mv(A10))
        inner0 = pc0

        def transpose_parts():
            # P^-T of P = L D U: the same three steps with A01 <-> A10
            # transposed and the inner PCs transposed
            pc0t, pc1t = pc0.transpose(), pc1.transpose()
            return (schur_apply(pc0t, pc1t, mv(A10.T.tocsr()),
                                mv(A01.T.tocsr())), pc0t)
    else:
        pcs = [make_pc(i, blk(i, i)) for i in range(nf)]
        inner0 = pcs[0]
        if ftype == "additive":
            def additive(ps):
                def apply(r):
                    return scatter([p.apply(ri)
                                    for p, ri in zip(ps, fields(r))])
                return apply

            apply = additive(pcs)

            def transpose_parts():
                pcst = [p.transpose() for p in pcs]
                return additive(pcst), pcst[0]
        else:
            # block Gauss-Seidel over the fields:
            # z_i = M_ii^-1 (r_i - sum_{j<i} A_ij z_j)
            mv_low = {(i, j): mv(blk(i, j))
                      for i in range(nf) for j in range(i)}

            def apply(r):
                rs, zs = fields(r), []
                for i in range(nf):
                    ri = rs[i]
                    for j in range(i):
                        ri = ri - mv_low[(i, j)](zs[j])
                    zs.append(pcs[i].apply(ri))
                return scatter(zs)

            def transpose_parts():
                # block upper Gauss-Seidel on A^T: w_i = M_ii^-T (r_i -
                # sum_{j>i} A_ji^T w_j), i descending
                pcst = [p.transpose() for p in pcs]
                mv_up = {(i, j): mv(blk(j, i).T.tocsr())
                         for i in range(nf) for j in range(i + 1, nf)}

                def apply_t(r):
                    rs, ws = fields(r), [None] * nf
                    for i in range(nf - 1, -1, -1):
                        ri = rs[i]
                        for j in range(i + 1, nf):
                            ri = ri - mv_up[(i, j)](ws[j])
                        ws[i] = pcst[i].apply(ri)
                    return scatter(ws)
                return apply_t, pcst[0]

    info = dict(type=ftype, nfields=nf, sizes=[int(len(ix)) for ix in isets],
                schur_precondition=sprec if ftype == "schur" else None)

    def make_transpose():
        apply_t, inner_t = transpose_parts()
        return PC(name="fieldsplit_transpose", apply=apply_t, info=info,
                  inner=inner_t)

    return PC(name="fieldsplit", apply=apply, info=info, inner=inner0,
              make_transpose=make_transpose)


@register_pc("fieldsplit")
def pc_fieldsplit(pmat, opts: Options) -> PC:
    """PCFIELDSPLIT over contiguous fields (``-pc_fieldsplit_sizes``,
    ``-pc_fieldsplit_n0``) or strided components
    (``-pc_fieldsplit_block_size`` with ``-pc_fieldsplit_<i>_fields``);
    arbitrary index sets through :func:`pc_fieldsplit_is`.  Options as
    there; inner PCs ``-fieldsplit_<i>_pc_type ...``."""
    hm = _host(pmat, None, None)
    return pc_fieldsplit_is(hm, _fieldsplit_isets(opts, hm.csr.shape[0]),
                            opts)

"""Matrix/vector persistence: PETSc binary, MatrixMarket, npz band snapshots.

Covers the reference's persistence surface (SURVEY.md §5 checkpoint/resume):
PETSc binary MatLoad (reference/src/testbed.c:195-198) and
MatrixMarket export of reordered matrices (reference/src/wbm.c:516-524,
reference/src/HOWTO:4-5), plus native .npz snapshots of band storage and
of factorization state in the JAX package's checkpoint format, so that a
factor moves between the two packages.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .petsc_binary import read_mat, read_vec, write_mat, write_vec


def read_matrix_market(path: str) -> sp.csr_matrix:
    from scipy.io import mmread
    return sp.csr_matrix(mmread(path))


def write_matrix_market(path: str, a) -> None:
    from scipy.io import mmwrite
    mmwrite(path, sp.coo_matrix(a))


def load_matrix(path: str) -> sp.csr_matrix:
    """Format-sniffing loader: .mtx / .mm -> MatrixMarket, .npz -> scipy
    sparse npz, anything else -> PETSc binary."""
    lower = path.lower()
    if lower.endswith((".mtx", ".mm", ".mtx.gz")):
        return read_matrix_market(path)
    if lower.endswith(".npz"):
        return sp.csr_matrix(sp.load_npz(path))
    return read_mat(path)


def save_banded(path: str, band) -> None:
    """Snapshot band storage to .npz (the data comes to the host)."""
    np.savez_compressed(path, data=band.data.cpu().numpy(), kl=band.kl,
                        ku=band.ku)


def load_banded(path: str, device="cuda", dtype=None):
    """A band snapshot as a ``BandedMatrix`` on ``device`` (the card unless
    the caller names another), in ``dtype`` (default: the stored one)."""
    from ..ops.band import BandedMatrix
    z = np.load(path)
    data = torch.as_tensor(z["data"]).to(device=device, dtype=dtype)
    return BandedMatrix(data=data, kl=int(z["kl"]), ku=int(z["ku"]))


# ---------------------------------------------------------------------------
# Factor checkpoints (JAX io/__init__.py:54-162, the same .npz layout)
# ---------------------------------------------------------------------------

#: the JAX package's pytree flatten order of its factor dataclasses (the
#: order of their data fields; a None field holds no leaf): the leaves of
#: a checkpoint are ``leaf_<i>`` in this order
SPIKE_LEAF_FIELDS = ("fact", "Btip", "Ctip", "red_fact", "red_Dinv", "V",
                     "W", "Lb")
BLOCKTRI_LEAF_FIELDS = ("F", "U", "Sinv", "Slu", "piv", "nshift")
CR_LEAF_FIELDS = ("levels", "root_Dinv", "nshift")
CRLEVEL_LEAF_FIELDS = ("Dinv_e", "P", "Q", "L_e", "U_e")


def _describe_tri_factor(f) -> dict:
    """The structural descriptor of a partition or reduced factor (enough
    to rebuild it from its leaves)."""
    from ..ops.cyclic import CRFactor
    if isinstance(f, CRFactor):
        return dict(type="cr", levels=len(f.levels), nb=f.nb, n_pad=f.n_pad,
                    nshift=f.nshift is not None)
    from ..ops.blocktri import BlockTriFactor
    if not isinstance(f, BlockTriFactor):
        raise ValueError(f"cannot checkpoint a {type(f).__name__} factor "
                         "(the JAX format holds block-Thomas and CR ones)")
    return dict(type="blocktri", method=f.method,
                nshift=f.nshift is not None)


def _tri_leaves(f) -> list:
    """A partition or reduced factor's tensors in the JAX flatten order;
    pivots 0-based, as JAX stores them."""
    from ..ops.cyclic import CRFactor
    if isinstance(f, CRFactor):
        out = [getattr(lv, a) for lv in f.levels for a in CRLEVEL_LEAF_FIELDS]
        out.append(f.root_Dinv)
    else:
        out = [f.F, f.U, f.Sinv, f.Slu,
               f.piv - 1 if f.piv.numel() else f.piv]
    return out + ([] if f.nshift is None else [f.nshift])


def _spike_leaves(sf) -> list:
    leaves = []
    for name in SPIKE_LEAF_FIELDS:
        v = getattr(sf, name)
        if name in ("fact", "red_fact"):
            leaves += [] if v is None else _tri_leaves(v)
        elif v is not None:
            leaves.append(v)
    return leaves


def _to_numpy(t):
    """(array, exotic dtype name or None): bfloat16 as its 16-bit pattern
    (``uint16``), as the JAX package stores ml_dtypes leaves."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def save_factorization(path: str, sf) -> None:
    """Checkpoint a SpikeFactor to ``.npz`` in the JAX package's format
    (``__meta__`` JSON, ``leaf_<i>`` in its flatten order), so that either
    package loads what the other wrote.  Every spike_factor variant
    round-trips: block-Thomas (inv/spd/lu) and cyclic-reduction partition
    factors, Thomas/CR/truncated reduced systems, stored spikes, stored L
    blocks; the leaves come to the host.  The archive is written without
    deflate (``np.savez``): deflating a factor of gigabytes takes minutes,
    and both packages' loaders read either kind."""
    import json

    arrays, exotic = {}, {}
    for i, t in enumerate(_spike_leaves(sf)):
        a, name = _to_numpy(t)
        if name is not None:
            exotic[str(i)] = name
        arrays[f"leaf_{i}"] = a
    meta = dict(n=sf.n, K=sf.K, m=sf.m, b=sf.b, k=sf.k,
                truncated=sf.truncated,
                fact=_describe_tri_factor(sf.fact),
                red_fact=(None if sf.red_fact is None
                          else _describe_tri_factor(sf.red_fact)),
                has_red_dinv=sf.red_Dinv is not None,
                has_spikes=sf.V is not None,
                has_lb=sf.Lb is not None,
                exotic_dtypes=exotic)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _tri_from_leaves(desc: dict, take):
    """Rebuild a partition or reduced factor from its descriptor, taking
    its leaves in order from ``take()``."""
    from ..ops.blocktri import BlockTriFactor
    from ..ops.cyclic import CRFactor, CRLevel
    if desc["type"] == "cr":
        levels = tuple(CRLevel(*(take() for _ in CRLEVEL_LEAF_FIELDS))
                       for _ in range(desc["levels"]))
        root = take()
        return CRFactor(levels=levels, root_Dinv=root, nb=desc["nb"],
                        n_pad=desc["n_pad"],
                        nshift=take() if desc.get("nshift") else None)
    F, U, Sinv, Slu, piv = (take() for _ in BLOCKTRI_LEAF_FIELDS[:5])
    piv = (piv + 1 if piv.numel() else piv).to(torch.int32)
    return BlockTriFactor(F=F, U=U, Sinv=Sinv, method=desc["method"],
                          Slu=Slu, piv=piv,
                          nshift=take() if desc.get("nshift") else None)


def load_factorization(path: str, device="cuda"):
    """A SpikeFactor from a checkpoint written by either package (the
    round-1 JAX layout too), its tensors on ``device`` (the card unless the
    caller names another)."""
    import json

    from ..ops.spike import SpikeFactor

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = [z[f"leaf_{i}"] for i in range(
            len([k for k in z.files if k.startswith("leaf_")]))]
    n_leaves = len(arrays)
    exotic = meta.get("exotic_dtypes", {})

    def leaf(i):
        a = arrays[i]
        if exotic.get(str(i)) == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        if str(i) in exotic:
            raise ValueError(f"{path}: leaf {i} has dtype "
                             f"{exotic[str(i)]}, which torch does not hold")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if "fact" not in meta:
        # the round-1 layout: block-Thomas factors, the reduced system's
        # type inferred from K and truncated
        meta["fact"] = dict(type="blocktri", method=meta["method"])
        meta["red_fact"] = (meta["fact"]
                            if meta["K"] > 1 and not meta["truncated"]
                            else None)
        meta["has_red_dinv"] = meta["K"] > 1 and meta["truncated"]
        meta["has_spikes"] = False

    count = [0]

    def take():
        if count[0] >= n_leaves:
            raise ValueError(f"{path}: factor layout mismatch (more than "
                             f"{n_leaves} leaves needed)")
        count[0] += 1
        return leaf(count[0] - 1)

    fact = _tri_from_leaves(meta["fact"], take)
    Btip, Ctip = take(), take()
    red = (None if meta["red_fact"] is None
           else _tri_from_leaves(meta["red_fact"], take))
    red_dinv = take() if meta["has_red_dinv"] else None
    V, W = (take(), take()) if meta["has_spikes"] else (None, None)
    Lb = take() if meta.get("has_lb") else None
    if count[0] != n_leaves:
        raise ValueError(f"{path}: factor layout mismatch ({count[0]} vs "
                         f"{n_leaves} leaves)")
    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red,
                       red_Dinv=red_dinv, V=V, W=W, n=meta["n"], K=meta["K"],
                       m=meta["m"], b=meta["b"], k=meta["k"],
                       truncated=meta["truncated"], Lb=Lb)


__all__ = ["read_mat", "read_vec", "write_mat", "write_vec",
           "read_matrix_market", "write_matrix_market", "load_matrix",
           "save_banded", "load_banded", "save_factorization",
           "load_factorization", "SPIKE_LEAF_FIELDS", "BLOCKTRI_LEAF_FIELDS",
           "CR_LEAF_FIELDS", "CRLEVEL_LEAF_FIELDS"]

"""Matching tool — the reference's ``wbm`` executable
(reference/src/wbm.c:555-585) re-designed:

load (or build the documented 3x3 MC64 example), compute a weighted matching
(exact mc64, host awbm, or the device auction), optionally apply scalings,
permute, report the diagonal-weight product before/after
(CheckDiagonalWeight, reference/src/wbm.c:530-551), and export MatrixMarket
(reference/src/wbm.c:516-524).  ``-matching auction`` runs
``parallel.auction_match`` on the card (``-platform cpu``: on the CPU); the
rest is host work.

    python -m spike_petsc_tpu_torch.tools.wbm -filename a.bin -matching mc64 \\
        -scale 1 -outfilename permuted.mtx
"""

from __future__ import annotations

import sys

from .. import sparse as hsp
from ..io import load_matrix, write_matrix_market
from ..models.problems import mc64_doc_example
from ..utils.options import Options


def main(argv=None) -> int:
    opts = Options.from_argv(sys.argv[1:] if argv is None else argv)
    fname = opts.get_string("filename")
    a = load_matrix(fname) if fname else mc64_doc_example()
    a = hsp.as_csr(a)
    print(f"Matrix: n={a.shape[0]}, nnz={a.nnz}")

    kind = opts.get_string("matching", "awbm")
    if kind == "awbm":
        from ..ordering import awbm
        res = awbm(a)
    elif kind.startswith("mc64"):
        from ..ordering import mc64
        job = opts.get_int("mc64_job", 5)
        res = mc64(a, job=job)
    elif kind == "auction":
        from ..parallel.matching_dev import auction_match
        platform = opts.get_string("platform", "cuda")
        res = auction_match(a, device="cpu" if platform == "cpu" else None)
    else:
        print(f"unknown matching {kind!r}", file=sys.stderr)
        return 1
    print(f"Matching info: {res.info}")

    scale = opts.get_bool("scale", False)
    work = hsp.diagonal_scale(a, res.row_scale, res.col_scale) \
        if scale and res.row_scale is not None else a
    name = "scaled" if scale else "original"
    print(f"Diagonal weight for {name} matrix: "
          f"{hsp.diagonal_weight_product(work):g}")
    p = hsp.permute(work, res.rperm, res.cperm)
    pname = "permuted and scaled" if scale else "permuted"
    print(f"Diagonal weight for {pname} matrix: "
          f"{hsp.diagonal_weight_product(p):g}")

    out = opts.get_string("outfilename")
    if out:
        write_matrix_market(out, p)
        print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

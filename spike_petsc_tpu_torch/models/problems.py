"""Model problem generators — the framework's test/benchmark matrix families.

The reference's fixtures are external SuiteSparse binaries
(reference/src/HOWTO:2,5 — not shipped in the repo) plus a hard-coded
3x3 example from the HSL MC64 documentation
(reference/src/wbm.c:485-498).  Since this environment has zero egress,
the parity/benchmark suite (BASELINE.md configs 1-5) is driven by synthetic
generators that reproduce each config's structure:

1. ``tridiag_laplacian``      — 1D Laplacian, the minimum end-to-end slice.
2. ``spd_banded``             — random SPD band, diagonally dominant.
3. ``illscaled_nonsym``       — nonsymmetric band with wild row/col scalings
                                 and a scrambled heavy diagonal (MC64 food).
4. ``laplacian_2d``           — 5-point stencil (SuiteSparse ecology2-like
                                 structure: banded after natural ordering).
5. any of the above partitioned across a mesh (parallel tests).

All generators but one return NumPy/SciPy host objects; conversion to
device band storage is explicit (``convert.banded_from_*``).
``blocktri_diagdom_device`` assembles the flagship class in
block-tridiagonal layout on the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def tridiag_laplacian(n: int, dtype=np.float64) -> sp.csr_matrix:
    """1D Laplacian stencil [-1, 2, -1] (BASELINE config 1)."""
    return sp.diags(
        [-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
        offsets=[-1, 0, 1], format="csr", dtype=dtype)


def zero_diag_tridiag(n: int, dtype=np.float64) -> sp.csr_matrix:
    """Tridiagonal [-1, 0, -1] with an all-zero diagonal: nonsingular for
    even n, but every diagonal pivot is zero — the case the reference's
    testbed explicitly counts (reference/src/testbed.c:266-272) and
    PETSc survives only with -pc_factor_shift_type nonzero
    (reference/src/makefile:18)."""
    if n % 2:
        raise ValueError("zero_diag_tridiag needs even n for nonsingularity")
    return sp.diags(
        [-np.ones(n - 1), np.zeros(n), -np.ones(n - 1)],
        offsets=[-1, 0, 1], format="csr", dtype=dtype)


def spd_banded(n: int, k: int, seed: int = 0, dtype=np.float64) -> sp.csr_matrix:
    """Random SPD banded matrix with half-bandwidth k (BASELINE config 2).

    Built as B + B^T + diagonal boost, guaranteeing symmetric positive
    definiteness via strict diagonal dominance.
    """
    rng = np.random.default_rng(seed)
    diags, offsets = [], []
    for d in range(1, k + 1):
        v = rng.uniform(-1.0, 1.0, size=n - d)
        diags += [v, v]
        offsets += [d, -d]
    a = sp.diags(diags, offsets, shape=(n, n), format="csr", dtype=dtype)
    row_abs = np.asarray(np.abs(a).sum(axis=1)).ravel()
    a = a + sp.diags(row_abs + 1.0, 0, format="csr", dtype=dtype)
    return a.tocsr()


def nonsym_banded(n: int, kl: int, ku: int, seed: int = 0,
                  dominance: float = 1.5, dtype=np.float64) -> sp.csr_matrix:
    """Random nonsymmetric banded matrix, row-wise diagonally dominant."""
    rng = np.random.default_rng(seed)
    diags, offsets = [], []
    for d in range(1, kl + 1):
        diags.append(rng.uniform(-1.0, 1.0, size=n - d))
        offsets.append(-d)
    for d in range(1, ku + 1):
        diags.append(rng.uniform(-1.0, 1.0, size=n - d))
        offsets.append(d)
    a = sp.diags(diags, offsets, shape=(n, n), format="csr", dtype=dtype)
    row_abs = np.asarray(np.abs(a).sum(axis=1)).ravel()
    signs = rng.choice([-1.0, 1.0], size=n)
    a = a + sp.diags(signs * (dominance * row_abs + 1.0), 0, format="csr",
                     dtype=dtype)
    return a.tocsr()


def illscaled_nonsym(n: int, kl: int, ku: int, seed: int = 0,
                     scale_decades: float = 8.0,
                     permute: bool = True, dtype=np.float64) -> sp.csr_matrix:
    """Ill-scaled, row/col-permuted nonsymmetric band (BASELINE config 3).

    Starts from a dominant band, applies random row/col scalings spanning
    ``scale_decades`` orders of magnitude, then hides the heavy diagonal with
    a random row permutation — the matrix family MC64 scaling/permutation
    (reference/src/hslmc64.c job=5) is designed to repair.
    """
    rng = np.random.default_rng(seed)
    a = nonsym_banded(n, kl, ku, seed=seed, dtype=dtype)
    dr = 10.0 ** rng.uniform(-scale_decades / 2, scale_decades / 2, size=n)
    dc = 10.0 ** rng.uniform(-scale_decades / 2, scale_decades / 2, size=n)
    a = sp.diags(dr) @ a @ sp.diags(dc)
    if permute:
        p = rng.permutation(n)
        a = a.tocsr()[p, :]
    return a.tocsr().astype(dtype)


def neumann_laplacian_1d(n: int, dtype=np.float64) -> sp.csr_matrix:
    """1-D Neumann (pure-flux) Laplacian: tridiagonal, row sums zero,
    SINGULAR with the constant null vector — the MatNullSpace test case
    (the reference's graph Laplacians share this structure,
    reference/src/spectralPartition.c:63-139, L*1 = 0 check
    :264-272).  Pair with ``-ksp_nullspace_constant``."""
    d = 2.0 * np.ones(n, dtype=dtype)
    d[0] = d[-1] = 1.0
    o = -np.ones(n - 1, dtype=dtype)
    return sp.diags([o, d, o], [-1, 0, 1], format="csr", dtype=dtype)


def laplacian_2d(nx: int, ny: int, dtype=np.float64) -> sp.csr_matrix:
    """2D 5-point Laplacian on an nx-by-ny grid (BASELINE config 4 stand-in).

    Natural (row-major) ordering gives half-bandwidth nx — the classic
    banded-extraction target.
    """
    ix = sp.identity(nx, dtype=dtype)
    iy = sp.identity(ny, dtype=dtype)
    tx = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                  [-1, 0, 1], dtype=dtype)
    ty = sp.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)],
                  [-1, 0, 1], dtype=dtype)
    return (sp.kron(iy, tx) + sp.kron(ty, ix)).tocsr()


def mc64_doc_example(dtype=np.float64) -> sp.csr_matrix:
    """The 3x3 example from the HSL MC64 documentation, the reference's
    built-in fallback fixture (reference/src/wbm.c:485-498):

        [ 0  8  3 ]
        [ 0  2  1 ]
        [ 4  0  0 ]
    """
    rows = np.array([0, 0, 1, 1, 2])
    cols = np.array([1, 2, 1, 2, 0])
    vals = np.array([8.0, 3.0, 2.0, 1.0, 4.0], dtype=dtype)
    return sp.csr_matrix((vals, (rows, cols)), shape=(3, 3))


def general_sparse(n: int, density: float = 5e-3, seed: int = 0,
                   band_heavy: bool = True, dtype=np.float64) -> sp.csr_matrix:
    """General unstructured sparse matrix with (optionally) most of its mass
    near the diagonal — exercises the Fiedler-reorder + banded-extraction
    drop-off preconditioner path (BASELINE config 4)."""
    rng = np.random.default_rng(seed)
    nnz = max(int(density * n * n), 4 * n)
    rows = rng.integers(0, n, size=nnz)
    if band_heavy:
        spread = rng.geometric(p=min(0.2, 50.0 / n), size=nnz) * \
            rng.choice([-1, 1], size=nnz)
        cols = np.clip(rows + spread, 0, n - 1)
    else:
        cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=dtype)
    row_abs = np.asarray(np.abs(a).sum(axis=1)).ravel()
    a = a + sp.diags(1.1 * row_abs + 1.0, 0, dtype=dtype)
    return a.tocsr()


def blocktri_diagdom_device(n: int, kl: int, ku: int, K: int, b: int,
                            seed: int = 0, dtype="float32", device=None):
    """Diagonally-dominant random banded matrix assembled DIRECTLY in global
    block-tridiagonal (p-major) layout on the device (the card unless
    ``device`` names another): the native assembly path of
    ``spike_factor_blocks`` (JAX ``models/problems.py:168-223``).

    Statistically the flagship band (uniform(-1, 1) band entries, the
    diagonal the row's 1-norm + 1) but built as [NB, b, b] D/L/U blocks
    with static band masks, so the factor pays no layout conversion.  Rows
    and columns beyond ``n`` are unit-diagonal padding, so that
    NB = K * ceil(ceil(n / K) / b) blocks partition evenly.  The draws are
    three ``torch.rand`` calls on the device from a ``torch.Generator``
    seeded by ``seed``, mapped to [-1, 1) (a torch generator cannot
    reproduce ``jax.random``'s bits: the draws agree with JAX's in their
    statistics); ``_assemble_diagdom`` turns them into the matrix as JAX
    does.

    Returns (T: BlockTridiagonal [NB, b, b], n_pad).
    """
    if kl > b or ku > b:
        raise ValueError(f"half-bandwidths (kl={kl}, ku={ku}) must be <= b")
    import torch
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    device = torch.device(device or "cuda")
    rows = -(-n // K)
    m = -(-rows // b) * b
    NB = K * (m // b)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, L, U = (torch.rand((NB, b, b), generator=gen, device=device,
                          dtype=dt) * 2 - 1 for _ in range(3))
    return _assemble_diagdom(D, L, U, n, kl, ku, b), NB * b


def _assemble_diagdom(D, L, U, n: int, kl: int, ku: int, b: int):
    """The blocks of ``blocktri_diagdom_device`` from its draws (each
    [NB, b, b] in [-1, 1)), line for line JAX's: the band masks, zero rows
    and columns past ``n``, U[NB - 1] = 0, L[0] = 0, and the diagonal the
    row's 1-norm + 1 (1 past ``n``)."""
    import torch
    from ..ops.blocktri import BlockTridiagonal
    NB, dt, dev = D.shape[0], D.dtype, D.device
    p = torch.arange(b, device=dev)[:, None]
    q = torch.arange(b, device=dev)[None, :]
    mD = ((q - p <= ku) & (p - q <= kl)).to(dt)              # |j - r| band
    mU = (b + q - p <= ku).to(dt)                            # j = r + b + ...
    # L holds A[r, j] with j = r - b + (q - p): the band bound r - j <= kl
    # is q - p >= b - kl (the upper bound j <= r + ku is vacuous here)
    mL = (q - p >= b - kl).to(dt)
    # global row/col validity: rows >= n are identity, cols >= n are zero
    i = torch.arange(NB, device=dev)[:, None, None]
    r_glob = i * b + p[None]                                 # [NB, b, 1]
    row_ok = r_glob < n
    colD_ok = (i * b + q[None]) < n
    colU_ok = ((i + 1) * b + q[None]) < n
    colL_ok = ((i - 1) * b + q[None]) < n
    D = D * mD * row_ok * colD_ok
    U = U * mU * row_ok * colU_ok
    U[NB - 1] = 0
    L = L * mL * row_ok * colL_ok
    L[0] = 0
    rowsum = (D.abs().sum(dim=-1) + L.abs().sum(dim=-1)
              + U.abs().sum(dim=-1))                         # [NB, b]
    diag = torch.where(row_ok[..., 0], rowsum + 1.0,
                       torch.ones((), dtype=dt, device=dev))
    eye = torch.eye(b, dtype=dt, device=dev)
    D = D * (1.0 - eye) + diag[..., :, None] * eye
    return BlockTridiagonal(D=D, L=L, U=U)

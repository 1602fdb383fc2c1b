"""The plain reference for banded systems, in plain PyTorch.

It takes the band as its entries ``data[i, j] = A[i, i + j - kl]`` (slots
that fall outside the matrix are ignored) and right-hand sides ``B [n, r]``,
and works the answers out by itself: ``band_matvec`` is the product A X,
``solve_band`` a direct block-tridiagonal elimination (block Thomas, one
partition, blocks of ``block`` rows, a pivoted LU of each diagonal block),
both in float64 by default.  It imports nothing of the program under test
and takes nothing the program made.

``matvec`` and ``solve`` are what the harness calls on every reference:
each takes the configuration (here its ``kl`` and ``ku``) and the matrix as
the configuration's generator makes it (here the band's entries).

``solve(..., dtype=torch.float32, tf32_products=True)`` is the check's
control: the same elimination in float32 with every block product's
operands rounded to TF32 (10 explicit mantissa bits), the precision a
matrix product on the card takes with TF32 on.  The rounding is done here,
so the control reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

# block rows gathered out of the band in one call
_CHUNK = 256


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def band_matvec(data: torch.Tensor, kl: int, ku: int, X: torch.Tensor,
                dtype=torch.float64) -> torch.Tensor:
    """A X in ``dtype`` for ``X [n]`` or ``[n, r]``, a diagonal at a time."""
    n, w = data.shape
    if w != kl + ku + 1:
        raise ValueError(f"band width {w} != kl + ku + 1 = {kl + ku + 1}")
    vec = X.dim() == 1
    X = X.reshape(n, -1).to(dtype)
    Xp = torch.zeros((n + w - 1, X.shape[1]), dtype=dtype, device=X.device)
    Xp[kl:kl + n] = X
    Y = torch.zeros((n, X.shape[1]), dtype=dtype, device=X.device)
    for j in range(w):
        Y.addcmul_(data[:, j:j + 1].to(dtype), Xp[j:j + n])
    return Y[:, 0] if vec else Y


def _block_rows(data, kl, n, b, c0, c1, idx, valid, dtype):
    """Block rows c0 .. c1 - 1 as dense ``[c, b, 3b]`` (the blocks left of,
    on and right of the diagonal); rows past n are identity rows."""
    w = data.shape[1]
    rows = data[c0 * b:min(c1 * b, n)].to(dtype)
    short = (c1 - c0) * b - rows.shape[0]
    if short:
        pad = torch.zeros((short, w), dtype=dtype, device=data.device)
        pad[:, kl] = 1
        rows = torch.cat([rows, pad])
    rows = rows.reshape(c1 - c0, b, w)
    got = torch.gather(rows, 2, idx.expand(c1 - c0, b, 3 * b))
    return torch.where(valid, got, torch.zeros((), dtype=dtype,
                                               device=data.device))


def solve_band(data: torch.Tensor, kl: int, ku: int, B: torch.Tensor, *,
               block: int = 128, dtype=torch.float64,
               tf32_products: bool = False) -> torch.Tensor:
    """X with A X = B (``B [n, r]``), by block Thomas over blocks of
    ``max(block, kl, ku)`` rows, in ``dtype``; ``tf32_products`` rounds
    both operands of every block product to TF32 (the control).  Raises
    ``FloatingPointError`` on a singular diagonal block."""
    n, w = data.shape
    b = max(block, kl, ku, 1)
    nb = -(-n // b)
    r = B.shape[1]
    dev = data.device
    p = torch.arange(b, device=dev)[:, None]
    q = torch.arange(3 * b, device=dev)[None, :]
    idx = q - b - p + kl                     # band slot of (row p, column q)
    valid = (idx >= 0) & (idx < w)
    idx = idx.clamp(0, w - 1)

    def mm(a, c):
        return tf32(a) @ tf32(c) if tf32_products else a @ c

    Bp = torch.zeros((nb * b, r), dtype=dtype, device=dev)
    Bp[:n] = B.to(dtype)
    Bp = Bp.reshape(nb, b, r)
    # CG[i] = S_i^-1 [U_i | y_i]: the eliminated block row
    CG = torch.empty((nb, b, b + r), dtype=dtype, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for c0 in range(0, nb, _CHUNK):
        c1 = min(c0 + _CHUNK, nb)
        R = _block_rows(data, kl, n, b, c0, c1, idx, valid, dtype)
        for i in range(c0, c1):
            L, D, U = R[i - c0, :, :b], R[i - c0, :, b:2 * b], \
                R[i - c0, :, 2 * b:]
            rhs = torch.cat([U, Bp[i]], dim=1)
            if i:
                S = D - mm(L, CG[i - 1, :, :b])
                rhs[:, b:] -= mm(L, CG[i - 1, :, b:])
            else:
                S = D
            sol, bad = torch.linalg.solve_ex(S, rhs)
            CG[i] = sol
            info = torch.maximum(info, bad)
    if int(info):
        raise FloatingPointError("solve_band: a singular diagonal block")
    X = CG[:, :, b:].clone()
    for i in range(nb - 2, -1, -1):
        X[i] -= mm(CG[i, :, :b], X[i + 1])
    return X.reshape(nb * b, r)[:n]


def matvec(cfg: dict, data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A X in float64: the pool's right-hand sides."""
    return band_matvec(data, cfg["kl"], cfg["ku"], X)


def solve(cfg: dict, data: torch.Tensor, B: torch.Tensor,
          **kw) -> torch.Tensor:
    """X with A X = B, by ``solve_band`` (float64; ``dtype=torch.float32,
    tf32_products=True``: the control)."""
    return solve_band(data, cfg["kl"], cfg["ku"], B, **kw)

"""Differentiable banded solves (implicit-function adjoint), PyTorch.

The port of ``spike_petsc_tpu.ops.autodiff``: ``solve_banded_diff`` is a
banded SPIKE solve that takes part in ``torch.autograd``.  The gradients of
x = A^-1 b are the implicit adjoint

    dL/db             = A^-T g                 (one transpose SPIKE solve)
    dL/ddata[i, d]    = -lam[i] * x[i + d - kl],   lam = A^-T g

so the backward pass reuses the forward factorization through
``spike_transpose`` plus one solve, and never differentiates through the
factorization recurrences.
"""

from __future__ import annotations

import torch

from .band import BandedMatrix
from .cuda.sweeps import default_block
from .spike import spike_factor, spike_solve, spike_transpose


def band_cotangent(lam: torch.Tensor, x: torch.Tensor, kl: int,
                   ku: int) -> torch.Tensor:
    """dL/ddata of x = A^-1 b given lam = A^-T g: ``ddata[i, d] = -lam[i] *
    x[i + d - kl]``, built from kl + ku + 1 shifted slices of the padded x
    (zero where column i + d - kl lies outside the matrix)."""
    n = x.shape[0]
    xpad = torch.nn.functional.pad(x, (kl, ku))
    xg = torch.stack([xpad[d:d + n] for d in range(kl + ku + 1)], dim=1)
    return -lam[:, None] * xg


class _SolveBandedDiff(torch.autograd.Function):
    """Forward: factor and solve; backward: the transpose solve on the
    same factors and the band-restricted outer product."""

    @staticmethod
    def forward(ctx, data, rhs, kl, ku, K):
        band = BandedMatrix(data=data, kl=kl, ku=ku)
        block = default_block(None, max(kl, ku, 1), "inv", data.is_cuda)
        sf = spike_factor(band, K=K, block_b=block)
        x = spike_solve(sf, rhs)
        ctx.sf, ctx.band, ctx.kl, ctx.ku = sf, band, kl, ku
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        sf, kl, ku = ctx.sf, ctx.kl, ctx.ku
        # the band gives the regular-form transpose, which the kernels take
        lam = spike_solve(spike_transpose(sf, band=ctx.band), g)
        ddata = band_cotangent(lam, x, kl, ku)
        # the data cotangent in the PRIMAL data dtype (Btip keeps it where
        # the factor storage is cast), the rhs cotangent in x's
        return (ddata.to(sf.Btip.dtype), lam.to(x.dtype), None, None, None)


def solve_banded_diff(data: torch.Tensor, rhs: torch.Tensor, kl: int,
                      ku: int, K: int = 1) -> torch.Tensor:
    """Differentiable solve of the banded system of diagonal-offset ``data``
    (``[n, kl+ku+1]``); gradients flow to ``data`` and ``rhs``.

    The forward pass is ``spike_factor(band, K=K)`` and ``spike_solve``; the
    backward pass ``spike_solve(spike_transpose(sf, band=band), g)``.  On
    the CPU the block is the tip size, as in JAX.  On the card it is the
    smallest block the sweep kernels take (64 or 128), so both passes run
    the sweep kernels (#1, or #9 for a long single partition), and a K > 1
    factor's partition boundaries differ from the CPU's (rows round up to
    the block)."""
    return _SolveBandedDiff.apply(data, rhs, int(kl), int(ku), int(K))

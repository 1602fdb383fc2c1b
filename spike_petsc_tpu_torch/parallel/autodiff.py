"""Differentiable distributed banded solves (implicit-function adjoint).

The port of ``spike_petsc_tpu.parallel.autodiff``: the mesh versions of
``ops.autodiff.solve_banded_diff``, each a ``torch.autograd.Function``.
The forward pass factors and solves over the mesh; the backward pass
reuses the forward factorization through the distributed transpose (no
refactorization) plus one solve,

    dL/db          = A^-T g
    dL/ddata[i, d] = -lam[i] * x[i + d - kl],

so the gradients never differentiate through the factorization.

* :func:`dist_solve_banded_diff` (1-D mesh): a direct SPIKE solve both
  ways, the factor with ``inverter="blocked"`` (JAX keeps the Newton
  probe, a host-level retry, out of a differentiated computation);
* :func:`dist_solve_banded_diff_multislice` ((slice, p) mesh): GMRES with
  the per-slice SPIKE PC forward, and on A^T for the adjoint, so the
  gradients are exact to ``rtol``.

As every entry point of the mesh, every rank passes the same global
``data`` and ``rhs`` and gets the global x; every rank runs the backward
pass with the same global cotangent g and gets the same gradients.
"""

from __future__ import annotations

import torch

from ..ops.autodiff import band_cotangent
from ..ops.band import BandedMatrix
from .spike_dist import (_dist_spike_factor_impl,
                         _dist_spike_factor_multislice_impl,
                         dist_spike_solve, dist_spike_transpose,
                         dist_spike_transpose_multislice,
                         make_dist_solver_multislice)

_BLOCKED = dict(method="inv", reduced="auto", store_spikes=False,
                store_dtype=None, spike_dtype=None, shift="none",
                shift_amount=0.0, inverter="blocked")


class _DistSolveBandedDiff(torch.autograd.Function):
    """Forward: the blocked mesh factor and the SPIKE solve; backward: the
    transpose solve on the same factors and the band outer product."""

    @staticmethod
    def forward(ctx, data, rhs, kl, ku, mesh, axis, block_b,
                parts_per_device):
        dsf = _dist_spike_factor_impl(
            BandedMatrix(data=data, kl=kl, ku=ku), mesh, axis,
            truncated=False, block_b=block_b,
            parts_per_device=parts_per_device, **_BLOCKED)
        x = dist_spike_solve(dsf, rhs, mesh, axis)
        ctx.dsf, ctx.mesh, ctx.axis, ctx.kl, ctx.ku = dsf, mesh, axis, kl, ku
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dsft = dist_spike_transpose(ctx.dsf, ctx.mesh, ctx.axis,
                                    inverter="blocked")
        lam = dist_spike_solve(dsft, g, ctx.mesh, ctx.axis)
        ddata = band_cotangent(lam, x, ctx.kl, ctx.ku)
        # the data cotangent in the PRIMAL data dtype (Btip keeps it)
        return (ddata.to(ctx.dsf.Btip.dtype), lam.to(x.dtype), None, None,
                None, None, None, None)


def dist_solve_banded_diff(data: torch.Tensor, rhs: torch.Tensor, kl: int,
                           ku: int, mesh, axis: str = "p",
                           block_b: int = None,
                           parts_per_device: int = 1) -> torch.Tensor:
    """Differentiable solve of the banded system of diagonal-offset
    ``data`` (``[n, kl+ku+1]``) partitioned over ``mesh.shape[axis]`` ranks
    (times ``parts_per_device``); gradients flow to ``data`` and ``rhs``."""
    return _DistSolveBandedDiff.apply(data, rhs, int(kl), int(ku), mesh,
                                      axis, block_b, int(parts_per_device))


def _ms_solve(dsf, rhs, mesh, axis_slice, axis_p, rtol, maxit):
    return make_dist_solver_multislice(
        dsf, mesh, axis_slice, axis_p, ksp_type="gmres", rtol=rtol,
        maxit=maxit)(rhs).x


class _DistSolveBandedDiffMultislice(torch.autograd.Function):
    """Forward: the blocked multislice factor and GMRES; backward: GMRES
    on A^T preconditioned by the transpose of the same per-slice factors,
    then the band outer product."""

    @staticmethod
    def forward(ctx, data, rhs, kl, ku, mesh, axis_slice, axis_p, block_b,
                parts_per_device, rtol, maxit):
        dsf = _dist_spike_factor_multislice_impl(
            BandedMatrix(data=data, kl=kl, ku=ku), mesh, axis_slice, axis_p,
            block_b=block_b, parts_per_device=parts_per_device, **_BLOCKED)
        x = _ms_solve(dsf, rhs, mesh, axis_slice, axis_p, rtol, maxit)
        ctx.dsf, ctx.mesh, ctx.kl, ctx.ku = dsf, mesh, kl, ku
        ctx.axes, ctx.tol = (axis_slice, axis_p), (rtol, maxit)
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dsft = dist_spike_transpose_multislice(ctx.dsf, ctx.mesh, *ctx.axes,
                                               inverter="blocked")
        lam = _ms_solve(dsft, g, ctx.mesh, *ctx.axes, *ctx.tol)
        ddata = band_cotangent(lam, x, ctx.kl, ctx.ku)
        return (ddata.to(ctx.dsf.Btip.dtype), lam.to(x.dtype)) + (None,) * 9


def dist_solve_banded_diff_multislice(
        data: torch.Tensor, rhs: torch.Tensor, kl: int, ku: int, mesh,
        axis_slice: str = "slice", axis_p: str = "p", block_b: int = None,
        parts_per_device: int = 1, rtol: float = 1e-12,
        maxit: int = 200) -> torch.Tensor:
    """Differentiable banded solve on a (slice, p) mesh: GMRES with the
    per-slice SPIKE PC forward and on A^T for the adjoint.  The gradients
    flow to ``data`` and ``rhs`` and are exact to ``rtol``."""
    return _DistSolveBandedDiffMultislice.apply(
        data, rhs, int(kl), int(ku), mesh, axis_slice, axis_p, block_b,
        int(parts_per_device), float(rtol), int(maxit))

"""The port's differentiable mesh solves on gloo ranks against the JAX
package's (virtual CPU devices), f64.

* ``dist_solve_banded_diff`` at P = 2 and P = 4: ``torch.autograd.grad`` of
  sum(x^2) against ``jax.grad`` of the same loss through JAX's version on
  ``make_mesh(P)``, both gradients within 1e-10 of JAX's (relative to
  their largest entry);
* ``dist_solve_banded_diff_multislice`` on (2, 2) at rtol 1e-13: the
  gradients within 1e-8 of the port's single-device ``solve_banded_diff``
  (K = 8, the partitions of the JAX package's own test) and within 1e-10
  of JAX's multislice gradients (the same GMRES iterations both ways).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.parallel import (dist_solve_banded_diff,
                                      dist_solve_banded_diff_multislice,
                                      make_mesh, make_mesh_multislice)

import torch_dist_ms_cases as M
from test_torch_dist import close, same_on_every_rank
from torch_dist_worker import run_ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {P: run_ranks(P, "torch_dist_ms_cases:autodiff_program",
                         tmp_path_factory.mktemp(f"autodiff{P}"))
            for P in (2, 4)}


def jax_grads(solve, seed):
    """``jit(grad)`` of sum(x^2) (an eager ``shard_map`` is ~20x
    slower)."""
    data, b, kl, ku = M.autodiff_input(seed)

    def loss(d, r):
        return jnp.sum(jnp.square(solve(d, r, kl, ku)))
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(data),
                                                   jnp.asarray(b))


@pytest.mark.parametrize("P", [2, 4])
def test_dist_gradients_match_jax(worlds, P):
    got = same_on_every_rank(worlds[P], "dist")
    mesh = make_mesh(P, axis="p")
    gd, gb = jax_grads(lambda d, r, kl, ku: dist_solve_banded_diff(
        d, r, kl, ku, mesh, block_b=8), 7)
    close(got["gd"], gd, 1e-10)
    close(got["gb"], gb, 1e-10)


def test_multislice_gradients(worlds):
    got = same_on_every_rank(worlds[4], "multislice")
    close(got["gd"], got["single_gd"], 1e-8)
    close(got["gb"], got["single_gb"], 1e-8)
    mesh = make_mesh_multislice((2, 2))
    gd, gb = jax_grads(lambda d, r, kl, ku: dist_solve_banded_diff_multislice(
        d, r, kl, ku, mesh, block_b=8, rtol=1e-13), 17)
    close(got["gd"], gd, 1e-10)
    close(got["gb"], gb, 1e-10)

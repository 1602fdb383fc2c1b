"""The port's ``make_dist_solver_batched`` on the 2-D (rhs = 2, p = 2) mesh
of four gloo ranks against the JAX package's (``make_mesh_2d((2, 2))`` on
the virtual CPU devices): preonly, richardson on bf16-stored factors
(f32), the ``krylov_many`` engines gmres, bcgs and cg, and tfqmr one
right-hand side at a time.  Four right-hand sides, two a mesh row.

Every column within 1e-10 of JAX's in f64 (relative to its largest entry;
the sums run in another order), and of the true solution to the solver's
tolerance; richardson's f32 columns within 1e-5 of JAX's.  The iteration
counts are not returned by the batched solver (as in JAX); the columns
agreeing to 1e-10 where the solver stops at rtol 1e-10 pins them.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import make_mesh_2d
from spike_petsc_tpu.parallel.spike_dist import (dist_spike_factor,
                                                 make_dist_solver_batched)

import torch_dist_cases as C
from torch_dist_worker import case_result, run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "torch_dist_cases:batched_program",
                     tmp_path_factory.mktemp("batched"))


@pytest.mark.parametrize("case", list(C.BATCHED_CASES))
def test_make_dist_solver_batched(ranks, case):
    got = case_result(ranks, case)
    for r in range(1, 4):
        np.testing.assert_array_equal(case_result(ranks, case, r)["x"],
                                      got["x"])
    args, fopts, sopts, f32 = C.BATCHED_CASES[case]
    data, kl, ku, R = C.batched_input(case)
    dt = jnp.float32 if f32 else jnp.float64
    names = {"bf16": jnp.bfloat16}
    fopts = {k: names.get(v, v) if k.endswith("dtype") else v
             for k, v in fopts.items()}
    mesh2 = make_mesh_2d((2, 2), axes=("rhs", "p"))
    dsf = jax.jit(lambda d: dist_spike_factor(
        BandedMatrix(data=d, kl=kl, ku=ku), mesh2, axis="p",
        safety_net=False, **fopts))(jnp.asarray(data, dt))
    X = np.asarray(make_dist_solver_batched(dsf, mesh2, **sopts)(
        jnp.asarray(R, dt)))
    assert got["x"].shape == X.shape == R.shape
    tol = 1e-5 if f32 else 1e-10
    for j in range(R.shape[0]):
        err = np.abs(got["x"][j] - X[j]).max()
        assert err <= tol * np.abs(X[j]).max(), (j, err)
        truth = C.rhs(data.shape[0], 200 + j)
        assert np.abs(got["x"][j] - truth).max() <= 1e-4 * np.abs(
            truth).max()

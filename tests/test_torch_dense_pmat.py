"""PyTorch port, a dense 2-D tensor as the operator and PC matrix, against
the JAX package with a dense ``jnp`` array, on the CPU in f64.

JAX's PCs take any matrix through ``sparse.as_csr`` (``np.asarray`` of a
dense array); the port's ``solvers/pc.py`` ``_place`` takes a dense tensor
the same way, as a host matrix of its values on the tensor's device in its
dtype.  Every PC that builds from such a matrix: jacobi (each
``-pc_jacobi_type``), spike, lu, cholesky, bjacobi and banded.

Tolerances: iteration counts and reasons exactly; x within 1e-10 of JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spike_petsc_tpu import Options as JOptions
from spike_petsc_tpu import solve as j_solve
from spike_petsc_tpu.models import problems
from spike_petsc_tpu_torch import Options, solve

X_TOL = 1e-10

PCS = (("jacobi", {}), ("jacobi", {"pc_jacobi_type": "rowmax"}),
       ("jacobi", {"pc_jacobi_type": "rowsum"}),
       ("jacobi", {"pc_jacobi_abs": "1"}),
       ("spike", {"pc_spike_partitions": "4"}), ("lu", {}), ("cholesky", {}),
       ("bjacobi", {"pc_bjacobi_blocks": "4"}),
       ("banded", {"pc_banded_kmax": "4", "pc_banded_frac": "0.99"}))


def _tridiagonal(n=40):
    """The 40-row tridiagonal case: 4 on the diagonal, -1 above, -2
    below."""
    return (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1)
            + np.diag(np.full(n - 1, -2.0), -1))


def _banded(n=200):
    """A nonsymmetric band (kl = ku = 3) as a dense matrix."""
    return problems.nonsym_banded(n, 3, 3, seed=7, dominance=0.5).toarray()


@pytest.mark.parametrize("pc,opts", PCS,
                         ids=[f"{p}-{'-'.join(o.values()) or 'default'}"
                              for p, o in PCS])
@pytest.mark.parametrize("make", [_tridiagonal, _banded],
                         ids=["tridiag40", "banded200"])
def test_dense_tensor_pmat_matches_jax(make, pc, opts):
    a = make()
    b = a @ np.random.default_rng(3).uniform(size=a.shape[0])
    kw = dict(ksp_type="gmres", pc_type=pc, rtol=1e-10, maxit=200)
    jr = j_solve(jnp.asarray(a), jnp.asarray(b), options=JOptions(dict(opts)),
                 **kw)
    r = solve(torch.as_tensor(a), torch.as_tensor(b),
              options=Options(dict(opts)), **kw)
    assert r.x.dtype == torch.float64 and not r.x.is_cuda
    assert (int(r.its), int(r.reason)) == (int(jr.its), int(jr.reason))
    assert int(r.reason) > 0
    assert np.abs(r.x.numpy() - np.asarray(jr.x)).max() <= X_TOL


def test_dense_tensor_pmat_keeps_its_device_and_dtype():
    """The PC matrix lands where the tensor lies, in its dtype, whatever
    ``make_pc`` is told for host matrices."""
    from spike_petsc_tpu_torch.solvers.pc import HostMatrix, _place
    t = torch.as_tensor(_tridiagonal(), dtype=torch.float32)
    hm = _place(t, device="cuda", dtype=torch.float64)
    assert isinstance(hm, HostMatrix)
    assert hm.device == t.device and hm.dtype == torch.float32
    np.testing.assert_array_equal(hm.csr.toarray(), t.numpy())

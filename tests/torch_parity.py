"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; JAX runs on the CPU as its own tests run it (x64 on, Pallas
kernels in interpret mode).  Importing this module does not import JAX,
so the card tests (tests/test_torch_cuda.py) can use it on a machine
without JAX.
"""

import numpy as np
import pytest
import torch

# the port's conversions default to the card; the CPU tests name the CPU
CPU = torch.device("cpu")


def random_band(n, kl, ku, seed=0, dtype=np.float64, dominant=True):
    """A random band in diagonal-offset storage, edge rows' out-of-range
    slots left NONZERO (they must multiply zero everywhere).  ``dominant``
    sets the diagonal to the row's absolute sum + 1, as bench.py builds the
    flagship band."""
    rng = np.random.default_rng(seed)
    w = kl + ku + 1
    data = rng.uniform(-1.0, 1.0, (n, w))
    if dominant:
        data[:, kl] = np.abs(data).sum(axis=1) + 1.0
    return data.astype(dtype)


def spd_band(n, k, seed=0, dtype=np.float64):
    """A random symmetric, diagonally dominant band in diagonal-offset
    storage: the matrix of ``models.problems.spd_banded(n, k, seed)`` (the
    same draws in the same order).  The upper diagonals are uniform(-1, 1)
    and mirrored to the lower ones, the diagonal is the row's absolute sum
    + 1, and slots outside the matrix are zero."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n, 2 * k + 1))
    for d in range(1, k + 1):
        v = rng.uniform(-1.0, 1.0, size=n - d)
        data[:n - d, k + d] = v                  # A[i, i + d]
        data[d:, k - d] = v                      # A[i + d, i]
    data[:, k] = np.abs(data).sum(axis=1) + 1.0
    return data.astype(dtype)


def band_to_scipy(data, kl, ku):
    """Diagonal-offset storage -> scipy.linalg.solve_banded's ``ab``."""
    n = data.shape[0]
    ab = np.zeros((kl + ku + 1, n), data.dtype)
    for d in range(-kl, ku + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        ab[ku - d, rows + d] = data[rows, d + kl]
    return ab


def jax_factor_to_numpy(f):
    return tuple(np.asarray(a) for a in (f.F, f.U, f.Sinv))


def _np_or_none(a):
    return None if a is None else np.asarray(a)


def jax_factor_to_kwargs(f):
    """Keyword arguments of convert.blocktri_factor_from_numpy (a JAX
    BlockTriFactor, its 0-based pivots as JAX stores them) or of
    convert.cr_factor_from_numpy (a JAX CRFactor)."""
    if hasattr(f, "levels"):
        return dict(levels=[tuple(np.asarray(a) for a in
                                  (lv.Dinv_e, lv.P, lv.Q, lv.L_e, lv.U_e))
                            for lv in f.levels],
                    root_Dinv=np.asarray(f.root_Dinv), nb=f.nb,
                    n_pad=f.n_pad, nshift=_np_or_none(f.nshift))
    return dict(F=np.asarray(f.F), U=np.asarray(f.U),
                Sinv=np.asarray(f.Sinv), method=f.method,
                Slu=np.asarray(f.Slu), piv=np.asarray(f.piv),
                nshift=_np_or_none(f.nshift))


def jax_spike_to_numpy(sf):
    """Keyword arguments of convert.spike_factor_from_numpy for a JAX
    SpikeFactor (block-Thomas or CR factors)."""
    return dict(
        fact=jax_factor_to_kwargs(sf.fact), Btip=np.asarray(sf.Btip),
        Ctip=np.asarray(sf.Ctip),
        red_fact=(None if sf.red_fact is None
                  else jax_factor_to_kwargs(sf.red_fact)),
        V=_np_or_none(sf.V), W=_np_or_none(sf.W),
        n=sf.n, K=sf.K, m=sf.m, b=sf.b, k=sf.k, truncated=sf.truncated,
        red_Dinv=_np_or_none(sf.red_Dinv), Lb=_np_or_none(sf.Lb))


def t2n(t):
    """Tensor -> numpy (bfloat16 promoted to float32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def j2n(a):
    """JAX array -> numpy (bfloat16 promoted to float32)."""
    import jax.numpy as jnp
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.  Decided
    here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def tf32_round(t):
    """f32 -> the nearest TF32 value (10 explicit mantissa bits, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds: half a TF32 unit is added to
    the bit pattern's magnitude and the low 13 bits are cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """(hi, lo): hi the TF32 rounding of f32 ``t``, lo that of ``t - hi``."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def sweep_tf32(fact, rhs, passes):
    """The block-Thomas solve of ``rhs [K, nb, b, r]`` by an ``inv`` factor
    with every matrix-vector product done as the multi-RHS sweep kernel
    (``csrc/fused_sweep_many.cu``) does it on the tensor cores: the matrix
    M and the f32 vector v split into TF32 parts, and the first ``passes``
    of M_hi v_hi, M_hi v_lo, M_lo v_hi summed (the products exact, the sum
    rounded to f32).  The kernel takes 3 for f32 factors and 2 for bf16 ones
    (M_lo is 0: bf16 is exact in TF32).  The carry stays f32."""
    def mv(M, v):
        mh, ml = tf32_split(M)
        vh, vl = tf32_split(v)
        terms = ((mh, vh), (mh, vl), (ml, vh))[:passes]
        return sum(a.double() @ b.double() for a, b in terms).float()
    nb = fact.F.shape[-3]
    ys = [rhs[:, 0].float()]
    for i in range(1, nb):
        ys.append(rhs[:, i].float() - mv(fact.F[:, i], ys[-1]))
    xs = [mv(fact.Sinv[:, nb - 1], ys[-1])]
    for i in range(nb - 2, -1, -1):
        xs.append(mv(fact.Sinv[:, i], ys[i] - mv(fact.U[:, i], xs[-1])))
    return torch.stack(xs[::-1], dim=1)


# testbed parity: the JAX testbed under tests/conftest.py (x64 on, the CPU)
# against the port's on the same argv plus these flags (f64, the CPU)
TESTBED_PORT_FLAGS = ["-x64", "1", "-platform", "cpu"]
TESTBED_EXACT = ("Matrix:", "Reordered matrix using", "Reduced bandwidth",
                 "Increased bandwidth", "Norm of diagonal",
                 "Zeros on the permuted diagonal", "Bandwidth of",
                 "Device operator:", "Matrix is", "Converged reason")


def _parse_testbed(out):
    """(exact lines, monitored norms, true norms, error, (its, reason),
    rnorm).  The norms are those of the ``KSP Residual norm`` lines, or of
    the ``-ksp_monitor_true_residual`` lines (preconditioned and true)."""
    lines = out.splitlines()
    exact = [ln for ln in lines if ln.startswith(TESTBED_EXACT)]
    hist = [float(ln.split()[-1]) for ln in lines
            if "KSP Residual norm" in ln]
    true = []
    for ln in lines:
        if "KSP preconditioned resid norm" in ln:
            words = ln.split()
            hist.append(float(words[5]))
            true.append(float(words[9]))
    err = float(out.split("Error in solution:")[1].split()[0])
    ksp = out.split("KSP iterations:")[1].split()
    return exact, hist, true, err, (int(ksp[0]), ksp[2]), float(ksp[4])


def compare_testbeds(jmain, tmain, argv, capsys):
    """Run the JAX ``jmain`` and the port's ``tmain`` on ``argv`` (plus
    ``-ksp_converged_reason``; the port also gets TESTBED_PORT_FLAGS) and
    compare what they print: exactly, the exit code, the TESTBED_EXACT
    lines, the iteration count and the reason; to 1e-8 of the initial
    residual norm, the residual history (and the true one, under
    ``-ksp_monitor_true_residual``) and the final rnorm; to 1e-8 of
    ||u|| = sqrt(n), the error in the solution.  Returns (rc, port's
    stdout)."""
    argv = argv + ["-ksp_converged_reason"]
    rc_j = jmain(argv)
    out_j = capsys.readouterr().out
    rc_t = tmain(argv + TESTBED_PORT_FLAGS)
    out_t = capsys.readouterr().out
    assert rc_t == rc_j
    exact_j, hist_j, true_j, err_j, ksp_j, rn_j = _parse_testbed(out_j)
    exact_t, hist_t, true_t, err_t, ksp_t, rn_t = _parse_testbed(out_t)
    assert exact_t == exact_j
    assert ksp_t == ksp_j                       # iterations and reason
    assert len(hist_t) == len(hist_j)
    np.testing.assert_allclose(hist_t, hist_j, rtol=0,
                               atol=1e-8 * hist_j[0])
    assert len(true_t) == len(true_j)
    if true_j:
        np.testing.assert_allclose(true_t, true_j, rtol=0,
                                   atol=1e-8 * true_j[0])
    assert abs(rn_t - rn_j) <= 1e-8 * hist_j[0]
    n = int(exact_j[0].split("n=")[1].split(",")[0])
    assert abs(err_t - err_j) <= 1e-8 * np.sqrt(n)
    return rc_t, out_t

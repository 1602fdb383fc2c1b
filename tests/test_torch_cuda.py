"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held against JAX by the
other tests/test_torch_*.py files).  This file imports no JAX, so on a
machine with a card and without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: max|kernel - plain| <= 1e-5 max|plain| (f32 accumulation in
another order; bf16 factors are promoted to f32 by both); 1e-13 for the f64
band kernel (f64 accumulation in another order).
"""

import numpy as np
import pytest
import torch

from spike_petsc_tpu_torch import BandedMatrix, Options, solve
from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.models import pc_recipes
from spike_petsc_tpu_torch.ops.band import banded_matvec
from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                band_to_blocktri,
                                                blocktri_solve, cast_factor)
from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
from spike_petsc_tpu_torch.ops.cuda import band_matvec_f64 as cbm64
from spike_petsc_tpu_torch.ops.cuda import band_matvec_many as cbmm
from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec_grid as cgrid
from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many_spd as cfms
from spike_petsc_tpu_torch.ops.cuda import fused_sweep_spd as cfss
from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
from spike_petsc_tpu_torch.ops.spike import (spike_factor, spike_solve,
                                             spike_solve_many)

from torch_parity import (cuda_device, random_band, spd_band,  # noqa: F401
                          sweep_tf32)

TOL = 1e-5


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,kl,ku", [(100003, 150, 80), (4099, 20, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_matvec_kernel_matches_plain(cuda_device, n, kl, ku, dtype):
    band = banded_from_numpy(random_band(n, kl, ku, seed=8, dtype=np.float32,
                                         dominant=False), kl, ku,
                             device=cuda_device)
    prep = cbm.prepare_banded_mv(BandedMatrix(data=band.data.to(dtype),
                                              kl=kl, ku=ku))
    x = torch.randn(n, device=cuda_device)
    ref = cbm.banded_matvec_prepared(prep, x, impl="plain")
    launches = cbm.KERNEL.launches
    got = cbm.banded_matvec_prepared(prep, x)
    torch.cuda.synchronize()
    assert cbm.KERNEL.launches == launches + 1
    assert got.dtype == torch.float32 and _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,kl,ku,r,dtype", [
    (100003, 16, 16, 32, torch.float32),      # w = 33 (spd-cg-r32)
    (100003, 100, 100, 32, torch.float32),    # w = 201, chunks of 34
    (100003, 1, 1, 64, torch.float32),        # w = 3, two column tiles
    (100003, 100, 100, 32, torch.bfloat16),   # w = 201, chunks of 51
    (4099, 5, 20, 5, torch.float32),          # kl != ku, ragged r
    (4099, 6, 6, 33, torch.bfloat16),
    (4099, 6, 6, 1, torch.float32),
    (20000, 150, 60, 40, torch.float32),      # ragged chunks and columns
    (4099, 1000, 1200, 7, torch.float32)])    # w = 2201
def test_band_matvec_many_kernel_matches_plain_and_the_column_loop(
        cuda_device, n, kl, ku, r, dtype):
    """#11 within f32 rounding of its plain version, and each column equal
    to #2's result on it bit for bit (the same fmaf chain over d), in one
    launch."""
    band = banded_from_numpy(random_band(n, kl, ku, seed=8, dtype=np.float32,
                                         dominant=False), kl, ku,
                             device=cuda_device)
    prep = cbm.prepare_banded_mv(BandedMatrix(data=band.data.to(dtype),
                                              kl=kl, ku=ku))
    X = torch.randn((n, r), device=cuda_device)
    ref = cbmm.banded_matvec_many_prepared(prep, X, impl="plain")
    launches = cbmm.KERNEL.launches
    got = cbmm.banded_matvec_many_prepared(prep, X)
    torch.cuda.synchronize()
    assert cbmm.KERNEL.launches == launches + 1
    assert got.dtype == torch.float32 and _rel(got, ref) <= TOL
    cols = torch.stack([cbm.banded_matvec_prepared(prep, X[:, j].contiguous())
                        for j in range(r)], dim=1)
    assert torch.equal(got, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", ["ldx72_aligned", "ldx72_misaligned",
                                  "strided"])
def test_band_matvec_many_kernel_takes_column_views(cuda_device, cols):
    """X as a view of a wider block (rows 72 apart, aligned or not) takes
    the 4-byte copies, strided columns a contiguous copy; a contiguous
    ``[n, 32]`` X the window's bulk copy: the same answer each way."""
    n, k = 4099, 20
    band = banded_from_numpy(random_band(n, k, k, seed=8, dtype=np.float32),
                             k, k, device=cuda_device)
    prep = cbm.prepare_banded_mv(band)
    wide = torch.randn((n, 72), device=cuda_device)
    X = {"ldx72_aligned": wide[:, 4:36], "ldx72_misaligned": wide[:, 3:35],
         "strided": wide[:, ::2]}[cols]
    got = cbmm.banded_matvec_many_prepared(prep, X)
    torch.cuda.synchronize()
    assert torch.equal(got, cbmm.banded_matvec_many_prepared(
        prep, X.contiguous()))
    assert _rel(got, cbmm.banded_matvec_many_prepared(
        prep, X, impl="plain")) <= TOL


@pytest.mark.cuda
def test_band_matvec_many_kernel_refuses_what_it_does_not_take(cuda_device):
    band = BandedMatrix(data=torch.randn((4096, 41), device=cuda_device),
                        kl=20, ku=20)
    prep = cbm.prepare_banded_mv(band)
    with pytest.raises(ValueError, match="f32 X"):
        cbmm.banded_matvec_many_prepared(
            prep, torch.zeros((4096, 3), dtype=torch.float64,
                              device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        cbmm.banded_matvec_many_prepared(prep, torch.zeros(4096,
                                                           device=cuda_device))
    p16 = cbm.PreparedBandMV(d3=prep.d3.half(), kl=20, ku=20, n=4096)
    with pytest.raises(ValueError, match="layout"):
        cbmm.banded_matvec_many_prepared(p16, torch.zeros((4096, 3),
                                                          device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("ksp,kl", [("cg", 16), ("bcgs", 100)])
def test_band_many_route_launches_once_a_matmult(cuda_device, monkeypatch,
                                                 ksp, kl):
    """A batched solve on a CUDA band under 'auto': every operator apply
    is one launch of #11 and none of #2."""
    from spike_petsc_tpu_torch import make_solver_many
    from spike_petsc_tpu_torch.solvers import operator as top
    calls = [0]
    real = top.banded_matvec_many_prepared

    def counted(prep, X):
        calls[0] += 1
        return real(prep, X)
    monkeypatch.setattr(top, "banded_matvec_many_prepared", counted)
    n = 20000
    data = (spd_band(n, kl, seed=37, dtype=np.float32) if ksp == "cg" else
            random_band(n, kl, kl, seed=37, dtype=np.float32))
    band = banded_from_numpy(data, kl, kl, device=cuda_device)
    X = torch.randn((n, 32), device=cuda_device)
    B = banded_matvec(band, X)
    pc = ("cholesky", {"pc_cholesky_partitions": 8, "pc_cholesky_block": 64,
                       "pc_cholesky_truncated": 1}) if ksp == "cg" else \
        ("spike", {"pc_spike_partitions": 8, "pc_spike_block": 128})
    solver = make_solver_many(band, ksp_type=ksp, pc_type=pc[0],
                              options=Options(pc[1]), rtol=1e-6)
    before = (cbmm.KERNEL.launches, cbm.KERNEL.launches)
    res = solver(B)
    torch.cuda.synchronize()
    assert bool((res.reason > 0).all())
    assert float((res.x - X).abs().max()) < 1e-3
    assert calls[0] > 0
    assert cbmm.KERNEL.launches - before[0] == calls[0]
    assert cbm.KERNEL.launches == before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", [(128, 8, 8 * 128 * 9), (64, 16, 16 * 64),
                                   (128, 4, 4 * 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_kernel_matches_plain(cuda_device, b, K, n, dtype):
    """Real factors of a diagonally dominant band; nb = 9 and nb = 1."""
    band = banded_from_numpy(random_band(n, 20, 20, seed=9, dtype=np.float32),
                             20, 20, device=cuda_device)
    sf = spike_factor(band, K=K, block_b=b)
    fact = cast_factor(sf.fact, dtype)
    r = torch.randn((K, sf.nb, b), device=cuda_device)
    ref = cfs.blocktri_solve_fused_cuda(fact, r, impl="plain")
    launches = cfs.KERNEL.launches
    got = cfs.blocktri_solve_fused_cuda(fact, r)
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == launches + 1
    assert _rel(got, ref) <= TOL


# (K, nb, b): K in {1, 8, 16, 64, 512} and a ragged 37 at nb = 1, 2 and 49;
# nb = 123 (the flagship's) and the largest nb the rule admits (452 at
# b = 128, 906 at b = 64) at smaller K
_CLUSTER_SHAPES = (
    [(K, nb, b) for K in (1, 8, 16, 37, 64, 512) for nb in (1, 2, 49)
     for b in (64, 128)]
    + [(K, 123, b) for K in (1, 16, 64) for b in (64, 128)]
    + [(K, 452, 128) for K in (1, 8)] + [(K, 906, 64) for K in (1, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("K,nb,b", _CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_every_cluster_size(cuda_device, K, nb, b, dtype):
    """#1 at each cluster size the plan can pick (each partition's rows
    split over 1, 2 or 4 blocks) against its plain version, and the plan's
    own choice launched once."""
    from chip_smoke import random_inv_factor
    fact = random_inv_factor(K, nb, b, dtype, cuda_device, seed=K * nb + b)
    r = torch.randn((K, nb, b), device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(nb))
    assert cfs.fused_sweep_feasible(fact, b)
    ref = cfs.blocktri_solve_fused_cuda(fact, r, impl="plain")
    for c in cfs.CLUSTER_SIZES:
        got = cfs.blocktri_solve_fused_cuda(fact, r, cluster=c)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= TOL, c
    launches = cfs.KERNEL.launches
    got = cfs.blocktri_solve_fused_cuda(fact, r)
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == launches + 1
    assert _rel(got, ref) <= TOL
    with pytest.raises(ValueError, match="cluster=8"):
        cfs.blocktri_solve_fused_cuda(fact, r, cluster=8)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    band = banded_from_numpy(random_band(4096, 20, 20, seed=10), 20, 20,
                             device=cuda_device)                  # f64
    sf = spike_factor(band, K=4, block_b=64)
    r = torch.randn((4, sf.nb, 64), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        cfs.blocktri_solve_fused_cuda(sf.fact, r, impl="cuda")
    # 'auto' takes the plain sweep only because the rule excludes f64
    x = spike_solve(sf, torch.randn(4096, dtype=torch.float64,
                                    device=cuda_device))
    assert x.dtype == torch.float64


@pytest.mark.cuda
def test_main_path_runs_both_kernels(cuda_device):
    band = banded_from_numpy(random_band(20000, 20, 20, seed=11,
                                         dtype=np.float32), 20, 20,
                             device=cuda_device)
    b = torch.randn(20000, device=cuda_device)
    before = cbm.KERNEL.launches, cfs.KERNEL.launches
    res = solve(band, b, ksp_type="gmres", pc_type="spike", rtol=1e-6,
                options=Options({"pc_spike_partitions": 8,
                                 "pc_spike_block": 64,
                                 "pc_spike_store_spikes": 1}))
    torch.cuda.synchronize()
    assert res.reason == 2 and res.its <= 3
    assert cbm.KERNEL.launches > before[0] and cfs.KERNEL.launches > before[1]


def _factor(b, K, n, seed):
    band = banded_from_numpy(random_band(n, 20, 20, seed=seed,
                                         dtype=np.float32), 20, 20,
                             device=torch.device("cuda", 0))
    return spike_factor(band, K=K, block_b=b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", [(128, 8, 8 * 128 * 9), (64, 16, 16 * 64),
                                   (128, 4, 4 * 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 32, 100])
def test_fused_sweep_many_kernel_matches_plain(cuda_device, b, K, n, dtype,
                                               r):
    """Real factors of a diagonally dominant band; nb = 9 and nb = 1; one
    column, one chunk and several chunks of columns."""
    sf = _factor(b, K, n, seed=12)
    fact = cast_factor(sf.fact, dtype)
    rhs = torch.randn((K, sf.nb, b, r), device=cuda_device)
    ref = cfm.blocktri_solve_fused_many_cuda(fact, rhs, impl="plain")
    launches = cfm.KERNEL.launches
    got = cfm.blocktri_solve_fused_many_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert cfm.KERNEL.launches == launches + 1
    assert got.shape == rhs.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("r", [15, 17, 37])
def test_fused_sweep_many_column_chunks_agree(cuda_device, r):
    """A last column chunk of the 16-column blocks that is partly empty."""
    sf = _factor(128, 8, 8 * 128 * 5, seed=13)
    rhs = torch.randn((8, sf.nb, 128, r), device=cuda_device)
    ref = cfm.blocktri_solve_fused_many_cuda(sf.fact, rhs, impl="plain")
    got = cfm.blocktri_solve_fused_many_cuda(sf.fact, rhs)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n,r,offset", [
    (128, 8, 8 * 128 * 5, 17, 0), (128, 8, 8 * 128 * 5, 37, 0),
    (128, 8, 8 * 128 * 5, 100, 0), (128, 8, 8 * 128 * 5, 1, 0),
    (128, 4, 4 * 128, 32, 0), (128, 1, 128 * 9, 32, 0),
    (64, 16, 16 * 64 * 3, 32, 0), (64, 1, 64, 17, 0),
    (128, 8, 8 * 128 * 5, 32, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_many_cluster_edges(cuda_device, b, K, n, r, offset,
                                        dtype):
    """Shapes where the kernel's clusters of two 16-column blocks have
    edges: an odd number of 16-column chunks (r = 37, 100) and r = 17 and
    r = 1 (the wrapper pads to a multiple of 32 and slices), nb = 1 (no
    forward step), K = 1 (one partition), b = 64 (one at K = 1, nb = 1),
    and a right-hand side whose data_ptr is not 16-byte aligned (the
    wrapper copies it)."""
    sf = _factor(b, K, n, seed=26)
    fact = cast_factor(sf.fact, dtype)
    buf = torch.randn(K * sf.nb * b * r + offset, device=cuda_device)
    rhs = buf[offset:].view(K, sf.nb, b, r)
    assert (rhs.data_ptr() % 16 != 0) == bool(offset)
    ref = cfm.blocktri_solve_fused_many_cuda(fact, rhs, impl="plain")
    launches = cfm.KERNEL.launches
    got = cfm.blocktri_solve_fused_many_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert cfm.KERNEL.launches == launches + 1
    assert got.shape == rhs.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,dtype,passes", [(64, torch.float32, 3),
                                            (128, torch.float32, 3),
                                            (128, torch.bfloat16, 2)])
def test_fused_sweep_many_needs_the_lo_terms(cuda_device, b, dtype, passes):
    """F scaled by 16 (F ~ 1): the kernel's TF32 products keep f32
    accuracy only with their lo terms.  One TF32 pass would miss 1e-5 here
    (asserted on the emulated sweep of tests/torch_parity.py, which
    tests/test_torch_tf32_split.py holds against the f64 solve on the CPU);
    the kernel, 3xTF32 on f32 factors and 2xTF32 on bf16 ones, must not."""
    sf = _factor(b, 4, 4 * 4 * b, seed=31)
    fact = cast_factor(sf.fact, dtype)
    fact = type(fact)(F=fact.F * 16, U=fact.U, Sinv=fact.Sinv,
                      method=fact.method)
    rhs = torch.randn((4, sf.nb, b, 32), device=cuda_device)
    ref = cfm.blocktri_solve_fused_many_cuda(fact, rhs, impl="plain")
    assert _rel(sweep_tf32(fact, rhs, 1), ref) > TOL
    assert _rel(sweep_tf32(fact, rhs, passes), ref) <= TOL
    got = cfm.blocktri_solve_fused_many_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(100003, 100), (4099, 20), (1024, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocktri_matvec_kernel_matches_plain(cuda_device, n, k, dtype):
    """Ragged n (the last block row partly outside x) and full block rows;
    held against the plain version and against the banded matvec."""
    band = banded_from_numpy(random_band(n, k, k, seed=14, dtype=np.float32,
                                         dominant=False), k, k,
                             device=cuda_device)
    band = BandedMatrix(data=band.data.to(dtype), kl=k, ku=k)
    T = band_to_blocktri(band, 128)
    x = torch.randn(n, device=cuda_device)
    ref = cbt.blocktri_matvec_cuda(T, x, impl="plain")
    launches = cbt.KERNEL.launches
    got = cbt.blocktri_matvec_cuda(T, x)
    torch.cuda.synchronize()
    assert cbt.KERNEL.launches == launches + 1
    assert got.shape == (n,) and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL
    band_ref = banded_matvec(BandedMatrix(data=band.data.float(), kl=k,
                                          ku=k), x)
    assert _rel(got, band_ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ppd,nb,b", [(2, 5, 64), (64, 123, 128)])
def test_blocktri_matvec_chunked_entry_matches_plain(cuda_device, ppd, nb, b):
    """#7 through the chunked entry of the distributed blocks route: a
    rank's [ppd, nb, b, b] SPIKE partition blocks (L[:, 0] and U[:, -1]
    zero) read in place as one block sequence, against the plain version
    and against each partition's own product."""
    from spike_petsc_tpu_torch.ops.spike import _partition_blocks
    k = b // 2
    n = ppd * nb * b
    band = banded_from_numpy(random_band(n, k, k, seed=16, dtype=np.float32),
                             k, k, device=cuda_device)
    T = _partition_blocks(band, ppd, nb * b, b)
    x = torch.randn((ppd, nb, b), device=cuda_device)
    ref = cbt.blocktri_matvec_chunked_cuda(T, x, impl="plain")
    launches = cbt.KERNEL.launches
    got = cbt.blocktri_matvec_chunked_cuda(T, x)
    torch.cuda.synchronize()
    assert cbt.KERNEL.launches == launches + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL
    own = torch.stack([cbt.blocktri_matvec_plain(
        BlockTridiagonal(D=T.D[p], L=T.L[p], U=T.U[p]), x[p].reshape(-1))
        for p in range(ppd)]).reshape(x.shape)
    assert _rel(got, own) <= TOL
    with pytest.raises(ValueError, match="in place"):
        cbt.blocktri_matvec_chunked_cuda(BlockTridiagonal(
            D=T.D.transpose(-1, -2), L=T.L, U=T.U), x)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
    sf = spike_factor(banded_from_numpy(random_band(4096, 20, 20, seed=15),
                                        20, 20, device=cuda_device),
                      K=4, block_b=64)                               # f64
    rhs = torch.randn((4, sf.nb, 64, 3), dtype=torch.float64,
                      device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        cfm.blocktri_solve_fused_many_cuda(sf.fact, rhs)
    f32 = cast_factor(sf.fact, torch.float32)
    with pytest.raises(ValueError, match="rhs shape"):
        cfm.blocktri_solve_fused_many_cuda(f32, rhs[..., :0].float())
    T = BlockTridiagonal(*(torch.zeros((3, 64, 64), dtype=torch.float64,
                                       device=cuda_device),) * 3)
    with pytest.raises(ValueError, match="does not take"):
        cbt.blocktri_matvec_cuda(T, torch.zeros(192, dtype=torch.float64,
                                                device=cuda_device))
    T32 = BlockTridiagonal(*(m.float() for m in (T.D, T.L, T.U)))
    with pytest.raises(ValueError, match="length"):
        cbt.blocktri_matvec_cuda(T32, torch.zeros(100, device=cuda_device))


@pytest.mark.cuda
def test_serving_path_runs_the_multi_rhs_sweep(cuda_device):
    """solve_many on a wide band: the multi-RHS band kernel (#11) under
    'auto' (``blocktri_many`` only under ``impl="blocktri"``) and the spike
    PC's multi-RHS apply (kernel #4), every column converged."""
    from spike_petsc_tpu_torch import solve_many
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    band = banded_from_numpy(random_band(20000, 50, 50, seed=16,
                                         dtype=np.float32), 50, 50,
                             device=cuda_device)
    X = torch.randn((20000, 6), device=cuda_device)
    B = banded_matvec(band, X)
    assert as_matvec_many(band)[0]._route == "banded_cuda_many"
    assert as_matvec_many(band, impl="blocktri")[0]._route == "blocktri_many"
    before = cfm.KERNEL.launches
    res = solve_many(band, B, ksp_type="bcgs", pc_type="spike", rtol=1e-6,
                     options=Options({"pc_spike_partitions": 8,
                                      "pc_spike_block": 64,
                                      "pc_spike_store_spikes": 1}))
    torch.cuda.synchronize()
    assert (res.reason == 2).all() and res.its.max() <= 2
    assert cfm.KERNEL.launches > before
    assert float((res.x - X).abs().max()) < 1e-3


@pytest.mark.cuda
def test_blocktri_route_runs_the_blocktri_kernel(cuda_device):
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    band = banded_from_numpy(random_band(5000, 40, 40, seed=17,
                                         dtype=np.float32), 40, 40,
                             device=cuda_device)
    mv, _, _ = as_matvec(band, impl="blocktri")
    assert mv._route == "blocktri"
    x = torch.randn(5000, device=cuda_device)
    before = cbt.KERNEL.launches
    y = mv(x)
    torch.cuda.synchronize()
    assert cbt.KERNEL.launches == before + 1
    assert _rel(y, banded_matvec(band, x)) <= TOL
    # the same blocks handed in as a BlockTridiagonal take the same kernel
    T = band_to_blocktri(band, 128)
    mvT, nT, _ = as_matvec(T)
    assert (mvT._route, nT) == ("blocktri", T.nb * 128)
    yT = mvT(torch.nn.functional.pad(x, (0, nT - 5000)))
    torch.cuda.synchronize()
    assert cbt.KERNEL.launches == before + 2
    assert _rel(yT[:5000], y) <= TOL
    T64 = BlockTridiagonal(*(m.double() for m in (T.D, T.L, T.U)))
    assert as_matvec(T64)[0]._route == "xla"


@pytest.mark.cuda
@pytest.mark.parametrize("kl,dtype", [(40, torch.float64),
                                      (129, torch.float32),
                                      (40, torch.float16)])
def test_blocktri_route_refuses_on_the_card(cuda_device, kl, dtype):
    """``impl="blocktri"`` on a CUDA band the gate (f64, kl > 128) or the
    kernel (f16) refuses raises; 'auto' takes the band kernel of the
    band's dtype where one admits it (#2 for f32, #6 for f64), else the
    plain version."""
    from spike_petsc_tpu_torch.solvers.operator import (as_matvec,
                                                        as_matvec_many)
    band = BandedMatrix(data=torch.randn((5000, kl + 41), device=cuda_device)
                        .to(dtype), kl=kl, ku=40)
    with pytest.raises(ValueError, match="blocktri does not take"):
        as_matvec(band, impl="blocktri")
    if dtype != torch.float16:
        with pytest.raises(ValueError, match="blocktri does not take"):
            as_matvec_many(band, impl="blocktri")
    assert as_matvec(band)[0]._route == {
        torch.float32: "banded_cuda", torch.float64: "banded_cuda_f64",
        torch.float16: "xla"}[dtype]


def _spd_factor(b, K, n, seed, k=16):
    band = banded_from_numpy(spd_band(n, k, seed=seed, dtype=np.float32),
                             k, k, device=torch.device("cuda", 0))
    return spike_factor(band, K=K, block_b=b, method="spd")


SPD_SHAPES = [(64, 16, 16 * 64 * 40), (128, 4, 4 * 128 * 9), (64, 16, 16 * 64),
              (128, 2, 2 * 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", SPD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_spd_kernel_matches_plain(cuda_device, b, K, n, dtype):
    """Real spd factors of a symmetric dominant band (kl = ku = 16); nb =
    40, 9 and 1; f32 and bf16 factors."""
    sf = _spd_factor(b, K, n, seed=18)
    fact = cast_factor(sf.fact, dtype)
    r = torch.randn((K, sf.nb, b), device=cuda_device)
    ref = cfss.blocktri_solve_fused_spd_cuda(fact, r, impl="plain")
    launches = cfss.KERNEL.launches
    got = cfss.blocktri_solve_fused_spd_cuda(fact, r)
    torch.cuda.synchronize()
    assert cfss.KERNEL.launches == launches + 1
    assert got.shape == r.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n,offset", [
    (64, 1, 64 * 40, 0), (128, 1, 128 * 9, 0), (128, 2, 2 * 128 * 2, 0),
    (64, 4, 4 * 64, 0), (64, 16, 16 * 64 * 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_spd_cluster_edges(cuda_device, b, K, n, offset, dtype):
    """Shapes where the split of a partition over a thread block cluster has
    edges: one partition (K = 1: the cluster is the whole grid) at b = 64
    and 128, b = 128 at nb = 2 (one forward and one backward step), nb = 1
    (no forward step), and a right-hand side whose data_ptr is not 16-byte
    aligned (the kernel copies 16-byte pieces; the wrapper copies it)."""
    sf = _spd_factor(b, K, n, seed=25)
    fact = cast_factor(sf.fact, dtype)
    buf = torch.randn(K * sf.nb * b + offset, device=cuda_device)
    r = buf[offset:].view(K, sf.nb, b)
    assert (r.data_ptr() % 16 != 0) == bool(offset)
    ref = cfss.blocktri_solve_fused_spd_cuda(fact, r, impl="plain")
    launches = cfss.KERNEL.launches
    got = cfss.blocktri_solve_fused_spd_cuda(fact, r)
    torch.cuda.synchronize()
    assert cfss.KERNEL.launches == launches + 1
    assert got.shape == r.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", SPD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 17, 32, 100])
def test_fused_sweep_many_spd_kernel_matches_plain(cuda_device, b, K, n,
                                                   dtype, r):
    sf = _spd_factor(b, K, n, seed=19)
    fact = cast_factor(sf.fact, dtype)
    rhs = torch.randn((K, sf.nb, b, r), device=cuda_device)
    ref = cfms.blocktri_solve_fused_many_spd_cuda(fact, rhs, impl="plain")
    launches = cfms.KERNEL.launches
    got = cfms.blocktri_solve_fused_many_spd_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert cfms.KERNEL.launches == launches + 1
    assert got.shape == rhs.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", [(64, 1, 64 * 40), (128, 1, 128 * 9),
                                   (128, 2, 2 * 128 * 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [16, 33])
def test_fused_sweep_many_spd_cluster_edges(cuda_device, b, K, n, dtype, r):
    """Shapes where the split of a partition over a thread block cluster has
    edges: one partition (K = 1: one cluster per column chunk), a full and a
    ragged last column chunk (r = 16, 33), b = 128 at nb = 2 (one forward
    and one backward step)."""
    sf = _spd_factor(b, K, n, seed=24)
    fact = cast_factor(sf.fact, dtype)
    rhs = torch.randn((K, sf.nb, b, r), device=cuda_device)
    ref = cfms.blocktri_solve_fused_many_spd_cuda(fact, rhs, impl="plain")
    launches = cfms.KERNEL.launches
    got = cfms.blocktri_solve_fused_many_spd_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert cfms.KERNEL.launches == launches + 1
    assert got.shape == rhs.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
def test_spd_kernels_refuse_what_they_do_not_take(cuda_device):
    band = banded_from_numpy(spd_band(4096, 16, seed=20), 16, 16,
                             device=cuda_device)                     # f64
    sf = spike_factor(band, K=4, block_b=64, method="spd")
    r = torch.randn((4, sf.nb, 64), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        cfss.blocktri_solve_fused_spd_cuda(sf.fact, r)
    with pytest.raises(ValueError, match="does not take"):
        cfms.blocktri_solve_fused_many_spd_cuda(sf.fact, r[..., None])
    inv = spike_factor(band, K=4, block_b=64)           # an inv factor
    with pytest.raises(ValueError, match="does not take"):
        cfss.blocktri_solve_fused_spd_cuda(cast_factor(inv.fact,
                                                       torch.float32),
                                           r.float())
    # 'auto' on the card raises where the rule refuses the spd factors
    # (f64 here, b = 16 below); only impl='plain' runs the plain sweep
    x64 = torch.randn(4096, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="fused_sweep_spd_feasible"):
        spike_solve(sf, x64)
    with pytest.raises(ValueError, match="fused_sweep_spd_feasible"):
        spike_solve_many(sf, x64[:, None])
    assert spike_solve(sf, x64, impl="plain").dtype == torch.float64
    f32 = BandedMatrix(data=band.data.float(), kl=16, ku=16)
    small = spike_factor(f32, K=4, block_b=16, method="spd")
    with pytest.raises(ValueError, match="block sizes 64 or 128"):
        spike_solve(small, x64.float())
    with pytest.raises(ValueError, match="block sizes 64 or 128"):
        solve(f32, x64.float(), ksp_type="cg", pc_type="cholesky",
              options=Options({"pc_cholesky_block": 16}))


@pytest.mark.cuda
def test_spd_path_runs_the_spd_kernels(cuda_device):
    """cg + cholesky (truncated, stored spikes) one column and many: the
    operator's band kernel and both spd sweeps run, and the answers hold."""
    from spike_petsc_tpu_torch import solve_many
    n, k = 20000, 16
    band = banded_from_numpy(spd_band(n, k, seed=21, dtype=np.float32), k, k,
                             device=cuda_device)
    opts = Options({"pc_cholesky_partitions": 8, "pc_cholesky_block": 64,
                    "pc_cholesky_truncated": 1,
                    "pc_cholesky_store_spikes": 1})
    before = (cbm.KERNEL.launches, cfss.KERNEL.launches,
              cfms.KERNEL.launches)
    b = banded_matvec(band, torch.ones(n, device=cuda_device))
    res = solve(band, b, ksp_type="cg", pc_type="cholesky", options=opts,
                rtol=1e-8)
    X = torch.randn((n, 5), device=cuda_device)
    many = solve_many(band, banded_matvec(band, X), ksp_type="cg",
                      pc_type="cholesky", options=opts, rtol=1e-8)
    torch.cuda.synchronize()
    assert res.reason == 2 and res.its <= 5
    assert float((res.x - 1).abs().max()) < 1e-4
    assert (many.reason == 2).all() and float((many.x - X).abs().max()) < 1e-4
    assert cbm.KERNEL.launches > before[0]
    assert cfss.KERNEL.launches > before[1]
    assert cfms.KERNEL.launches > before[2]


@pytest.mark.cuda
def test_cholesky_default_options_run_the_spd_kernel(cuda_device):
    """cg + cholesky with no options (K = 1, block unset) on a CUDA band:
    the PC picks the kernel's block size 64 for k = 16, and every apply
    runs the spd sweep kernel."""
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    n, k = 20000, 16
    band = banded_from_numpy(spd_band(n, k, seed=22, dtype=np.float32), k, k,
                             device=cuda_device)
    assert make_pc("cholesky", band).info["block"] == 64
    before = cfss.KERNEL.launches
    res = solve(band, banded_matvec(band, torch.ones(n, device=cuda_device)),
                ksp_type="cg", pc_type="cholesky", rtol=1e-6)
    torch.cuda.synchronize()
    assert res.reason == 2 and res.its <= 3
    assert float((res.x - 1).abs().max()) < 1e-4
    assert cfss.KERNEL.launches >= before + res.its + 1


@pytest.mark.cuda
def test_conversions_default_to_the_card(cuda_device):
    band = banded_from_numpy(random_band(300, 2, 2, seed=23), 2, 2)
    assert band.data.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("n,kl,ku", [(100003, 150, 80), (4099, 20, 20),
                                     (1000, 255, 255), (1000, 100, 100)])
def test_band_matvec_f64_kernel_matches_plain(cuda_device, n, kl, ku):
    """Ragged n and widths below and above the flagship's; against the
    plain f64 version and the plain banded matvec of the band."""
    data = random_band(n, kl, ku, seed=24, dominant=False) * (1 + 1e-9)
    band = banded_from_numpy(data, kl, ku, device=cuda_device)
    prep = cbm64.prepare_banded_mv_f64(band)
    x = torch.randn(n, dtype=torch.float64, device=cuda_device)
    ref = cbm64.banded_matvec_prepared_f64(prep, x, impl="plain")
    launches = cbm64.KERNEL.launches
    got = cbm64.banded_matvec_prepared_f64(prep, x)
    torch.cuda.synchronize()
    assert cbm64.KERNEL.launches == launches + 1
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert _rel(got, ref) <= 1e-13
    assert _rel(got, banded_matvec(band, x)) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,n", [(128, 8, 8 * 128 * 9), (64, 16, 16 * 64),
                                   (128, 4, 4 * 128), (64, 4, 4 * 64 * 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweeps_kernels_match_plain(cuda_device, b, K, n, dtype):
    """Real factors of a diagonally dominant band; nb = 9, 1 and 40; two
    launches a solve."""
    sf = _factor(b, K, n, seed=25)
    fact = cast_factor(sf.fact, dtype)
    r = torch.randn((K, sf.nb, b), device=cuda_device)
    ref = csw.blocktri_solve_batched_cuda(fact, r, impl="plain")
    launches = csw.KERNEL.launches
    got = csw.blocktri_solve_batched_cuda(fact, r)
    torch.cuda.synchronize()
    assert csw.KERNEL.launches == launches + 2
    assert got.shape == r.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL
    fused = cfs.blocktri_solve_fused_cuda(fact, r)
    torch.cuda.synchronize()
    assert _rel(got, fused) <= TOL


def _laplacian_factor(n, device):
    """BASELINE config 1's factor on the card: the tridiagonal Laplacian,
    one partition, block 64 (the lu PC's)."""
    band = banded_from_numpy(np.tile(np.float32([-1, 2, -1]), (n, 1)), 1, 1,
                             device=device)
    return spike_factor(band, K=1, block_b=64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["config1", "K1_nb301_b128", "K2_nb400",
                                   "K4_nb400", "flagship"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweeps_chunked_scan_matches_plain(cuda_device, shape, dtype):
    """#9 at the shapes chip_smoke.py holds it at: its plan chunks config
    1's one partition of 1563 block rows, K = 1 at b = 128 with nb = 301
    (ragged chunks), K = 2 and 4 at nb = 400 (C > 1); the flagship's
    K = 64, nb = 123 keeps one block a partition (C = 1).  Two launches a
    solve, against the plain sweep."""
    if shape == "config1":
        fact = _laplacian_factor(100_000, cuda_device).fact
    else:
        K, nb, b = {"K1_nb301_b128": (1, 301, 128), "K2_nb400": (2, 400, 64),
                    "K4_nb400": (4, 400, 64),
                    "flagship": (64, 123, 128)}[shape]
        fact = _factor(b, K, K * nb * b, seed=29).fact
    fact = cast_factor(fact, dtype)
    K, nb, b, _ = fact.F.shape
    sms = csw.device_sms(cuda_device)
    C = csw.sweeps_chunks(K, nb, b, sms)
    assert (C == 1) == (shape == "flagship") and K * C <= max(sms, K)
    if shape == "K1_nb301_b128":
        assert nb % C
    r = torch.randn((K, nb, b), device=cuda_device)
    ref = blocktri_solve(fact, r)
    launches = csw.KERNEL.launches
    got = csw.blocktri_solve_batched_cuda(fact, r)
    torch.cuda.synchronize()
    assert csw.KERNEL.launches == launches + 2
    assert got.shape == r.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,K,nb,chunks", [
    (64, 1, 8, 8), (64, 2, 9, 2), (64, 3, 10, 3), (128, 1, 7, 7),
    (128, 2, 13, 5), (64, 1, 40, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweeps_chunked_scan_edges(cuda_device, b, K, nb, chunks, dtype):
    """Chunks of one block row (nb = C: phase 1 is each chunk's first step
    only), C = 2 (no chained step), C = 3 (one), ragged chunks; against the
    plain sweep and the plain model of the split."""
    fact = cast_factor(_factor(b, K, K * nb * b, seed=30 + nb).fact, dtype)
    r = torch.randn((K, nb, b), device=cuda_device)
    got = csw.blocktri_solve_batched_cuda(fact, r, chunks=chunks)
    torch.cuda.synchronize()
    assert _rel(got, blocktri_solve(fact, r)) <= TOL
    assert _rel(got, csw.blocktri_solve_chunked_model(fact, r, chunks)) <= TOL


@pytest.mark.cuda
def test_sweeps_chunks_out_of_range_raise(cuda_device):
    fact = _factor(64, 2, 2 * 64 * 6, seed=31).fact
    r = torch.randn((2, 6, 64), device=cuda_device)
    sms = csw.device_sms(cuda_device)
    for chunks in (0, 7, sms):                  # C > nb; K C > the SMs
        with pytest.raises(ValueError, match="chunked scan takes"):
            csw.blocktri_solve_batched_cuda(fact, r, chunks=chunks)


@pytest.mark.cuda
def test_spike_solve_pallas_runs_the_two_pass_sweeps(cuda_device):
    """``spike_solve(impl="pallas")`` launches #9 twice (stored spikes: one
    partition solve) and agrees with the fused kernel's solve;
    ``spike_solve_many(impl="pallas")`` runs the multi-RHS kernel."""
    band = banded_from_numpy(random_band(20000, 20, 20, seed=26,
                                         dtype=np.float32), 20, 20,
                             device=cuda_device)
    sf = spike_factor(band, K=8, block_b=64, store_spikes=True)
    rhs = torch.randn(20000, device=cuda_device)
    before = csw.KERNEL.launches, cfs.KERNEL.launches
    got = spike_solve(sf, rhs, impl="pallas")
    torch.cuda.synchronize()
    assert csw.KERNEL.launches == before[0] + 2
    assert cfs.KERNEL.launches == before[1]
    ref = spike_solve(sf, rhs, impl="pallas_fused")
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == before[1] + 1
    assert _rel(got, ref) <= TOL
    assert _rel(banded_matvec(band, got), rhs) <= 1e-4
    before = cfm.KERNEL.launches
    many = spike_solve_many(sf, rhs[:, None], impl="pallas")
    torch.cuda.synchronize()
    assert cfm.KERNEL.launches == before + 1
    assert _rel(many[:, 0], ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("nb,b,kt", [(11, 128, 4), (9, 128, 8), (3, 64, 8),
                                     (781, 128, 8), (100, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_matvec_kernel_matches_plain(cuda_device, nb, b, kt, dtype):
    """Short last chunks (nb % kt != 0), one chunk, full chunks; against
    the plain version and the one-block-per-row kernel #7."""
    n = nb * b
    band = banded_from_numpy(random_band(n, b - 7, b - 20, seed=27,
                                         dtype=np.float32, dominant=False),
                             b - 7, b - 20, device=cuda_device)
    T = band_to_blocktri(BandedMatrix(data=band.data.to(dtype), kl=b - 7,
                                      ku=b - 20), b)
    x = torch.randn((nb, b), device=cuda_device)
    ref = cgrid.blocktri_matvec_pallas(T, x, kt=kt, impl="plain")
    launches = cgrid.KERNEL.launches
    got = cgrid.blocktri_matvec_pallas(T, x, kt=kt)
    torch.cuda.synchronize()
    assert cgrid.KERNEL.launches == launches + 1
    assert got.shape == (nb, b) and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL
    assert _rel(got.reshape(-1), cbt.blocktri_matvec_cuda(T, x.reshape(-1))) \
        <= TOL


@pytest.mark.cuda
def test_alternate_kernels_refuse_what_they_do_not_take(cuda_device):
    sf = spike_factor(banded_from_numpy(random_band(4096, 20, 20, seed=28),
                                        20, 20, device=cuda_device),
                      K=4, block_b=64)                               # f64
    r64 = torch.randn((4, sf.nb, 64), dtype=torch.float64,
                      device=cuda_device)
    with pytest.raises(ValueError, match="sweeps_feasible"):
        csw.blocktri_solve_batched_cuda(sf.fact, r64)
    with pytest.raises(ValueError, match="sweeps_feasible"):
        spike_solve(sf, torch.randn(4096, dtype=torch.float64,
                                    device=cuda_device), impl="pallas")
    f32 = cast_factor(sf.fact, torch.float32)
    with pytest.raises(ValueError, match="rhs shape"):
        csw.blocktri_solve_batched_cuda(f32, r64[:, :1].float())
    T = BlockTridiagonal(*(torch.zeros((3, 64, 64), dtype=torch.float64,
                                       device=cuda_device),) * 3)
    with pytest.raises(ValueError, match="does not take"):
        cgrid.blocktri_matvec_pallas(T, torch.zeros((3, 64),
                                                    device=cuda_device))
    T32 = BlockTridiagonal(*(m.float() for m in (T.D, T.L, T.U)))
    with pytest.raises(ValueError, match="does not take"):
        cgrid.blocktri_matvec_pallas(T32, torch.zeros((3, 64),
                                                      device=cuda_device),
                                     kt=33)
    with pytest.raises(ValueError, match="x f32"):
        cgrid.blocktri_matvec_pallas(T32, torch.zeros((2, 64),
                                                      device=cuda_device))
    band32 = BandedMatrix(data=torch.randn((500, 5), device=cuda_device),
                          kl=2, ku=2)
    prep32 = cbm.prepare_banded_mv(band32)
    with pytest.raises(ValueError, match="contiguous f64"):
        cbm64.banded_matvec_prepared_f64(
            prep32, torch.zeros(500, dtype=torch.float64,
                                device=cuda_device))


@pytest.mark.cuda
def test_long_single_partition_takes_the_two_pass_sweeps(cuda_device):
    """BASELINE config 1's shape: the lu PC on the tridiagonal Laplacian at
    n = 1e5 (k = 1) gets block 64 on the card, one partition of nb = 1563
    block rows, which #1's shared-memory rule refuses; #9 at K = 1 takes
    its chunked scan there (C > 1), agrees with its plain version, and
    'auto' (spike_solve, the PC's apply) runs it, two launches a solve, and
    never #1."""
    from spike_petsc_tpu_torch.ops.cuda.fused_sweep import (
        fused_sweep_feasible)
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    n = 100_000
    band = banded_from_numpy(np.tile(np.float32([-1, 2, -1]), (n, 1)), 1, 1,
                             device=cuda_device)
    sf = spike_factor(band, K=1, block_b=64)
    assert (sf.K, sf.nb, sf.b) == (1, 1563, 64)
    assert not fused_sweep_feasible(sf.fact, 64)
    assert csw.sweeps_feasible(sf.fact, 64)
    assert csw.sweeps_chunks(1, 1563, 64, csw.device_sms(cuda_device)) > 1
    r = torch.randn((1, sf.nb, 64), device=cuda_device)
    ref = csw.blocktri_solve_batched_cuda(sf.fact, r, impl="plain")
    got = csw.blocktri_solve_batched_cuda(sf.fact, r)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL
    pc = make_pc("lu", band, Options())
    assert pc.info["block"] == 64
    rhs = torch.randn(n, device=cuda_device)
    before = csw.KERNEL.launches, cfs.KERNEL.launches
    x = spike_solve(sf, rhs)
    y = pc.apply(rhs)
    torch.cuda.synchronize()
    assert csw.KERNEL.launches == before[0] + 4
    assert cfs.KERNEL.launches == before[1]
    assert _rel(x, spike_solve(sf, rhs, impl="plain")) <= TOL
    assert _rel(y, x) <= TOL


@pytest.mark.cuda
def test_refinement_runs_the_f64_kernel(cuda_device):
    """richardson + spike with f32 factors on an f64 CUDA band: 'auto' is
    the f64 band kernel, which runs on every residual, and the fused sweep
    on every PC apply; the answer is f64-grade."""
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    n, k = 20000, 20
    band = banded_from_numpy(random_band(n, k, k, seed=29), k, k,
                             device=cuda_device)
    assert as_matvec(band)[0]._route == "banded_cuda_f64"
    b = banded_matvec(band, torch.ones(n, dtype=torch.float64,
                                       device=cuda_device))
    before = cbm64.KERNEL.launches, cfs.KERNEL.launches
    res = solve(band, b, ksp_type="richardson", pc_type="spike", rtol=1e-12,
                maxit=20, options=Options({"pc_spike_partitions": 8,
                                           "pc_spike_block": 64,
                                           "pc_spike_store_spikes": 1,
                                           "pc_spike_factor_dtype": "f32"}))
    torch.cuda.synchronize()
    assert res.reason == 2 and res.its <= 4 and res.x.dtype == torch.float64
    assert cbm64.KERNEL.launches == before[0] + res.its + 1
    assert cfs.KERNEL.launches == before[1] + res.its
    relres = float(torch.linalg.norm(banded_matvec(band, res.x) - b)
                   / torch.linalg.norm(b))
    assert relres <= 1e-12 and float((res.x - 1).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# The testbed pipeline's PCs and operators on the card
# ---------------------------------------------------------------------------

def _illscaled_pipeline(n=20000):
    """The config-3 host pipeline at a small size: wbm with scaling, rcm,
    the 0.9999 band (k = 6)."""
    from spike_petsc_tpu_torch import sparse as hsp
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.ordering import get_ordering
    a = problems.illscaled_nonsym(n, 6, 6, seed=0)
    a = get_ordering(a, "wbm").apply(a, scale=True)
    a = get_ordering(a, "rcm").apply(a)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    return a, data, kl, ku


@pytest.mark.cuda
@pytest.mark.parametrize("name,opts", [
    ("jacobi", {}), ("lu", {}), ("bjacobi", {"pc_bjacobi_blocks": 8}),
    ("spike", {"pc_spike_partitions": 8}), ("banded", {})])
def test_host_pmat_pc_lands_on_the_operator(cuda_device, name, opts):
    """make_solver places a PC built from a host pmat on the operator's
    device and dtype (f32 on the card), and it applies as its f64 CPU
    twin does.  The card's default block (64 or 128) moves a K > 1 PC's
    partition boundaries, so the twin takes the same block."""
    from spike_petsc_tpu_torch import make_solver
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    a, data, kl, ku = _illscaled_pipeline()
    band = banded_from_numpy(data.astype(np.float32), kl, ku,
                             device=cuda_device)
    solver = make_solver(band, pmat=a, pc_type=name, options=Options(opts))
    r = torch.randn(band.n, device=cuda_device)
    got = solver.pc.apply(r)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    ref_opts = dict(opts)
    if "block" in solver.pc.info:
        ref_opts[f"pc_{name}_block"] = solver.pc.info["block"]
    ref = make_pc(name, a, Options(ref_opts), device="cpu",
                  dtype=torch.float64).apply(r.double().cpu())
    assert _rel(got.double().cpu(), ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("block,launched", [(128, True), (None, True),
                                            (6, False)])
def test_banded_pc_inner_spike_sweep(cuda_device, block, launched):
    """The banded PC's inner spike apply launches #1 twice (a sweep and the
    recompute sweep) at b = 128 and at the card's default block (64, the
    smallest kernel block covering the tip of 6), and runs plain at b = 6
    (the tip size, the CPU's default), where the kernel's rule refuses the
    factor.  The CPU twin takes the card's block."""
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    a, _, _, _ = _illscaled_pipeline()
    opts = {"banded_pc_spike_partitions": 8, "pc_banded_frac": 0.9999}
    if block is not None:
        opts["banded_pc_spike_block"] = block
    pc = make_pc("banded", a, Options(opts), device=cuda_device,
                 dtype=torch.float32)
    assert pc.inner.info["block"] == (block or 64)
    r = torch.randn(a.shape[0], device=cuda_device)
    before = cfs.KERNEL.launches
    got = pc.apply(r)
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == before + (2 if launched else 0)
    opts["banded_pc_spike_block"] = pc.inner.info["block"]
    ref = make_pc("banded", a, Options(opts), device="cpu",
                  dtype=torch.float64).apply(r.double().cpu())
    assert _rel(got.double().cpu(), ref) <= 1e-4


@pytest.mark.cuda
def test_bjacobi_runs_the_fused_sweep(cuda_device):
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    a, _, _, _ = _illscaled_pipeline()
    pc = make_pc("bjacobi", a, Options({"pc_bjacobi_blocks": 8,
                                        "pc_bjacobi_block": 64}),
                 device=cuda_device, dtype=torch.float32)
    before = cfs.KERNEL.launches
    pc.apply(torch.randn(a.shape[0], device=cuda_device))
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == before + 1


@pytest.mark.cuda
def test_split_operator_band_part_runs_the_band_kernel(cuda_device):
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    a = problems.general_sparse(5000, seed=4)
    mv, n, dt = as_matvec(a, device=cuda_device, dtype=torch.float32)
    assert mv._route == "split_banded_cuda" and dt == torch.float32
    x = np.random.default_rng(3).standard_normal(n)
    before = cbm.KERNEL.launches
    got = mv(torch.as_tensor(x, dtype=torch.float32, device=cuda_device))
    torch.cuda.synchronize()
    assert cbm.KERNEL.launches == before + 1
    ref = a @ x
    assert float(np.abs(got.double().cpu().numpy() - ref).max()
                 / np.abs(ref).max()) <= TOL


@pytest.mark.cuda
def test_testbed_config3_on_the_card(cuda_device, capsys):
    """The testbed's config-3 pipeline at n = 20000 on the card: bandwidth
    6 after both passes, bcgs converged, both kernels launched."""
    from spike_petsc_tpu_torch import testbed
    rec = {}
    before = cbm.KERNEL.launches, cfs.KERNEL.launches
    rc = testbed.main(
        "-problem illscaled:20000:6:6 -mat_ordering_type wbm "
        "-mat_ordering_scale 1 -mat_ordering_type2 rcm -banded_pre_mat 1 "
        "-pc_banded_frac 0.9999 -ksp_type bcgs -ksp_rtol 1e-8 "
        "-pc_type banded -banded_pc_spike_partitions 8 "
        "-banded_pc_spike_block 128".split(), record=rec)
    out = capsys.readouterr().out
    assert rc == 0
    assert "to 6\n" in out and "Device operator: band storage kl=6 ku=6" in out
    its = rec["result"].its
    assert cbm.KERNEL.launches - before[0] == 2 * its + 1
    assert cfs.KERNEL.launches - before[1] == 4 * its
    assert rec["operator"].data.is_cuda and rec["b"].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("store_lt", [True, False], ids=["Lb", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sweep_on_the_regular_form_transpose(cuda_device, store_lt,
                                                   dtype):
    """#1 on the regular-form transposed factor (from the kept L blocks or
    from the band) against the plain transpose sweeps of the marker form
    on the forward factor, the same function; ``spike_solve`` on the
    regular form launches #1 and the marker none."""
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve_transpose
    from spike_petsc_tpu_torch.ops.spike import spike_transpose
    K, nb, b, k = 4, 20, 128, 60
    band = banded_from_numpy(random_band(K * nb * b, k, k - 7, seed=31,
                                         dtype=np.float32), k, k - 7,
                             device=cuda_device)
    sf = spike_factor(band, K=K, block_b=b, store_lt=store_lt,
                      store_dtype=None if dtype == torch.float32 else dtype)
    sft = spike_transpose(sf, band=None if store_lt else band)
    assert all(getattr(sft.fact, m).is_contiguous() and
               getattr(sft.fact, m).dtype == dtype for m in ("F", "U", "Sinv"))
    r = torch.randn((K, nb, b), device=cuda_device)
    ref = blocktri_solve_transpose(sf.fact, r)
    before = cfs.KERNEL.launches
    got = cfs.blocktri_solve_fused_cuda(sft.fact, r)
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == before + 1
    assert _rel(got, ref) <= (TOL if dtype == torch.float32 else 1e-2)
    rhs = torch.randn(band.n, device=cuda_device)
    before = cfs.KERNEL.launches
    x = spike_solve(sft, rhs)
    xm = spike_solve(spike_transpose(sf, fast=False), rhs)
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == before + 2   # spikes not stored: 2 sweeps
    assert _rel(x, xm) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_two_pass_sweeps_on_a_single_partition_transpose(cuda_device):
    """#9 on config 1's shape transposed: a nonsymmetric tridiagonal band at
    n = 1e5, K = 1, b = 64 (nb = 1563, which #1 refuses); the regular-form
    transpose routes to #9 like the forward factor and agrees with the
    plain transpose sweeps."""
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve_transpose
    from spike_petsc_tpu_torch.ops.spike import spike_transpose, sweep_route
    n = 100_000
    band = banded_from_numpy(random_band(n, 1, 1, seed=32,
                                         dtype=np.float32), 1, 1,
                             device=cuda_device)
    sf = spike_factor(band, K=1, block_b=64, store_lt=True)
    sft = spike_transpose(sf)
    assert sweep_route(sft.fact, 64, torch.float32, True) == "sweeps"
    r = torch.randn((1, sf.nb, 64), device=cuda_device)
    ref = blocktri_solve_transpose(sf.fact, r)
    got = csw.blocktri_solve_batched_cuda(sft.fact, r)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL
    rhs = torch.randn(n, device=cuda_device)
    before = csw.KERNEL.launches, cfs.KERNEL.launches
    x = spike_solve(sft, rhs)
    torch.cuda.synchronize()
    assert (csw.KERNEL.launches, cfs.KERNEL.launches) == (before[0] + 2,
                                                          before[1])
    assert _rel(x, spike_solve(sft, rhs, impl="plain")) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,kl,ku", [(100003, 150, 80), (100000, 1, 1)])
def test_band_matvec_kernel_on_the_transposed_band(cuda_device, n, kl, ku):
    """#2 on ``banded_transpose`` (kl and ku swapped) against its plain
    version and against ``banded_matvec_t``."""
    from spike_petsc_tpu_torch.ops.band import (banded_matvec_t,
                                                banded_transpose)
    band = banded_from_numpy(random_band(n, kl, ku, seed=33,
                                         dtype=np.float32, dominant=False),
                             kl, ku, device=cuda_device)
    bt = banded_transpose(band)
    assert (bt.kl, bt.ku) == (ku, kl)
    prep = cbm.prepare_banded_mv(bt)
    x = torch.randn(n, device=cuda_device)
    before = cbm.KERNEL.launches
    got = cbm.banded_matvec_prepared(prep, x)
    torch.cuda.synchronize()
    assert cbm.KERNEL.launches == before + 1
    assert _rel(got, cbm.banded_matvec_prepared(prep, x, impl="plain")) <= TOL
    assert _rel(got, banded_matvec_t(band, x)) <= TOL


# ---------------------------------------------------------------------------
# the factor surface on the card: lu and CR factors, K > 255, shifts
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lu", "cr"])
def test_lu_and_cr_factors_take_the_plain_route(cuda_device, method):
    """``lu`` and CR partition factors on CUDA tensors: 'auto' runs the
    plain sweeps (no kernel launched; the answer the CPU's), and
    ``impl='cuda'`` / ``'pallas'`` raise ``ValueError``."""
    from spike_petsc_tpu_torch.ops.spike import sweep_route
    n, k, b = 8192, 20, 64
    data = random_band(n, k, k, seed=31, dtype=np.float32)
    rhs = torch.from_numpy(np.random.default_rng(32).standard_normal(
        n).astype(np.float32))
    sf = spike_factor(banded_from_numpy(data, k, k, device=cuda_device), 8,
                      block_b=b, method=method)
    cpu = spike_factor(banded_from_numpy(data, k, k, device="cpu"), 8,
                       block_b=b, method=method)
    assert sweep_route(sf.fact, b, torch.float32, True) == "plain"
    before = (cfs.KERNEL.launches, csw.KERNEL.launches)
    x = spike_solve(sf, rhs.to(cuda_device))
    X = spike_solve_many(sf, rhs.to(cuda_device)[:, None].repeat(1, 3))
    torch.cuda.synchronize()
    assert (cfs.KERNEL.launches, csw.KERNEL.launches) == before
    ref = spike_solve(cpu, rhs)
    assert _rel(x.cpu(), ref) <= TOL
    assert _rel(X[:, 2].cpu(), ref) <= TOL
    for impl in ("cuda", "pallas", "pallas_fused"):
        with pytest.raises(ValueError, match="requires method"):
            spike_solve(sf, rhs.to(cuda_device), impl=impl)


@pytest.mark.cuda
def test_k300_factor_on_the_card_matches_the_cpu(cuda_device):
    """K = 300 partitions (a CR reduced system under 'auto') on the card:
    #1 runs the partition sweep, and the answer is the CPU's within
    1e-5 (f32)."""
    from spike_petsc_tpu_torch.ops.cyclic import CRFactor
    n, k, b = 300 * 128, 8, 64
    data = random_band(n, k, k, seed=33, dtype=np.float32)
    rhs = torch.from_numpy(np.random.default_rng(34).standard_normal(
        n).astype(np.float32))
    sf = spike_factor(banded_from_numpy(data, k, k, device=cuda_device), 300,
                      block_b=b)
    cpu = spike_factor(banded_from_numpy(data, k, k, device="cpu"), 300,
                       block_b=b)
    assert isinstance(sf.red_fact, CRFactor)
    launches = cfs.KERNEL.launches
    x = spike_solve(sf, rhs.to(cuda_device))
    torch.cuda.synchronize()
    assert cfs.KERNEL.launches == launches + 2        # no spikes stored
    assert _rel(x.cpu(), spike_solve(cpu, rhs)) <= TOL


@pytest.mark.cuda
def test_shifted_inv_factor_counts_as_the_cpu(cuda_device):
    """The shifted ``inv`` factor of the zero-diagonal matrix (b = 3: every
    diagonal block singular) counts the same raised pivots on the card as
    on the CPU, in f64."""
    n = 1200
    data = np.zeros((n, 3))
    data[:, 0] = data[:, 2] = -1.0
    kw = dict(K=4, block_b=3, shift="nonzero")
    sf = spike_factor(banded_from_numpy(data, 1, 1, device=cuda_device), **kw)
    cpu = spike_factor(banded_from_numpy(data, 1, 1, device="cpu"), **kw)
    assert int(sf.fact.nshift.sum()) > 0
    assert torch.equal(sf.fact.nshift.cpu(), cpu.fact.nshift)


# ---------------------------------------------------------------------------
# the remaining PCs (sor, ksp, asm, composite, fieldsplit, mg) on the card:
# their kernel routes, and each in f32 against the CPU in f64 (n = 2e4)
# ---------------------------------------------------------------------------

def _launches():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    torch.cuda.synchronize()
    return {k.name: k.launches for k in KERNELS}


def _launched(before):
    """The kernels launched since ``before`` (``_launches()``), by name."""
    after = _launches()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _pc_pair(name, n, k, opts, device, seed=35):
    """The PC ``name`` on a dominant nonsymmetric band (n, k) on the card in
    f32 and on the CPU in f64, and a right-hand side of each."""
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    data = random_band(n, k, k, seed=seed)
    r = np.random.default_rng(seed + 1).standard_normal(n)
    card = make_pc(name, banded_from_numpy(data.astype(np.float32), k, k,
                                           device=device), Options(opts))
    cpu = make_pc(name, banded_from_numpy(data, k, k, device="cpu"),
                  Options(opts))
    return (card, torch.as_tensor(r, dtype=torch.float32, device=device),
            cpu, torch.as_tensor(r))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,its,expected", [
    (20000, 64, 1, {"fused_sweep": 1}),
    (20000, 128, 1, {"fused_sweep": 1}),
    (100000, 64, 1, {"sweeps": 2}),
    (20000, 64, 2, {"fused_sweep": 2, "blocktri_matvec": 1}),
    (20000, 16, 1, {})])
def test_sor_routes_on_the_card(cuda_device, n, block, its, expected):
    """SOR's sweep is one solve on its pseudo-factor: #1 where its rule
    admits the factor (nb = 313 or 157), #9 at nb = 1563, the plain sweep
    at block 16; ``-pc_sor_its 2`` forms its residual with #7.  The apply
    within 1e-5 of the CPU's f64 apply; ``apply_many`` on 3 columns runs
    #4 once a sweep."""
    opts = {"pc_sor_block": block, "pc_sor_its": its}
    card, r, cpu, r64 = _pc_pair("sor", n, 16, opts, cuda_device)
    before = _launches()
    z = card.apply(r)
    assert _launched(before) == expected
    ref = cpu.apply(r64)
    assert _rel(z.cpu().double(), ref) <= TOL
    if block in (64, 128):
        before = _launches()
        Z = card.apply_many(torch.stack([r, 2 * r, -r], dim=1))
        assert _launched(before).get("fused_sweep_many") == its
        assert _rel(Z[:, 1].cpu().double(), 2 * ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("asm_type", ["restrict", "basic"])
def test_asm_runs_the_sweep_kernels(cuda_device, asm_type):
    """asm's windows on the card: block 64 by default (the CPU's at an
    explicit -pc_asm_block 64), one #1 launch an apply at K = 16 windows
    of 21 block rows; two #9 launches at 2 windows of 1563+ block rows;
    the transpose (marker form) runs no kernel.  Against the CPU in f64."""
    opts = {"pc_asm_type": asm_type}
    card, r, cpu, r64 = _pc_pair("asm", 20000, 16,
                                 dict(opts, pc_asm_block=64), cuda_device)
    assert card.info == cpu.info
    before = _launches()
    z = card.apply(r)
    assert _launched(before) == {"fused_sweep": 1}
    assert _rel(z.cpu().double(), cpu.apply(r64)) <= TOL
    before = _launches()
    zt = card.transpose().apply(r)
    assert _launched(before) == {}
    assert _rel(zt.cpu().double(), cpu.transpose().apply(r64)) <= TOL
    big, rb, _, _ = _pc_pair("asm", 200000, 16, dict(opts, pc_asm_blocks=2),
                             cuda_device)
    assert big.info["block"] == 64
    before = _launches()
    big.apply(rb)
    assert _launched(before) == {"sweeps": 2}


@pytest.mark.cuda
def test_mg_coarse_solve_runs_the_fused_sweep(cuda_device):
    """mg on config 1's Laplacian (n = 1e5, f32): the coarse factor takes
    block 64 (nb = 2), so one V-cycle is one #1 launch and two #2 launches
    a level above the coarsest; the transposed cycle the same on the
    regular-form coarse transpose.  The apply within 1e-5 of the CPU's f64
    one (whose coarse block is the tip size)."""
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    from spike_petsc_tpu_torch import sparse as hsp
    data, kl, ku = hsp.csr_to_banded_arrays(problems.tridiag_laplacian(100000))
    card = make_pc("mg", banded_from_numpy(data.astype(np.float32), kl, ku,
                                           device=cuda_device), Options())
    cpu = make_pc("mg", banded_from_numpy(data, kl, ku, device="cpu"),
                  Options())
    assert card.info == cpu.info and card.info["levels"] == 11
    r64 = torch.as_tensor(np.random.default_rng(36).standard_normal(100000))
    r = r64.float().to(cuda_device)
    expected = {"fused_sweep": 1,
                "band_matvec": 2 * (card.info["levels"] - 1)}
    for pc, ref in ((card, cpu), (card.transpose(), cpu.transpose())):
        before = _launches()
        z = pc.apply(r)
        assert _launched(before) == expected
        assert _rel(z.cpu().double(), ref.apply(r64)) <= TOL
    before = _launches()
    Z = card.apply_many(torch.stack([r, -r], dim=1))
    assert _launched(before)["fused_sweep_many"] == 1
    assert _rel(Z[:, 1].cpu().double(), -cpu.apply(r64)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pc_type,argv,ksp", pc_recipes.PC_RECIPES)
def test_pc_on_the_card_matches_the_cpu(cuda_device, pc_type, argv, ksp):
    """Each PC of this slice through ``solve`` on the card in f32 against
    the CPU in f64, on config 2's matrix at n = 2e4 (k = 16; the host
    CSR for composite and fieldsplit, the band otherwise): converged,
    iteration counts within 1 (f32 rounding), the answers within 1e-4 of
    max|x| (rtol 1e-6 is near f32's floor for a solve of this size)."""
    card, cpu, err = pc_recipes.solve_recipe(pc_type, argv, ksp, cuda_device)
    assert card.reason > 0 and cpu.reason > 0
    assert card.x.device.type == "cuda" and card.x.dtype == torch.float32
    assert abs(card.its - cpu.its) <= pc_recipes.ITS_SLACK == 1
    assert err <= pc_recipes.X_TOL == 1e-4


def _launches():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    torch.cuda.synchronize()
    return {k.name: k.launches for k in KERNELS if k.launches}


def _reset():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    for k in KERNELS:
        k.launches = 0


def _complex_band(n, k, device, hermitian=False, seed=30):
    """N(0,1) + i N(0,1) entries inside the band, the diagonal the row's
    absolute sum + 1 (JAX tests/test_complex.py's rule); Hermitian on
    request."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 2 * k + 1)) + 1j * rng.standard_normal(
        (n, 2 * k + 1))
    if hermitian:
        for d in range(1, k + 1):
            data[d:, k - d] = data[:n - d, k + d].conj()
    col = np.arange(n)[:, None] + np.arange(2 * k + 1)[None, :] - k
    data[(col < 0) | (col >= n)] = 0
    data[:, k] = np.abs(data).sum(axis=1) + 1
    return banded_from_numpy(data.astype(np.complex64), k, k, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("ksp,pc,hermitian", [("gmres", "spike", False),
                                              ("cg", "cholesky", True)])
def test_complex_input_launches_no_kernel(cuda_device, ksp, pc, hermitian):
    """Complex scalars on the card take the plain routes (the kernels'
    rules admit f32/bf16 only; complex spd the plain sweep): no launch,
    the answer within 1e-4 of the CPU's complex128 one."""
    band = _complex_band(8192, 20, cuda_device, hermitian)
    b = banded_matvec(band, torch.ones(8192, dtype=torch.complex64,
                                       device=cuda_device))
    opts = {f"pc_{pc}_partitions": 8, f"pc_{pc}_block": 64}
    _reset()
    got = solve(band, b, ksp_type=ksp, pc_type=pc, options=Options(opts),
                rtol=1e-6)
    assert not _launches() and got.reason > 0 and got.x.is_cuda
    cpu = BandedMatrix(data=band.data.to(torch.complex128).cpu(), kl=20,
                       ku=20)
    ref = solve(cpu, b.to(torch.complex128).cpu(), ksp_type=ksp,
                pc_type=pc, options=Options(opts), rtol=1e-6)
    assert _rel(got.x.to(torch.complex128).cpu(), ref.x) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,kernel", [(8192, 4, "fused_sweep"),
                                        (100_000, 1, "sweeps")])
def test_solve_banded_diff_runs_the_sweep_kernels(cuda_device, n, K,
                                                  kernel):
    """Both passes of ``solve_banded_diff`` on the card run the sweep
    kernels: #1 twice a pass at K = 4 (no stored spikes: two sweeps a
    solve) and the reduced system's kernel once, #9's pair once a pass on
    one long partition; the gradients within 1e-3 of the CPU's f64
    ones."""
    from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff
    k = 20 if K > 1 else 1
    data = random_band(n, k, k, seed=31, dtype=np.float32)
    rhs = np.random.default_rng(32).standard_normal(n).astype(np.float32)

    def grads(device, dtype):
        d = torch.tensor(data, dtype=dtype, device=device,
                         requires_grad=True)
        b = torch.tensor(rhs, dtype=dtype, device=device, requires_grad=True)
        _reset()
        x = solve_banded_diff(d, b, k, k, K)
        fwd = _launches() if device != "cpu" else None
        _reset()
        g = torch.autograd.grad((torch.sin(x) * x).sum(), (d, b))
        bwd = _launches() if device != "cpu" else None
        return g, fwd, bwd

    (gd, gb), fwd, bwd = grads(cuda_device, torch.float32)
    assert fwd == bwd == ({kernel: 2, "reduced_thomas": 1} if K > 1
                          else {kernel: 2})
    (gd64, gb64), _, _ = grads("cpu", torch.float64)
    assert _rel(gd.double().cpu(), gd64) <= 1e-3
    assert _rel(gb.double().cpu(), gb64) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cgs", ["always", "never", "ifneeded"])
def test_gmres_many_right_pc_runs_the_multi_rhs_sweep(cuda_device, cgs):
    """``make_solver_many(ksp_type='gmres')`` with the spike PC on the right
    applies it through ``spike_solve_many`` (#4) and converges every
    column as the CPU's f64 solve does (its within 1)."""
    from spike_petsc_tpu_torch import make_solver_many
    band = banded_from_numpy(random_band(16384, 20, 20, seed=33,
                                         dtype=np.float32), 20, 20,
                             device=cuda_device)
    B = torch.randn((16384, 8), generator=torch.Generator(
        device=cuda_device).manual_seed(34), device=cuda_device)
    opts = {"pc_spike_partitions": 8, "pc_spike_block": 64,
            "ksp_pc_side": "right", "ksp_gmres_cgs_refinement_type": cgs}
    _reset()
    got = make_solver_many(band, ksp_type="gmres", pc_type="spike",
                           options=Options(dict(opts)), rtol=1e-5)(B)
    assert _launches().get("fused_sweep_many", 0) > 0
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    ref = make_solver_many(cpu, ksp_type="gmres", pc_type="spike",
                           options=Options(dict(opts)), rtol=1e-5)(
        B.double().cpu())
    assert bool((got.reason > 0).all()) and bool((ref.reason > 0).all())
    assert (got.its - ref.its).abs().max() <= 1
    assert _rel(got.x.double().cpu(), ref.x) <= 1e-4


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A factor with bf16 spikes saved from the card and loaded back onto
    it solves bit-equal (the kernels on both)."""
    from spike_petsc_tpu_torch.io import load_factorization, save_factorization
    band = banded_from_numpy(random_band(8192, 20, 20, seed=35,
                                         dtype=np.float32), 20, 20,
                             device=cuda_device)
    sf = spike_factor(band, K=4, block_b=64, store_spikes=True,
                      spike_dtype=torch.bfloat16)
    save_factorization(str(tmp_path / "f.npz"), sf)
    sf2 = load_factorization(str(tmp_path / "f.npz"), device=cuda_device)
    b = torch.randn(8192, device=cuda_device)
    assert sf2.V.dtype == torch.bfloat16 and sf2.V.is_cuda
    assert torch.equal(spike_solve(sf2, b), spike_solve(sf, b))


@pytest.mark.cuda
@pytest.mark.parametrize("winner", ["blocktri", "banded_cuda", "xla"])
def test_auto_ignores_tuning_records(cuda_device, tmp_path, monkeypatch,
                                     winner):
    """'auto' on a CUDA band takes #2 whatever a record for this card and
    width names: the port's dispatch follows no record."""
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    from spike_petsc_tpu_torch.utils import tuning
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    band = banded_from_numpy(random_band(65536, 100, 100, seed=40,
                                         dtype=np.float32), 100, 100,
                             device=cuda_device)
    tuning.update(tuning.platform_key(), "banded_matvec",
                  tuning.matvec_key(201, torch.float32),
                  {"winner": winner, "n": 65536})
    assert tuning.matvec_route_hint(tuning.platform_key(), 201,
                                    torch.float32, 65536) == winner
    x = torch.randn(65536, device=cuda_device)
    _reset()
    mv, _, _ = as_matvec(band)
    y = mv(x)
    launches = _launches()
    assert mv._route == "banded_cuda"
    assert launches.get("band_matvec") == 1 \
        and not launches.get("blocktri_matvec")
    assert _rel(y, banded_matvec(band, x)) <= TOL


@pytest.mark.cuda
def test_tune_records_under_the_card_name(cuda_device, tmp_path,
                                          monkeypatch, capsys):
    import json
    from spike_petsc_tpu_torch.tools import tune
    from spike_petsc_tpu_torch.utils import tuning
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    assert tune.main("-n 65536 -halfbw 100 -reps 4".split()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    key = "cuda:" + torch.cuda.get_device_name().lower().replace(" ", "")
    assert line["platform"] == tuning.platform_key() == key
    assert {"xla_ms", "banded_cuda_ms", "blocktri_ms"} <= set(line)
    with open(tmp_path / "t.json") as f:
        entry = json.load(f)[key]["banded_matvec"]["201:float32"]
    assert entry["winner"] in ("banded_cuda", "blocktri")
    assert tuning.matvec_route_hint(key, 201, torch.float32, 65536) \
        == entry["winner"]


@pytest.mark.cuda
def test_native_generator_structure_on_the_card(cuda_device):
    """``blocktri_diagdom_device`` on the card: band masks, identity rows
    past n, strict dominance, and the native factor solves it (#1)."""
    from spike_petsc_tpu_torch.models.problems import blocktri_diagdom_device
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_to_band
    from spike_petsc_tpu_torch.ops.spike import spike_factor_blocks
    n, kl, ku, K, b = 50_000, 20, 30, 8, 64
    T, npad = blocktri_diagdom_device(n, kl, ku, K, b, seed=3)
    assert T.D.is_cuda and npad == T.nb * b >= n
    p = torch.arange(b, device=cuda_device)[:, None]
    q = torch.arange(b, device=cuda_device)[None, :]
    assert not T.D[:, ~((q - p <= ku) & (p - q <= kl))].any()
    assert not T.U[:, ~(b + q - p <= ku)].any()
    assert not T.L[:, ~(q - p >= b - kl)].any()
    x = torch.randn(npad, device=cuda_device)
    y = banded_matvec(blocktri_to_band(T, kl, ku), x)
    assert torch.equal(y[n:], x[n:])
    sf = spike_factor_blocks(T, n=n, K=K, kl=kl, ku=ku, store_spikes=True)
    u = torch.randn(npad, device=cuda_device)
    u[n:] = 0
    rhs = banded_matvec(blocktri_to_band(T, kl, ku), u)[:n]
    _reset()
    xs = spike_solve(sf, rhs)
    assert _launches().get("fused_sweep") == 1
    assert float(torch.linalg.norm(xs - u[:n]) / torch.linalg.norm(u[:n])) \
        < 1e-5


@pytest.mark.cuda
def test_fiedler_lobpcg_on_the_card_matches_the_cpu(cuda_device):
    """``-mat_ordering_fiedler_method lobpcg`` on the card against the
    CPU (both f64) on a scrambled 2-D Laplacian, n = 2000."""
    import importlib
    from spike_petsc_tpu_torch import sparse as hsp
    from spike_petsc_tpu_torch.models import problems
    fiedler = importlib.import_module("spike_petsc_tpu_torch.ordering.fiedler")
    a = problems.laplacian_2d(40, 50)
    perm = np.random.default_rng(4).permutation(2000)
    a = hsp.permute(a, perm, perm)
    card = fiedler.fiedler(a, method="lobpcg", device=cuda_device)
    cpu = fiedler.fiedler(a, method="lobpcg", device="cpu")
    assert abs(card.info["lambda2"] - cpu.info["lambda2"]) <= 1e-8
    assert card.info["bandwidth_out"] < card.info["bandwidth_in"]


@pytest.mark.cuda
def test_auction_on_the_card_matches_the_cpu(cuda_device):
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.parallel import auction_match
    a = problems.illscaled_nonsym(20_000, 6, 6, seed=1)
    card = auction_match(a, device=cuda_device)
    cpu = auction_match(a, device="cpu")
    assert np.array_equal(card.rperm, cpu.rperm)
    assert card.info == cpu.info
    np.testing.assert_allclose(card.row_scale, cpu.row_scale, rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("pc", ["jacobi", "spike", "lu", "bjacobi",
                                "banded"])
def test_dense_tensor_pmat_on_the_card(cuda_device, pc):
    """A dense tensor on the card as operator and PC matrix: the PC is
    built on the card in the tensor's dtype and solves as the CPU's f64."""
    n = 512
    a = (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -2.0), -1))
    b = a @ np.ones(n)
    got = solve(torch.as_tensor(a, dtype=torch.float32, device=cuda_device),
                torch.as_tensor(b, dtype=torch.float32, device=cuda_device),
                ksp_type="gmres", pc_type=pc, rtol=1e-6)
    ref = solve(torch.as_tensor(a), torch.as_tensor(b), ksp_type="gmres",
                pc_type=pc, rtol=1e-6)
    assert got.x.is_cuda and got.reason > 0 and ref.reason > 0
    assert abs(int(got.its) - int(ref.its)) <= 1
    assert _rel(got.x.double().cpu(), ref.x) <= 1e-4


@pytest.fixture
def one_rank_nccl(cuda_device, tmp_path):
    """A one-rank default group (gloo for CPU tensors, NCCL for CUDA ones)
    on a file store, destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group(backend="cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield cuda_device
    dist.destroy_process_group()


@pytest.mark.cuda
def test_multislice_factor_on_the_card_equals_the_1d_mesh(one_rank_nccl):
    """A (1, 1) multislice factor on the card holds the 1-D mesh's tensors
    (one slice: the PC masks change nothing), and its gmres launches #1
    and #2 as the 1-D mesh's does."""
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor,
                                                dist_spike_factor_multislice,
                                                make_dist_solver,
                                                make_dist_solver_multislice,
                                                make_mesh,
                                                make_mesh_multislice)
    dev = one_rank_nccl
    n, k = 8 * 20 * 128, 60
    band = banded_from_numpy(random_band(n, k, k, seed=21, dtype=np.float32),
                             k, k, device=dev)
    opts = dict(block_b=128, parts_per_device=8, store_spikes=True)
    d1 = dist_spike_factor(band, make_mesh(1, device=dev), **opts)
    mesh = make_mesh_multislice((1, 1), device=dev)
    dm = dist_spike_factor_multislice(band, mesh, **opts)
    for f in ("Btip", "Ctip", "V", "W"):
        assert _rel(getattr(dm, f), getattr(d1, f)) <= 1e-6, f
    assert dm.matvec_route == d1.matvec_route == "banded_cuda"
    b = banded_matvec(band, torch.ones(n, device=dev))
    res1 = make_dist_solver(d1, make_mesh(1, device=dev), rtol=1e-6)(b)
    for kern in KERNELS:
        kern.launches = 0
    res = make_dist_solver_multislice(dm, mesh, rtol=1e-6)(b)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    assert res.reason > 0 and res.its == res1.its
    assert launches["fused_sweep"] == res.its + 2
    assert launches["band_matvec"] == res.its + 1
    assert _rel(res.x, torch.ones(n, device=dev)) <= 1e-4


@pytest.mark.cuda
def test_auction_match_dist_on_the_card_matches_the_cpu(one_rank_nccl):
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.parallel import auction_match_dist, make_mesh
    a = problems.illscaled_nonsym(20_000, 6, 6, seed=1)
    card = auction_match_dist(a, make_mesh(1, device=one_rank_nccl))
    cpu = auction_match_dist(a, make_mesh(1, device="cpu"))
    assert np.array_equal(card.rperm, cpu.rperm)
    assert card.info == cpu.info
    np.testing.assert_allclose(card.row_scale, cpu.row_scale, rtol=1e-12)


@pytest.mark.cuda
def test_spans_are_host_events_and_every_launch_is_found(cuda_device):
    """Under a CUDA trace the port's spans are host-side events only (no
    device-side annotation joins the device's operations), and every
    device operation of a batched bcgs solve with a spike PC (#2, #4,
    library kernels, copies) has the host call that launched it: the CUDA
    API call of the same correlation id, inside the spans that a trace
    places it under."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spike_petsc_tpu_torch import make_solver_many
    spans = {"MatMult", "PCApply", "SPIKESweep", "SPIKEReduced",
             "SPIKECorrect", "KSPHostSync"}
    band = banded_from_numpy(random_band(20000, 50, 50, seed=16,
                                         dtype=np.float32), 50, 50,
                             device=cuda_device)
    B = banded_matvec(band, torch.randn((20000, 6), device=cuda_device))
    solver = make_solver_many(band, ksp_type="bcgs", pc_type="spike",
                              rtol=1e-6, options=Options({
                                  "pc_spike_partitions": 8,
                                  "pc_spike_block": 64,
                                  "pc_spike_store_spikes": 1}))
    plain = solver(B)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = solver(B)
        torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU]
    assert {e.name for e in cpu} >= spans
    assert dev and not any(e.name in spans or e.is_user_annotation
                           for e in dev)
    launches = {e.id for e in cpu if e.name.startswith("cu")}
    assert all(e.id in launches for e in dev)
    assert torch.equal(traced.x, plain.x)


# ---------------------------------------------------------------------------
# the reduced-system kernel (csrc/reduced_thomas.cu): the SPIKE reduced
# solve in one launch, against the plain loop blocktri_solve
# ---------------------------------------------------------------------------

REDUCED_TOL = 2e-6


def _reduced_rel(label, got, ref):
    """max|got - ref| / max|ref|, printed (pytest -s shows the reading)."""
    err = _rel(got.double(), ref.double())
    print(f"{label}: {err:.3e} of max|plain|")
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("nb,r", [(63, 32), (63, 1), (63, 5), (63, None),
                                  (2, 32), (2, None)])
def test_reduced_thomas_kernel_matches_plain(cuda_device, nb, r):
    """The flagship's reduced shape ([63, 200, 200], r = 32), one column,
    five, a vector, and nb = 2: the kernel against ``blocktri_solve`` on a
    random ``inv`` factor within 2e-6 of max|plain|, one launch."""
    from chip_smoke import random_inv_factor
    from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    f4 = random_inv_factor(1, nb, 200, torch.float32, cuda_device, seed=nb)
    fact = BlockTriFactor(F=f4.F[0], U=f4.U[0], Sinv=f4.Sinv[0])
    shape = (nb, 200) if r is None else (nb, 200, r)
    rhs = torch.randn(shape, device=cuda_device,
                      generator=torch.Generator(device=cuda_device)
                      .manual_seed(nb + (r or 0)))
    assert crt.reduced_thomas_feasible(fact, rhs)
    ref = blocktri_solve(fact, rhs)
    launches = crt.KERNEL.launches
    got = crt.blocktri_solve_reduced_cuda(fact, rhs)
    torch.cuda.synchronize()
    assert crt.KERNEL.launches == launches + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _reduced_rel(f"reduced nb={nb} r={r}", got, ref) <= REDUCED_TOL


@pytest.mark.cuda
def test_reduced_thomas_refuses_what_it_does_not_take(cuda_device):
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    sf = spike_factor(banded_from_numpy(random_band(4096, 20, 20, seed=15),
                                        20, 20, device=cuda_device),
                      K=4, block_b=64)                               # f64
    rhs = torch.zeros((3, 40, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        crt.blocktri_solve_reduced_cuda(sf.red_fact, rhs)
    f32 = cast_factor(sf.red_fact, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        crt.blocktri_solve_reduced_cuda(f32, rhs[:, :38].float())


def _wide_spike(cuda_device, n=8 * 128 * 3, seed=41, **kw):
    """The flagship's band shape (kl = ku = 100: a reduced system of 2k =
    200) on a small n, K = 8, b = 128, f32, stored bf16 spikes."""
    band = banded_from_numpy(random_band(n, 100, 100, seed=seed,
                                         dtype=np.float32), 100, 100,
                             device=cuda_device)
    kw = dict(dict(store_spikes=True, spike_dtype=torch.bfloat16), **kw)
    return band, spike_factor(band, K=8, block_b=128, **kw)


def _both_routes(monkeypatch, solve_fn):
    """``solve_fn()`` by the kernel route and by the plain one (the rule
    refusing every factor), with the kernel's launches of each."""
    from spike_petsc_tpu_torch.ops import spike as sp
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    before = crt.KERNEL.launches
    got = solve_fn()
    torch.cuda.synchronize()
    kernel_launches = crt.KERNEL.launches - before
    with monkeypatch.context() as m:
        m.setattr(sp, "reduced_thomas_feasible", lambda *a: False)
        before = crt.KERNEL.launches
        ref = solve_fn()
        torch.cuda.synchronize()
        assert crt.KERNEL.launches == before
    return got, ref, kernel_launches


@pytest.mark.cuda
@pytest.mark.parametrize("many", [True, False])
def test_spike_solve_takes_the_reduced_kernel(cuda_device, monkeypatch,
                                              many):
    """``spike_solve_many`` (r = 32) and ``spike_solve`` on the flagship's
    band shape: the reduced solve is one launch of the kernel, and the
    solution agrees with the plain route's within 2e-6 of its max."""
    _, sf = _wide_spike(cuda_device)
    assert tuple(sf.red_fact.F.shape) == (7, 200, 200)
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    if many:
        rhs = torch.randn((sf.n, 32), device=cuda_device, generator=gen)
        got, ref, launches = _both_routes(
            monkeypatch, lambda: spike_solve_many(sf, rhs))
    else:
        rhs = torch.randn(sf.n, device=cuda_device, generator=gen)
        got, ref, launches = _both_routes(
            monkeypatch, lambda: spike_solve(sf, rhs))
    assert launches == 1
    assert _reduced_rel(f"spike_solve many={many}", got, ref) <= REDUCED_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("many", [True, False])
@pytest.mark.parametrize("impl", ["plain", "xla"])
def test_plain_impl_keeps_the_plain_reduced_solve(cuda_device, many, impl):
    """``impl='plain'`` (and JAX's 'xla') is the plain PyTorch version on
    any device: at K > 1 on the card it launches no reduced kernel, and
    agrees with the kernel route within 2e-6 of its max."""
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    _, sf = _wide_spike(cuda_device, seed=47)
    gen = torch.Generator(device=cuda_device).manual_seed(48)
    shape = (sf.n, 32) if many else (sf.n,)
    rhs = torch.randn(shape, device=cuda_device, generator=gen)
    solve = spike_solve_many if many else spike_solve
    before = crt.KERNEL.launches
    ref = solve(sf, rhs, impl=impl)
    torch.cuda.synchronize()
    assert crt.KERNEL.launches == before
    got = solve(sf, rhs)
    torch.cuda.synchronize()
    assert crt.KERNEL.launches == before + 1
    assert _reduced_rel(f"impl={impl} many={many}", got, ref) <= REDUCED_TOL


@pytest.mark.cuda
def test_transposed_reduced_factor_takes_the_reduced_kernel(cuda_device,
                                                            monkeypatch):
    """``spike_transpose``'s reduced factor (built by the same
    ``reduced_factor``) takes the kernel as the forward one does: one
    launch a solve, the plain route's answer within 2e-6."""
    from spike_petsc_tpu_torch.ops.spike import spike_transpose
    band, sf = _wide_spike(cuda_device, seed=43)
    sft = spike_transpose(sf, band=band)
    rhs = torch.randn(sf.n, device=cuda_device,
                      generator=torch.Generator(device=cuda_device)
                      .manual_seed(44))
    got, ref, launches = _both_routes(monkeypatch,
                                      lambda: spike_solve(sft, rhs))
    assert launches == 1
    assert _reduced_rel("spike_transpose", got, ref) <= REDUCED_TOL


@pytest.mark.cuda
def test_reduced_kernel_launches_once_a_reduced_solve(cuda_device):
    """The spike PC on the flagship's band shape: an apply to 32 columns
    (#4) and an apply to one vector (#1) each launch the kernel exactly
    once; the SPD cells' PC (``cholesky``, truncated: the reduced system is
    K - 1 independent solves by ``red_Dinv``) never."""
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    band, _ = _wide_spike(cuda_device, seed=45)
    pc = make_pc("spike", band, Options({"pc_spike_partitions": 8,
                                         "pc_spike_block": 128,
                                         "pc_spike_store_spikes": 1}))
    R = torch.randn((band.data.shape[0], 32), device=cuda_device)
    _reset()
    pc.apply_many(R)
    assert _launches() == {"fused_sweep_many": 1, "reduced_thomas": 1}
    _reset()
    pc.apply(R[:, 0])
    assert _launches() == {"fused_sweep": 1, "reduced_thomas": 1}
    sband = banded_from_numpy(spd_band(8192, 16, seed=46).astype(np.float32),
                              16, 16, device=cuda_device)
    spc = make_pc("cholesky", sband, Options({
        "pc_cholesky_partitions": 8, "pc_cholesky_block": 64,
        "pc_cholesky_truncated": 1, "pc_cholesky_store_spikes": 1}))
    _reset()
    spc.apply_many(torch.randn((8192, 32), device=cuda_device))
    spc.apply(torch.randn(8192, device=cuda_device))
    assert "reduced_thomas" not in _launches()

"""The fused sweep kernel's (#1, ``ops/cuda/fused_sweep.py``) cluster plan
and applicability rule, on the CPU.

``fused_sweep_cluster`` picks the thread block cluster a partition takes;
the kernel is built for the sizes in ``CLUSTER_SIZES`` only.
``fused_sweep_feasible`` must admit exactly the shapes of the first design
of the kernel, whose partition vector y sat in one block's shared memory
(``(nb + 2) b`` f32 within 227 KB), so that ``sweep_route`` sends every
factor to the kernel it took before.  Pure Python: the factors here are
broadcast views of one zero element, and no kernel runs.
"""

import re

import pytest
import torch

from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
from spike_petsc_tpu_torch.ops.spike import sweep_route

H100_SMS = 132


def _factor(nb, b, dtype=torch.float32, method="inv", K=1):
    """A factor of shape [K, nb, b, b] that takes no memory."""
    z = torch.zeros((1, 1, 1, 1), dtype=dtype).expand(K, nb, b, b)
    return BlockTriFactor(F=z, U=z, Sinv=z, method=method)


def _first_design_rule(nb, b, dtype, rhs_dtype):
    """The rule as the first design of the kernel stated it, for an
    ``inv`` factor."""
    return (dtype in (torch.float32, torch.bfloat16)
            and b in (64, 128) and rhs_dtype == torch.float32
            and (nb + 2) * b * 4 <= 227 * 1024)


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
@pytest.mark.parametrize("b", [64, 128])
def test_cluster_plan_invariants(sms, b):
    for K in range(1, 4 * sms):
        for nb in (1, 2, 49, 123, 452):
            c = cfs.fused_sweep_cluster(K, nb, b, sms)
            assert c in cfs.CLUSTER_SIZES and c in (1, 2, 4, 8)
            assert b % c == 0 and (b // c) % 8 == 0
            if c > 1:
                assert K * c <= sms
            if K >= sms:
                assert c == 1
            # the largest size that fits: the next one up would not
            bigger = [d for d in cfs.CLUSTER_SIZES if d > c]
            if bigger:
                assert K * bigger[0] > sms


@pytest.mark.parametrize("K,nb,b,c", [
    (64, 123, 128, 2),     # the flagship
    (64, 245, 64, 2),      # the zero-diagonal scenario's spike factor
    (16, 49, 128, 4),      # config 4's inner factor
    (512, 16, 128, 1),     # the flagship at K = 512
    (1, 157, 64, 4),       # one partition
    (33, 10, 64, 4), (34, 10, 64, 2), (66, 10, 64, 2), (67, 10, 64, 1)])
def test_cluster_plan_at_the_measured_shapes(K, nb, b, c):
    assert cfs.fused_sweep_cluster(K, nb, b, H100_SMS) == c


def test_cluster_plan_refuses_other_blocks():
    with pytest.raises(ValueError, match="no cluster plan"):
        cfs.fused_sweep_cluster(4, 10, 32, H100_SMS)


def test_kernel_source_builds_every_planned_cluster():
    """The C dispatch has a case for each cluster size of the plan, at
    both block sizes, and none other."""
    src = cfs.KERNEL.source.read_text()
    for b in cfs._BLOCK_SIZES:
        built = sorted(int(c) for c in re.findall(
            rf"case (\d+): return RUN\({b}, \1, PACK\)", src))
        assert built == list(cfs.CLUSTER_SIZES)


@pytest.mark.parametrize("nb", [1, 2, 123, 452, 453, 906, 907, 1563])
@pytest.mark.parametrize("b", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_feasible_admits_the_first_design_shapes(nb, b, dtype):
    fact = _factor(nb, b, dtype)
    for rhs_dtype in (torch.float32, torch.float64):
        want = _first_design_rule(nb, b, dtype, rhs_dtype)
        assert cfs.fused_sweep_feasible(fact, b, rhs_dtype) == want
        route = sweep_route(fact, b, rhs_dtype, on_cuda=True)
        assert route == ("fused" if want else
                         "sweeps" if dtype != torch.float64
                         and b in (64, 128) and rhs_dtype == torch.float32
                         else "plain")


@pytest.mark.parametrize("method", ["spd", "lu"])
def test_feasible_refuses_other_methods(method):
    assert not cfs.fused_sweep_feasible(_factor(4, 64, method=method), 64)


def test_library_name_follows_the_included_headers(tmp_path, monkeypatch):
    """The kernel's library is keyed by its source and the csrc/ headers it
    includes (``async.cuh``), so an edited header rebuilds it; a header it
    does not include leaves the name as it was."""
    from spike_petsc_tpu_torch.ops.cuda import _build
    src = cfs.KERNEL.source
    assert _build._included(src.read_text()) == [src.parent / "async.cuh"]
    for name in ("fused_sweep.cu", "async.cuh"):
        (tmp_path / name).write_text((src.parent / name).read_text())
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    kern = _build.CudaKernel("fused_sweep", {})
    first = kern.library_path()
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert kern.library_path() == first
    (tmp_path / "async.cuh").write_text(
        (tmp_path / "async.cuh").read_text() + "// edited\n")
    assert kern.library_path() != first

"""The benchmark's arithmetic against numbers worked by hand: the
end-to-end metrics on synthetic call times, the bytes of a PC apply, and
the trace's intervals."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, trace
from benchmark.metrics import (_roofline, device_idle_pct, host_syncs_per_it,
                               its_per_rhs, krylov_ms_per_it,
                               launches_per_rhs, operator_ms, pc_apply_ms,
                               pc_apply_roofline, reduced_solve_ms,
                               rhs_per_s, solve_p95_ms, sweep_ms)


def synthetic_run(**kw):
    run = harness.Run(cfg={}, traffic={"columns": 2})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rate_is_over_the_whole_window():
    # 10 calls of 2 columns, 1 column failed, in a window of 4 s: 19 / 4
    run = synthetic_run(call_s=[0.1] * 10, window_s=4.0, columns=20,
                        columns_ok=19)
    assert rhs_per_s.read(run) == pytest.approx(4.75)


def test_p95_is_over_every_call():
    # 100 calls: 1 ms .. 100 ms; the inclusive 95th percentile lies at
    # 1 + 0.95 * 99 = 95.05 ms
    run = synthetic_run(call_s=[i / 1e3 for i in range(1, 101)])
    assert solve_p95_ms.read(run) == pytest.approx(95.05)
    # one stall among 40 fast calls moves it: 39 x 1 ms and one 1 s call:
    # position 0.95 * 39 = 37.05 lies among the fast ones
    run = synthetic_run(call_s=[1e-3] * 39 + [1.0])
    assert solve_p95_ms.read(run) == pytest.approx(1.0)
    run = synthetic_run(call_s=[1e-3] * 18 + [1.0, 1.0])
    # 19 gaps: position 18.05, between the 19th (1 s) and the 20th: 1000 ms
    assert solve_p95_ms.read(run) == pytest.approx(1000.0)
    assert solve_p95_ms.read(synthetic_run(call_s=[0.25])) == 250.0
    assert solve_p95_ms.read(synthetic_run()) is None


def test_its_per_rhs():
    assert its_per_rhs.read(synthetic_run(its=[1, 2, 2, 3])) == 2.0


def spike_cfg(pc, **opts):
    return {"n": 1000, "kl": 4, "ku": 3, "pc_type": pc, "options": opts}


def test_apply_bytes_by_hand():
    # n = 1000, K = 4, b = 16, k = 4: 250 rows a partition, rounded up to
    # 256: nb = 16; inv: 3 * 16 - 2 = 46 matrices of 16 x 16 f32 a
    # partition: 4 * 46 * 256 * 4 = 188416; spikes V and W in bf16:
    # 2 * 4 * 16 * 16 * 4 * 2 = 16384; the reduced system, 3 block rows
    # of 8 x 8, Thomas inv: 3 * 3 - 2 = 7 matrices: 7 * 64 * 4 = 1792;
    # r in, x out for 2 columns: 2 * 1000 * 2 * 4 = 16000
    g = _roofline.spike_geometry(spike_cfg(
        "spike", pc_spike_partitions=4, pc_spike_block=16,
        pc_spike_store_spikes=1, pc_spike_spike_dtype="bf16"))
    assert (g["K"], g["nb"], g["b"], g["k"], g["method"]) == (4, 16, 16, 4,
                                                             "inv")
    assert _roofline.apply_bytes(g, 2) == 188416 + 16384 + 1792 + 16000
    # spd, truncated, f32 spikes, 1 column: 2 * 16 - 1 = 31 matrices:
    # 4 * 31 * 256 * 4 = 126976; spikes 2 * 4 * 16 * 16 * 4 * 4 = 32768;
    # 3 inverted 8 x 8 diagonal blocks: 3 * 64 * 4 = 768; 2 * 1000 * 4
    g = _roofline.spike_geometry(spike_cfg(
        "cholesky", pc_cholesky_partitions=4, pc_cholesky_block=16,
        pc_cholesky_truncated=1, pc_cholesky_store_spikes=1))
    assert g["method"] == "spd" and g["truncated"]
    assert _roofline.apply_bytes(g, 1) == 126976 + 32768 + 768 + 8000
    # K is capped so that each partition covers 2k rows: 1000 // 8 = 125
    g = _roofline.spike_geometry(spike_cfg(
        "spike", pc_spike_partitions=500, pc_spike_block=8))
    assert g["K"] == 125 and g["nb"] == 1
    # PCBANDED's inner spike PC, its options under banded_ and the band it
    # extracts of half-width band_k = 5 (kl, ku are not read): n = 1200,
    # K = 3, b = 16, f32, spikes not stored: 400 rows a partition, 25
    # blocks of 16: nb = 25; inv: 3 * 25 - 2 = 73 matrices of 16 x 16 f32 a
    # partition: 3 * 73 * 256 * 4 = 224256; the reduced system, 2 block
    # rows of 10 x 10, Thomas inv: 3 * 2 - 2 = 4 matrices: 4 * 100 * 4 =
    # 1600; r in, x out for 1 column: 2 * 1200 * 4 = 9600
    banded_cfg = {"n": 1200, "pc_type": "banded", "band_k": 5,
                  "options": {"pc_banded_kmax": 5,
                              "banded_pc_spike_partitions": 3,
                              "banded_pc_spike_block": 16}}
    g = _roofline.spike_geometry(banded_cfg)
    assert (g["K"], g["nb"], g["b"], g["k"], g["method"]) == (3, 25, 16, 5,
                                                             "inv")
    assert not g["store_spikes"] and not g["truncated"]
    assert _roofline.apply_bytes(g, 1) == 224256 + 1600 + 9600
    # the flagship (PERF.md): 2228275968 bytes at r = 32, 0.6652 ms
    flag = {"n": 1_000_000, "kl": 100, "ku": 100, "pc_type": "spike",
            "options": {"pc_spike_partitions": 64, "pc_spike_block": 128,
                        "pc_spike_store_spikes": 1,
                        "pc_spike_spike_dtype": "bf16"}}
    nbytes = _roofline.apply_bytes(_roofline.spike_geometry(flag), 32)
    assert nbytes == 2228275968
    assert _roofline.least_ms(nbytes) == pytest.approx(0.66515, rel=1e-4)


def test_trace_intervals():
    ops = [(0, 10), (5, 12), (20, 30), (30, 31), (40, 45)]
    assert trace.union_length(ops) == 12 + 11 + 5
    assert trace.idle_gaps(ops) == [(12, 20), (31, 40)]
    assert trace.span_device_s(sorted(ops), [(0, 12), (39, 50)]) == (
        10 + 7 + 5) / 1e6
    host = [(0, 100, "call"), (10, 20, "a"), (12, 14, "b"), (30, 50, "c")]
    assert trace.host_op_at(host, [11, 13, 16, 25, 40, 200]) == [
        "a", "b", "a", "call", "c", "(no host op)"]


def trace_run(**kw):
    t = trace.TraceSummary(window_s=2.0)
    for k, v in kw.items():
        setattr(t, k, v)
    cfg = spike_cfg("spike", pc_spike_partitions=4, pc_spike_block=16,
                    pc_spike_store_spikes=1, pc_spike_spike_dtype="bf16")
    return harness.Run(cfg=cfg, traffic={"columns": 2}, trace=t,
                       call_its=[2, 3], columns=40)


def test_trace_readers():
    run = trace_run(busy_s=1.5, device_ops=200,
                    span_count={trace.PC_SPAN: 4, trace.CALL_SPAN: 2},
                    span_device_s={trace.CALL_SPAN: 1.0,
                                   trace.PC_SPAN: 0.4})
    assert device_idle_pct.read(run) == pytest.approx(25.0)
    assert launches_per_rhs.read(run) == 5.0
    assert pc_apply_ms.read(run) == pytest.approx(100.0)
    # (1.0 - 0.4) s over 2 + 3 iterations
    assert krylov_ms_per_it.read(run) == pytest.approx(120.0)
    least = _roofline.least_ms(188416 + 16384 + 1792 + 16000)
    assert pc_apply_roofline.read(run) == pytest.approx(least / 100.0 * 100)


def test_readers_find_nothing_without_device_operations():
    run = trace_run()
    for reader in (device_idle_pct, launches_per_rhs, pc_apply_ms,
                   pc_apply_roofline, krylov_ms_per_it, operator_ms,
                   sweep_ms, reduced_solve_ms, host_syncs_per_it):
        assert reader.read(run) is None
    # spans that ran on the host, with no device trace (the CPU): the
    # device readers find nothing, the count of host reads is read
    run = trace_run(span_count={"MatMult": 3, "KSPHostSync": 10},
                    span_device_s={"MatMult": 0.0})
    assert operator_ms.read(run) is None
    assert host_syncs_per_it.read(run) == 2.0


def event(name, start, end, device=DeviceType.CPU, corr=0):
    """A profiler event as ``prof.events()`` gives it (times in us)."""
    return SimpleNamespace(name=name, device_type=device, id=corr, thread=1,
                           time_range=SimpleNamespace(start=start, end=end))


def kernel(name, start, end, corr):
    return event(name, start, end, DeviceType.CUDA, corr)


def summary_of(events, spans):
    prof = SimpleNamespace(events=lambda: events)
    return trace.summarize(prof, 1e-4, spans)


# one call: MatMult (a second MatMult nested in it), then PCApply with a
# SPIKESweep nested in it, and a second PCApply; the kernels k1 .. k3
# launched at 20 (MatMult), 45 (no program span) and 56 (PCApply and
# SPIKESweep), a set with no launch found; the device's own
# bench.call interval from 15 to 96
CALL = [event(trace.CALL_SPAN, 0, 100), event("MatMult", 10, 40),
        event("MatMult", 12, 14), event("PCApply", 50, 90),
        event("SPIKESweep", 55, 70), event("PCApply", 92, 99),
        event("cudaLaunchKernel", 20, 21, corr=2),
        event("cudaLaunchKernel", 45, 46, corr=3),
        event("cuLaunchKernelEx", 56, 57, corr=1),
        kernel("k2", 22, 32, 2), kernel("k3", 47, 49, 3),
        kernel("k1", 60, 64, 1), kernel("Memset (Device)", 94, 96, 9),
        kernel(trace.CALL_SPAN, 15, 96, 0)]


def test_a_kernel_counts_under_every_span_open_at_its_launch():
    t = summary_of(CALL, ["MatMult", "PCApply", "SPIKESweep", "KSPHostSync",
                          "MatMult"])
    assert t.span_count["MatMult"] == 2 and t.span_count["PCApply"] == 2
    assert t.span_count["SPIKESweep"] == 1 and t.span_count[
        "KSPHostSync"] == 0
    # k1 under both PCApply and the SPIKESweep inside it; k2 once under
    # MatMult, though two MatMult were open
    assert t.span_ops == {"MatMult": 1, "PCApply": 1, "SPIKESweep": 1,
                          "KSPHostSync": 0}
    assert t.span_device_s["MatMult"] == pytest.approx(10e-6)
    assert t.span_device_s["PCApply"] == pytest.approx(4e-6)
    assert t.span_device_s["SPIKESweep"] == pytest.approx(4e-6)
    assert t.span_device_s["KSPHostSync"] == 0.0


def test_a_kernel_launched_outside_every_span_counts_under_none():
    t = summary_of(CALL, ["MatMult", "PCApply", "SPIKESweep"])
    # k3 (2 us) is in the call's device time and under no program span
    assert sum(t.span_ops.values()) == 3
    assert t.span_device_s[trace.CALL_SPAN] == pytest.approx(
        (10 + 2 + 4 + 2) / 1e6)
    assert sum(t.span_device_s[n] for n in ("MatMult", "PCApply")) == (
        pytest.approx(14e-6))


def test_an_operation_with_no_launch_is_counted_unmatched():
    t = summary_of(CALL, ["MatMult"])
    assert t.unmatched_ops == 1 and t.device_ops == 4


def test_the_harness_spans_keep_their_device_reduction():
    """Declared or not, ``bench.call`` and ``bench.pc_apply`` are reduced
    by their intervals on the device's timeline, as they always were."""
    plain = summary_of(CALL, [])
    declared = summary_of(CALL, ["MatMult", trace.CALL_SPAN, trace.PC_SPAN])
    for t in (plain, declared):
        assert t.span_count[trace.CALL_SPAN] == 1
        assert t.span_device_s[trace.CALL_SPAN] == pytest.approx(18e-6)
        assert t.span_device_s[trace.PC_SPAN] == 0.0
        assert t.device_ops == 4 and t.busy_s == pytest.approx(18e-6)
    assert trace.CALL_SPAN not in declared.span_ops
    assert plain.span_ops == {} and plain.unmatched_ops == 1


def test_span_readers_on_a_reduced_trace():
    t = summary_of(CALL, ["MatMult", "SPIKESweep", "SPIKEReduced",
                          "KSPHostSync"])
    run = harness.Run(cfg={}, traffic={"columns": 1}, trace=t,
                      call_its=[2])
    assert operator_ms.read(run) == pytest.approx(10e-3 / 2)
    assert sweep_ms.read(run) == pytest.approx(4e-3)
    # the reduced solve and the host reads did not run
    assert reduced_solve_ms.read(run) is None
    assert host_syncs_per_it.read(run) is None

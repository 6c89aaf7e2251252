"""The metric arithmetic on synthetic traces and windows."""

import math

import numpy as np
import pytest

from benchmark import devtrace, harness, work
from benchmark.run import read_metric
from benchmark.tests.small import load


def _launch(name, span, span_id, events):
    ln = devtrace.Launch(name, events[0][1] if events else 0, 0)
    ln.span, ln.span_id, ln.events = span, span_id, list(events)
    return ln


def _trace():
    """A 10 ms window: two ticks, each an upload, a front-end of two
    kernels, a step with FT (and FP on the second tick) and a host wait."""
    ms = 1_000_000
    tr = devtrace.Trace()
    tr.window_s = 0.010
    tr.block = (0, 10 * ms)
    tr.spans = {"upload": [(0, ms // 2), (5 * ms, 5 * ms + ms // 2)],
                "frontend": [(ms // 2, ms), (5 * ms + ms // 2, 6 * ms)],
                "step": [(ms, 5 * ms), (6 * ms, 10 * ms)]}
    tr.launches = [
        _launch("cudaMemcpyAsync", "upload", 0, [("Memcpy HtoD", 0, ms // 4)]),
        _launch("cudaLaunchKernel", "frontend", 1, [("k_a", ms, ms // 2)]),
        _launch("cudaLaunchKernel", "frontend", 1, [("k_b", ms + ms // 2, ms // 2)]),
        _launch("cudaGraphLaunch", "step", 2, [("ft", 2 * ms, ms // 2), ("ft", 2 * ms + ms // 2, ms // 2)]),
        _launch("cudaMemcpyAsync", "upload", 3, [("Memcpy HtoD", 5 * ms, ms // 4)]),
        _launch("cudaLaunchKernel", "frontend", 4, [("k_a", 6 * ms, ms // 2)]),
        _launch("cudaLaunchKernel", "frontend", 4, [("k_b", 6 * ms + ms // 2, ms // 2)]),
        _launch("cudaGraphLaunch", "step", 5, [("ft", 7 * ms, ms // 2), ("ft", 7 * ms + ms // 2, ms // 2)]),
        _launch("cudaGraphLaunch", "step", 5, [("fp", 8 * ms, ms), ("fp", 9 * ms, ms)]),
    ]
    return tr


class _Run:
    def __init__(self, trace, cfg, frames):
        self.trace, self.cfg, self.trace_frames = trace, cfg, frames


def test_bench_idle_share_is_the_union_of_device_intervals():
    tr = _trace()
    # busy: 0.25 + 1 + 1 (+ HtoD 0.25) + 1 + 1 + 2 = 6.5 ms of 10
    assert tr.busy_s() == pytest.approx(0.0065)
    assert read_metric("device_idle_pct", _Run(tr, {}, 32)) == pytest.approx(35.0)
    # overlapping intervals count once
    tr.launches.append(_launch("cudaLaunchKernel", "step", 5, [("x", 8_000_001, 10)]))
    assert tr.busy_s() == pytest.approx(0.0065)


def test_bench_gaps_are_named_by_the_host_span():
    gaps = _trace().gaps()
    # the longest: 3 .. 5 ms, the host in the first step (its wait)
    assert gaps[0] == ("step", pytest.approx(0.002))
    assert gaps[1][1] == pytest.approx(0.00075)  # 0.25 .. 1 and 5.25 .. 6 ms
    assert {n for n, _ in gaps} <= {"upload", "frontend", "step", "between spans"}


def test_bench_graph_replays_by_order_in_the_step():
    tr = _trace()
    run = _Run(tr, {}, 32)
    assert read_metric("ft_ms", run) == pytest.approx(1.0)
    assert read_metric("fp_ms", run) == pytest.approx(2.0)
    # a replay that lost events is an error, not a smaller number
    tr.launches.append(_launch("cudaGraphLaunch", "step", 6, [("ft", 0, 10), ("ft", 0, 10)]))
    tr.launches.append(_launch("cudaGraphLaunch", "step", 6, [("fp", 0, 10)]))
    with pytest.raises(devtrace.ShortWindowError):
        read_metric("fp_ms", run)


def test_bench_frontend_time_and_roofline():
    cfg, _ = load("tum_vga_fleet", "staggered_xyz")
    cfg = dict(cfg, streams=16)
    run = _Run(_trace(), cfg, 32)
    assert read_metric("frontend_ms_per_frame", run) == pytest.approx(2.0 / 32)
    least = work.frontend_work(16, (480, 640), cfg["frontend"])["least_s"]
    assert read_metric("frontend_roofline", run) == pytest.approx(100 * least * 2 / 0.002)
    assert 0 < read_metric("frontend_roofline", run) < 100


def test_bench_readers_find_nothing_without_a_trace():
    run = _Run(None, {}, 0)
    for name in ("device_idle_pct", "frontend_roofline", "frontend_ms_per_frame", "ft_ms",
                 "fp_ms"):
        assert read_metric(name, run) is None


def test_bench_rate_and_tail_over_the_whole_window():
    run = harness.Run({}, {}, 1, None)
    run.window_s = 2.0
    run.frames = 16 * 30
    run.tick_ms = [10.0] * 95 + [100.0] * 5
    run.peak_at_steps = 3 * 2**30
    run.setup_s = 12.5
    e = harness.end_to_end(run, ["frames_per_s", "tick_p95_ms", "peak_mem_gib", "setup_s"])
    assert e["frames_per_s"] == 240.0
    # numpy's linear 95th percentile of 95 tens and 5 hundreds
    assert e["tick_p95_ms"] == pytest.approx(float(np.percentile(run.tick_ms, 95)))
    assert 10.0 < e["tick_p95_ms"] < 100.0
    assert e["peak_mem_gib"] == 3.0 and e["setup_s"] == 12.5
    # too few ticks for a tail: the metric is left out, not made up
    run.tick_ms = [10.0] * 10
    assert harness.end_to_end(run, ["tick_p95_ms"])["tick_p95_ms"] is None


def test_bench_work_counts_scale_with_the_batch():
    cfg, _ = load("tum_vga_g4_features", "pool_b32")
    one = work.frontend_work(1, (480, 640), cfg["frontend"])
    many = work.frontend_work(32, (480, 640), cfg["frontend"])
    assert many["flops"] == 32 * one["flops"] and many["bytes"] == 32 * one["bytes"]
    assert math.isclose(many["least_s"], 32 * one["least_s"])
    g2 = work.frontend_work(1, (480, 640), dict(cfg["frontend"], order=2))
    assert g2["flops"] < one["flops"]

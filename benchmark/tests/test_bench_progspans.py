"""The readers of the program's spans on synthetic rings, and on the
program's own ring after a few CPU calls."""

import time

import pytest
import torch

from benchmark import devtrace, progspans
from benchmark.run import read_metric
from cvsteer_tpu_torch.utils import profiling
from cvsteer_tpu_torch.utils.profiling import Span

MS = 1_000_000
HOST_READERS = ("fleet_host_ms_per_tick", "fleet_wait_ms_per_tick", "fp_row_use_pct",
                "frontend_host_ms_per_frame")


class _Run:
    def __init__(self, block, ticks=0, launches=(), counters=None, traffic=None):
        self.trace = devtrace.Trace()
        self.trace.block = block
        self.trace.launches = list(launches)
        self.trace_ticks = ticks
        self.counters = dict(counters or {})
        self.traffic = dict(traffic or {})


class _Ring:
    """Spans in the order they open; ``add`` returns the span's index."""

    def __init__(self):
        self.spans = []

    def add(self, name, a, b, parent=-1, **attrs):
        self.spans.append(Span(len(self.spans), name, a, b, parent, attrs))
        return len(self.spans) - 1


def _tick(ring, t, k, fp, host_ms=7):
    """Tick k at t: a 1 ms front-end call of 16 frames, then a step of
    host_ms + 3 ms with a 2 ms fetch-1 wait and, inside a fleet.process, a
    1 ms wait; FP on 16 rows with 3 promotions when fp."""
    ring.add("features.extract", t, t + MS, frames=16, path="fused")
    t += MS
    s = ring.add("fleet.step", t, t + (host_ms + 3) * MS, tick=k, stepped=16,
                 bootstrapped=0, fp_rows=16 if fp else 0, promoted=3 if fp else 0, event_paths=0)
    ring.add("fleet.wait", t + 2 * MS, t + 4 * MS, s, fetch=1)
    p = ring.add("fleet.process", t + 5 * MS, t + 8 * MS, s)
    ring.add("fleet.wait", t + 6 * MS, t + 7 * MS, p, fetch=1)
    ring.add("fleet.event", t + 7 * MS, t + 8 * MS, p, stream=3)
    return t + (host_ms + 3) * MS


@pytest.fixture
def ring(monkeypatch):
    r = _Ring()
    monkeypatch.setattr(progspans, "recorded", lambda: r.spans)
    return r


@pytest.mark.parametrize("window", [progspans.OFFSET + progspans.COUNT, 400])
def test_bench_host_readers_take_a_fixed_stretch_of_the_window(ring, window):
    warm, t, k = 10, 0, 0
    lo, hi = warm + progspans.OFFSET, warm + progspans.OFFSET + progspans.COUNT
    for k in range(warm + window):
        # outside the stretch (warm-up, the window's first and last ticks):
        # slower, no FP
        inside = lo <= k < hi
        t = _tick(ring, t, k, fp=inside and k % 2 == 0, host_ms=7 if inside else 20)
    block = t + MS
    for j in range(5):  # the traced stretch: left out of the host figures
        t = _tick(ring, t + MS, warm + window + j, fp=True, host_ms=50)
    run = _Run((block, t + MS), counters=dict(warmup_ticks=warm, window_ticks=window))
    assert read_metric("fleet_host_ms_per_tick", run) == pytest.approx(7.0)
    assert read_metric("fleet_wait_ms_per_tick", run) == pytest.approx(3.0)
    assert read_metric("fp_row_use_pct", run) == pytest.approx(100 * 3 / 16)
    assert read_metric("frontend_host_ms_per_frame", run) == pytest.approx(1 / 16)
    # a window shorter than the stretch: nothing is made up
    short = _Run((block, t + MS), counters=dict(warmup_ticks=warm, window_ticks=lo + 199 - warm))
    for name in HOST_READERS:
        assert read_metric(name, short) is None
    # a ring that lost the run's first spans cannot number the calls
    del ring.spans[0]
    assert read_metric("frontend_host_ms_per_frame", run) is None


def _launch(start, dur):
    ln = devtrace.Launch("cudaLaunchKernel", start, 0)
    ln.events = [("k", start, dur)]
    return ln


def test_bench_idle_share_counts_only_the_fleets_own_host_time(ring):
    # two traced ticks in a 40 ms block: each step 10 ms with a 2 ms and a
    # 1 ms wait, so 7 ms of host time; the device busy for the whole first
    # step, and in the second only during its first wait (2 .. 4 ms in)
    t1 = 5 * MS
    _tick(ring, t1 - MS, 0, fp=True)
    t2 = 25 * MS
    _tick(ring, t2 - MS, 1, fp=True)
    ring.add("fleet.step", 100 * MS, 110 * MS)  # after the block: left out
    busy = [_launch(t1, 10 * MS), _launch(t2 + 2 * MS, 2 * MS)]
    run = _Run((0, 40 * MS), ticks=2, launches=busy)
    assert read_metric("fleet_host_idle_pct", run) == pytest.approx(100 * (0 + 7) / 14)
    run.trace.launches = [_launch(0, 40 * MS)]  # never idle
    assert read_metric("fleet_host_idle_pct", run) == 0.0
    run.trace.launches = []
    assert read_metric("fleet_host_idle_pct", run) is None


def test_bench_readers_find_nothing_without_the_programs_ring(monkeypatch):
    # a program without the ring (the parent of the spans): None, not 0
    monkeypatch.delattr(profiling, "spans")
    assert progspans.recorded() is None
    run = _Run((10**19, 10**19), ticks=2, launches=[_launch(0, MS)],
               counters=dict(warmup_ticks=0, window_ticks=400))
    for name in HOST_READERS + ("fleet_host_idle_pct",):
        assert read_metric(name, run) is None


def test_bench_frontend_host_time_from_the_programs_own_ring():
    from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features

    cfg = FrontendConfig(levels=2, keypoints_per_level=16)
    imgs = torch.rand(2, 32, 32) * 255
    warm, window = 3, progspans.OFFSET + progspans.COUNT + 2
    profiling.clear()  # the ring is the process's: other tests' fleets ran here
    for _ in range(warm + window):
        extract_features(imgs, cfg=cfg)
    run = _Run((time.time_ns(), time.time_ns()), counters=dict(window_batches=window),
               traffic=dict(warmup_batches=warm))
    got = read_metric("frontend_host_ms_per_frame", run)
    calls = [s for s in profiling.spans() if s.name == "features.extract"]
    assert len(calls) == warm + window
    mine = calls[warm + progspans.OFFSET: warm + progspans.OFFSET + progspans.COUNT]
    want = sum(s.end_ns - s.start_ns for s in mine) / (2 * progspans.COUNT) / 1e6
    assert got == pytest.approx(want)
    assert read_metric("fleet_host_ms_per_tick", run) is None  # no fleet ran

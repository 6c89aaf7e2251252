"""The program's spans (cvsteer_tpu_torch.utils.profiling.annotate), on CPU:
nesting, parents, attributes and the ring's bound; a stack per thread; no
record_function without a profiler, and under a CPU torch.profiler the
ring's stamps within 1 ms of kineto's host range for the same span (the
clock they share); and ``cli_vo --verbose`` serving two sequences, which
prints each span name's self time and the fleet's counts a tick."""

import pathlib
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cvsteer_tpu_torch.utils import profiling
from cvsteer_tpu_torch.utils.profiling import annotate

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "assets" / "tum_fixture"


def _mine(prefix):
    return [s for s in profiling.spans() if s.name.startswith(prefix)]


def test_torch_spans_nest_with_parents_attrs_and_a_bounded_ring():
    with annotate("t1.outer", tick=3, path="fused") as outer:
        with annotate("t1.inner", level=0):
            pass
        with annotate("t1.inner", level=1) as inner:
            inner.add(rows=2)
            inner.add(rows=3)
        outer.set(promoted=5, share=0.5)
    a, b, c = _mine("t1.")
    assert [s.name for s in (a, b, c)] == ["t1.outer", "t1.inner", "t1.inner"]
    assert a.index < b.index < c.index and a.parent == -1 and b.parent == c.parent == a.index
    assert a.attrs == dict(tick=3, path="fused", promoted=5, share=0.5)
    assert b.attrs == dict(level=0) and c.attrs == dict(level=1, rows=5)
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns
    own = profiling.self_ms([a, b, c])
    assert own["t1.outer"] == pytest.approx(
        (a.end_ns - a.start_ns - (b.end_ns - b.start_ns) - (c.end_ns - c.start_ns)) / 1e6)
    assert own["t1.inner"] == pytest.approx((b.end_ns - b.start_ns + c.end_ns - c.start_ns) / 1e6)
    assert profiling.spans(until_ns=a.end_ns - 1)[-2:] == [b, c]
    # a span never holds a tensor (nor a numpy scalar or a bool)
    for bad in (torch.ones(1), True, None):
        with pytest.raises(TypeError):
            annotate("t1.bad", x=bad)
        with pytest.raises(TypeError):
            annotate("t1.bad").set(x=bad)
    # the ring keeps the newest RING_SIZE spans, in order
    for k in range(profiling.RING_SIZE + 10):
        with annotate("t1.fill", k=k):
            pass
    fill = _mine("t1.fill")
    assert profiling.RING_SIZE - 2 <= len(fill) <= profiling.RING_SIZE
    ks = [s.attrs["k"] for s in fill]
    assert ks == sorted(ks) and ks[-1] == profiling.RING_SIZE + 9
    assert not _mine("t1.outer")
    # clear empties the ring and numbers spans from 0 again
    profiling.clear()
    assert profiling.spans() == []
    with annotate("t1.after"):
        pass
    assert [(s.index, s.name) for s in profiling.spans()] == [(0, "t1.after")]
    profiling.clear()
    assert profiling.spans() == []


def test_torch_spans_keep_a_stack_per_thread():
    n_threads, reps = 8, 200
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        try:
            for _ in range(reps):
                with annotate(f"t2.outer.{t}"):
                    with annotate(f"t2.inner.{t}"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    spans = _mine("t2.")
    by_index = {s.index: s for s in spans}
    assert len(spans) == 2 * n_threads * reps
    assert len(by_index) == len(spans)  # every span its own index
    for s in spans:
        kind, t = s.name.split(".")[1:]
        if kind == "outer":
            assert s.parent == -1 or not by_index.get(s.parent, s).name.startswith("t2.")
        else:
            assert by_index[s.parent].name == f"t2.outer.{t}"


def test_torch_spans_open_ranges_only_under_a_profiler_on_kinetos_clock(monkeypatch):
    opened = []
    real = profiling._range_type

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(profiling, "_range_type", counting)
    for _ in range(10):
        with annotate("t3.off"):
            torch.ones(4).sum()
    assert opened == []
    n = 60
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("warm-up"):  # the profiler's first range pays its lazy set-up
            pass
        for k in range(n):
            with annotate(f"t3.on.{k}"):
                with annotate(f"t3.in.{k}"):
                    torch.ones(64).cumsum(0)
    assert len(opened) == 2 * n + 1
    host = {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("t3.")}
    ring = _mine("t3.")
    assert len([s for s in ring if not s.name.startswith("t3.off")]) == 2 * n
    worst = 0
    for s in ring:
        if s.name.startswith("t3.off"):
            continue
        e = host[s.name]
        worst = max(worst, abs(s.start_ns - e.start_ns()), abs(e.end_ns() - s.end_ns))
    assert worst < 1_000_000, f"ring and kineto ranges {worst / 1e6:.3f} ms apart"


def test_torch_cli_vo_verbose_serving_reads_the_ring(capsys):
    from cvsteer_tpu_torch.cli_vo import main

    argv = ["--input", f"{FIXTURE},{FIXTURE}", "--set", "camera.fx=300", "camera.fy=300",
            "camera.cx=160", "camera.cy=120", "slam.min_parallax=0.005", "slam.kf_max_gap=2",
            "slam.window=6", "--engine", "device", "--device", "cpu", "--max-frames", "8",
            "--verbose"]
    assert main(argv) == 0
    err = capsys.readouterr().err
    table = next(ln for ln in err.splitlines() if ln.startswith("span self ms a tick over 8 ticks"))
    for name in ("cli.tick", "cli.decode", "fleet.step", "fleet.enter", "fleet.stage",
                 "fleet.ft", "fleet.wait", "fleet.complete", "vo.init", "features.extract",
                 "features.pyramid", "features.level", "features.descriptors",
                 "features.assemble"):
        assert f" {name} " in table, name
    for label in ("fleet.wait[fetch=1]", "features.extract[path=fused]"):
        assert f" {label} " in table, label
    counts = next(ln for ln in err.splitlines() if ln.startswith("fleet.step counts a tick:"))
    for key in ("stepped", "bootstrapped", "fp_rows", "promoted", "event_paths"):
        assert f" {key} " in counts, key


def test_torch_cli_vo_verbose_splits_spans_by_their_attribute():
    from cvsteer_tpu_torch.cli_vo import _labels

    ms = 1_000_000
    rec = [profiling.Span(0, "fleet.step", 0, 10 * ms, -1, dict(tick=0)),
           profiling.Span(1, "fleet.wait", ms, 2 * ms, 0, dict(fetch=1)),
           profiling.Span(2, "fleet.wait", 3 * ms, 5 * ms, 0, dict(fetch=2)),
           profiling.Span(3, "fleet.event", 5 * ms, 8 * ms, 0, dict(stream=3)),
           profiling.Span(4, "features.extract", 10 * ms, 14 * ms, -1, dict(frames=2, path="generic")),
           profiling.Span(5, "features.level", 10 * ms, 11 * ms, 4, dict(level=1)),
           profiling.Span(6, "features.level", 11 * ms, 12 * ms, 4, {})]  # the fused path's
    own = profiling.self_ms(rec, _labels)
    assert own == pytest.approx({
        "fleet.step": 4.0, "fleet.wait": 3.0, "fleet.wait[fetch=1]": 1.0, "fleet.wait[fetch=2]": 2.0,
        "fleet.event": 3.0, "fleet.event[stream=3]": 3.0, "features.extract": 2.0,
        "features.extract[path=generic]": 2.0, "features.level": 2.0, "features.level[level=1]": 1.0})

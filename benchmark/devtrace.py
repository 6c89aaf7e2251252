"""The traced window: torch.profiler around the benchmark's own spans, and
what the per-layer readers take from it.

The window is frozen from the port's ``utils/profiling.device_window``
(padded, primed and held to its launches): PRIMER_LAUNCHES small kernels
and WINDOW_PAD_S of idle time before the block, a synchronize and the pad
again after it, since kineto drops device events that its clock
conversion places outside its capture window and can give a process's
first kernels no device event. Every launch call made inside the block
must show its device events, or the run fails (no retake, no other
clock). The union of device intervals is chip_smoke.py's ``_busy``.

Spans are ``record_function`` ranges the harness opens around its calls
into the program (``SPAN_PREFIX`` + name); a device event belongs to the
span in which its launch call was made.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time
from typing import Dict, Iterator, List, Tuple

WINDOW_PAD_S = 0.2
PRIMER_LAUNCHES = 1000
SPAN_PREFIX = "bench."
_BLOCK = "bench_window"
LAUNCH_API = re.compile(
    r"^(cuda|cu)(Launch(Cooperative)?Kernel\w*|Memset\w*Async|Memcpy\w*Async|GraphLaunch)")


class ShortWindowError(RuntimeError):
    """A traced window saw no device event for some of its launches."""


class Launch:
    __slots__ = ("name", "ts", "corr", "span", "span_id", "events")

    def __init__(self, name, ts, corr):
        self.name, self.ts, self.corr = name, ts, corr
        self.span, self.span_id, self.events = None, None, []


class Trace:
    """What one traced window saw: ``window_s`` (host seconds of the
    block), ``spans`` {name: [(start_ns, end_ns), ...]}, ``launches`` (each
    with its span and its device events ``(name, start_ns, dur_ns)``)."""

    def __init__(self):
        self.window_s = 0.0
        self.block = (0, 0)
        self.spans: Dict[str, List[Tuple[int, int]]] = {}
        self.launches: List[Launch] = []

    # -- reductions the readers share --------------------------------------
    def device_events(self, span: str = None) -> list:
        return [e for ln in self.launches if span is None or ln.span == span for e in ln.events]

    def device_s(self, span: str = None) -> float:
        return sum(d for _, _, d in self.device_events(span)) / 1e9

    def busy_s(self) -> float:
        """The union of all device intervals (seconds)."""
        busy, end = 0, -float("inf")
        for a, b in sorted((s, s + d) for _, s, d in self.device_events()):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e9

    def graph_replays(self, span: str) -> List[List[Launch]]:
        """The CUDA graph launches of each instance of ``span``, in order."""
        per = collections.OrderedDict()
        for ln in self.launches:
            if ln.span == span and "GraphLaunch" in ln.name:
                per.setdefault(ln.span_id, []).append(ln)
        return list(per.values())

    def gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest idle stretches of the device inside the block, each
        named by the harness span the host was in at its midpoint
        ("between spans" outside every span)."""
        iv = sorted((s, s + d) for _, s, d in self.device_events())
        out, end = [], self.block[0]
        for a, b in iv + [(self.block[1], self.block[1])]:
            if a > end:
                out.append((a - end, (a + end) // 2))
            end = max(end, b)
        out.sort(reverse=True)
        return [(self.span_at(mid), gap / 1e9) for gap, mid in out[:top]]

    def span_at(self, ts: int) -> str:
        for name, rs in self.spans.items():
            for a, b in rs:
                if a <= ts <= b:
                    return name
        return "between spans"

    def top_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        dur = collections.Counter()
        for name, _, d in self.device_events():
            dur[name[:120]] += d / 1e9
        return [(k, v) for k, v in dur.most_common(top)]


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A harness span (a no-op outside a traced window)."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@contextlib.contextmanager
def traced() -> Iterator[Trace]:
    """torch.profiler (host and device) around the block, padded and primed;
    yields a Trace, filled when the block ends. Raises ShortWindowError when
    a launch made in the block shows no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Trace()
    primer = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            primer.zero_()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
        t0 = time.perf_counter()
        with record_function(_BLOCK):
            yield tr
            torch.cuda.synchronize()
        tr.window_s = time.perf_counter() - t0
        time.sleep(WINDOW_PAD_S)
    raw = prof.profiler.kineto_results.events()
    cpu = [e for e in raw if e.device_type() == DeviceType.CPU]
    blocks = [(e.start_ns(), e.end_ns()) for e in cpu if e.name() == _BLOCK]
    if len(blocks) != 1:
        raise RuntimeError(f"the profiler holds {len(blocks)} host ranges of the window, not 1")
    lo, hi = tr.block = blocks[0]
    inst = []  # (start, end, name, id) of every span instance
    for e in cpu:
        if e.name().startswith(SPAN_PREFIX) and lo <= e.start_ns() <= hi:
            name = e.name()[len(SPAN_PREFIX):]
            tr.spans.setdefault(name, []).append((e.start_ns(), e.end_ns()))
            inst.append((e.start_ns(), e.end_ns(), name, len(inst)))
    inst.sort()
    starts = [s for s, _, _, _ in inst]

    def owner(ts):  # spans do not nest: the latest one that started
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= inst[i][1]:
            return inst[i][2], inst[i][3]
        return None, None

    by_corr = {}
    for e in cpu:
        if lo <= e.start_ns() <= hi and LAUNCH_API.match(e.name()):
            ln = Launch(e.name(), e.start_ns(), e.correlation_id())
            ln.span, ln.span_id = owner(e.start_ns())
            tr.launches.append(ln)
            by_corr[ln.corr] = ln
    for e in raw:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ln = by_corr.get(e.correlation_id())
            if ln is not None:
                ln.events.append((e.name(), e.start_ns(), e.duration_ns()))
    unseen = [ln for ln in tr.launches if not ln.events]
    if unseen:
        raise ShortWindowError(
            f"the traced window saw no device event for {len(unseen)} of its "
            f"{len(tr.launches)} launches ({', '.join(sorted({ln.name for ln in unseen}))})")

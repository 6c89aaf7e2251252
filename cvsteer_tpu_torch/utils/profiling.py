"""The program's spans, the CUDA allocator's memory figures, and the port's
one device timer.

Spans (:class:`annotate`) are always on. Each records ``(name, start_ns,
end_ns, parent, attrs)`` into a bounded in-memory ring (RING_SIZE entries,
the oldest overwritten), stamped with ``time.time_ns()``: the host clock
kineto stamps its host events with, so the ring and a profiled window's
device events share one clock. ``parent`` is the enclosing span on the same
thread; ``attrs`` holds ints, floats and strs only, so a span keeps no
device memory alive. Only while a torch profiler records does a span also
open a profiler range (the C++ RecordFunction) and, on a card, an NVTX
range, so Chrome traces still show it. :func:`spans` reads the ring,
:func:`self_ms` sums self times by name, :func:`clear` empties it.

:func:`device_ms` and :func:`call_ms` are the timers that chip_smoke.py,
kernels/tile_sweep.py and cvsteer_tpu_torch.probes share, so their numbers
compare: ``device_ms`` is the device time of a call's kernels, read from
torch.profiler over 25 calls after warm-up with no L2 flush; ``call_ms``
is CUDA events around one call on an idle card, host work included.
Every profiled window (:func:`device_window`) is padded with idle time and
must see each of its launches' device events, or it raises
(:class:`ShortWindowError`). Without a CUDA device the memory figures are
empty and the timers raise.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import re
import threading
import time
from typing import Callable, Collection, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch


def _cuda() -> bool:
    return torch.cuda.is_available()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

#: entries the ring keeps; the oldest is overwritten
RING_SIZE = 65536
_ring: List[Optional[tuple]] = [None] * RING_SIZE
_next_index = itertools.count()  # next() is atomic under the interpreter lock
_ATTR_TYPES = (int, float, str)
_profiling = torch._C._autograd._profiler_enabled
#: the profiler's range: the C++ RecordFunction without the dispatcher op
#: that torch.profiler.record_function goes through (~1 us against ~18 us a
#: span on the card's host under the profiler), so kineto stamps it within
#: a microsecond of the span's own stamps
_range_type = torch._C._profiler._RecordFunctionFast


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: List[int] = []


_open = _OpenSpans()


class Span(NamedTuple):
    """One closed span: its index (the order spans opened in), name, host
    start and end (ns, ``time.time_ns()``), the index of the span that
    enclosed it on its thread (-1: none) and its attributes."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: dict


def _check_attrs(attrs: dict) -> None:
    for k, v in attrs.items():
        if type(v) not in _ATTR_TYPES:
            raise TypeError(f"span attribute {k} is a {type(v).__name__}: ints, floats and strs only")


class annotate:
    """A named span, recorded into the ring when it closes::

        with annotate("fleet.step", tick=k) as sp:
            ...
            sp.set(promoted=n)

    ``attrs`` (and :meth:`set`, :meth:`add`) take ints, floats and strs
    only. While a torch profiler records, the span is also a profiler
    range (a RecordFunction, as ``record_function`` opens) and, on a card,
    an NVTX range."""

    __slots__ = ("name", "attrs", "index", "parent", "start_ns", "_range")

    def __init__(self, name: str, **attrs):
        if attrs:
            _check_attrs(attrs)
        self.name, self.attrs, self._range = name, attrs, None

    def set(self, **attrs) -> None:
        _check_attrs(attrs)
        self.attrs.update(attrs)

    def add(self, **counts) -> None:
        """Add to counts (absent ones start at 0)."""
        _check_attrs(counts)
        for k, v in counts.items():
            self.attrs[k] = self.attrs.get(k, 0) + v

    def __enter__(self) -> "annotate":
        stack = _open.stack
        self.parent = stack[-1] if stack else -1
        self.index = next(_next_index)
        stack.append(self.index)
        if not _profiling():
            self.start_ns = time.time_ns()
            return self
        # kineto stamps its range as it opens and as it closes: the span's
        # own stamps sit just inside it, the NVTX range inside those
        self._range = _range_type(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        if _cuda():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is None:
            end = time.time_ns()
        else:
            if _cuda():
                torch.cuda.nvtx.range_pop()
            end = time.time_ns()
            self._range.__exit__(None, None, None)
            self._range = None
        _open.stack.pop()
        _ring[self.index % RING_SIZE] = (self.index, self.name, self.start_ns, end, self.parent,
                                         self.attrs)
        return False


def spans(until_ns: Optional[int] = None) -> List[Span]:
    """The closed spans the ring holds, in the order they opened; with
    ``until_ns``, only those that ended by then."""
    end = float("inf") if until_ns is None else until_ns
    out = [e for e in list(_ring) if e is not None and e[3] <= end]
    out.sort()  # by index: the ring is two sorted runs
    return [Span._make(e) for e in out]


def self_ms(recorded: Sequence[Span],
            labels: Callable[[Span], Iterable[str]] = lambda s: (s.name,)) -> Dict[str, float]:
    """The summed self time in ms (a span's duration less what its child
    spans cover) under each of its ``labels``: by default its name."""
    child = collections.Counter()
    for s in recorded:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    out = collections.defaultdict(float)
    for s in recorded:
        for label in labels(s):
            out[label] += (s.end_ns - s.start_ns - child[s.index]) / 1e6
    return dict(out)


def clear() -> None:
    """Empty the ring and number spans from 0 again (with none open)."""
    global _next_index
    _ring[:] = [None] * RING_SIZE
    _next_index = itertools.count()


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------


def device_memory_stats() -> dict:
    """Bytes the CUDA allocator holds for tensors on each card, now and at
    its peak: ``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}}``; empty
    without a card."""
    if not _cuda():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }
    return out


class MemoryHighWater:
    """Rolling high-water mark over :func:`device_memory_stats` samples:
    ``sample()`` after allocation-heavy moments; ``peak`` holds the per-card
    maximum of every field seen (nothing without a card)."""

    def __init__(self):
        self.peak: dict = {}
        self.samples = 0

    def sample(self) -> dict:
        cur = device_memory_stats()
        self.samples += 1
        for dev, fields in cur.items():
            slot = self.peak.setdefault(dev, {})
            for k, v in fields.items():
                slot[k] = max(slot.get(k, 0), v)
        return cur


# ---------------------------------------------------------------------------
# Device time
# ---------------------------------------------------------------------------

#: Idle host time a device window keeps before its first launch and after
#: its last synchronize (s). Kineto drops every device event whose start or
#: end, converted from the GPU's clock to the host's, falls outside the
#: profiler's capture window, and on the H100 that conversion wanders: a
#: window's first device event was seen from 6 ms before to 6.5 ms after
#: the launch call that made it (kernels/profiler_windows.py). Unpadded, a
#: window then lost its first launches, or all of them; 20 ms on each side
#: kept every event of 250 windows, and 0.2 s leaves room beyond what was
#: seen.
WINDOW_PAD_S = 0.2

#: Kernels a window launches before its pad and leaves out of what it
#: reports. The first kernels after the profiler starts can have no device
#: event, however long the pad: one a window when the card's modules load
#: eagerly, and in a long-lived process a number that grows with its age
#: (with 3 primers, windows of a process that kept the card busy lost none
#: until ~90 s, then one more launch about every 16 s, every other launch's
#: device event on time: kernels/profiler_windows.py --drift). A thousand
#: cost ~5 ms a window.
PRIMER_LAUNCHES = 1000
_BLOCK = "device_window"

#: the host-side runtime and driver calls that put work on a stream: each
#: has one correlation id that its device events (one, or a graph's many)
#: carry
LAUNCH_API = re.compile(r"^(cuda|cu)(Launch(Cooperative)?Kernel\w*|Memset\w*Async|Memcpy\w*Async|GraphLaunch)")


class ShortWindowError(RuntimeError):
    """A profiled window saw fewer device events than it made launches."""


def kernel_named(kernel: str, name: str) -> bool:
    """Whether a device event's (demangled or mangled) kernel name is the
    CUDA function ``name``."""
    return bool(re.search(rf"(?<![A-Za-z0-9_]){name}(?=[<(])", kernel)) or f"{len(name)}{name}E" in kernel


class DeviceWindow:
    """What one :func:`device_window` saw, filled when the block ends:
    ``events``, the device events (kineto's: kernels, memsets and copies;
    ``name()``, ``start_ns()``, ``duration_ns()``, ``correlation_id()``);
    ``launches``, the runtime's launch calls on the host (LAUNCH_API)."""

    def __init__(self):
        self.events: list = []
        self.launches: list = []

    def named(self, names: Sequence[str] = ()) -> list:
        """The device events of the CUDA functions ``names`` (all with none)."""
        if not names:
            return list(self.events)
        return [e for e in self.events if any(kernel_named(e.name(), nm) for nm in names)]

    def unseen(self) -> list:
        """The launch calls none of whose device events the window holds."""
        seen = {e.correlation_id() for e in self.events}
        return [e for e in self.launches if e.correlation_id() not in seen]

    def graph_events(self) -> list:
        """The device events each CUDA graph launch of the window carries
        (one count a launch, in order): a graph's kernels, memsets and
        copies, all under its launch's correlation id."""
        n = collections.Counter(e.correlation_id() for e in self.events)
        return [n[e.correlation_id()] for e in self.launches if "GraphLaunch" in e.name()]

    def lag_ms(self) -> Tuple[float, float]:
        """(least, greatest) time from a launch call to the start of its
        first device event (ms, on kineto's converted clock; nan without
        events): negative where the conversion puts the kernel before its
        launch."""
        first = {}
        for e in self.events:
            c = e.correlation_id()
            first[c] = min(first.get(c, e.start_ns()), e.start_ns())
        lags = [(first[e.correlation_id()] - e.start_ns()) / 1e6 for e in self.launches
                if e.correlation_id() in first]
        return (min(lags), max(lags)) if lags else (float("nan"), float("nan"))

    def check(self, names: Sequence[str] = (), want: Optional[int] = None,
              graphs: Optional[Collection[int]] = None) -> None:
        """Raise ShortWindowError unless every launch has its device events;
        for ``want``, exactly ``want`` events of ``names`` (of all events
        with no names); for ``graphs`` (the events per replay of each CUDA
        graph that may run in the window), every graph launch all the events
        of one of them."""
        unseen = self.unseen()
        if unseen:
            lo, hi = self.lag_ms()
            raise ShortWindowError(
                f"the profiler window saw no device event for {len(unseen)} of its {len(self.launches)} "
                f"launches ({', '.join(sorted({e.name() for e in unseen}))}; the others' first device "
                f"events {lo:.3f} to {hi:.3f} ms after their launch calls)")
        if want is not None:
            got = len(self.named(names))
            if got != want:
                what = f"of {tuple(names)}" if names else "in all"
                raise ShortWindowError(f"the profiler window saw {got} device events {what}, not {want}")
        if graphs is not None:
            short = [n for n in self.graph_events() if n not in graphs]
            if short:
                raise ShortWindowError(
                    f"the profiler window saw {len(short)} graph launches with {sorted(set(short))} "
                    f"device events; its graphs make {sorted(set(graphs))}")


@contextlib.contextmanager
def device_window() -> Iterator[DeviceWindow]:
    """torch.profiler (host and device) around the block: PRIMER_LAUNCHES
    small kernels, WINDOW_PAD_S of idle time, the block inside a host range,
    a synchronize, WINDOW_PAD_S again. Yields a DeviceWindow, filled when
    the block ends with the launch calls made inside the range and their
    device events (the primers' left out). Raises without a CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not _cuda():
        raise RuntimeError("device time needs a CUDA device")
    win = DeviceWindow()
    primer = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            primer.zero_()
        time.sleep(WINDOW_PAD_S)
        with record_function(_BLOCK):
            yield win
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    raw = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.end_ns()) for e in raw if e.device_type() == DeviceType.CPU and e.name() == _BLOCK]
    if len(spans) != 1:
        raise RuntimeError(f"device_window: the profiler holds {len(spans)} host ranges of the block, not 1")
    lo, hi = spans[0]
    win.launches = [e for e in raw if e.device_type() == DeviceType.CPU and LAUNCH_API.match(e.name())
                    and lo <= e.start_ns() <= hi]
    mine = {e.correlation_id() for e in win.launches}
    win.events = [e for e in raw if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                  and e.correlation_id() in mine]


def device_events(fn, names: Sequence[str] = (), reps: int = 25,
                  want: Optional[int] = None) -> Tuple[float, int]:
    """(summed device time in us, event count) of ``reps`` calls of ``fn``
    in one device_window: the kernels of the CUDA functions ``names``, or
    with no names every device kernel, memset and copy. Raises
    ShortWindowError unless every launch shows (and, given ``want``,
    exactly ``want`` of those events do)."""
    with device_window() as win:
        for _ in range(reps):
            fn()
    win.check(names, want)
    evts = win.named(names)
    return sum(e.duration_ns() for e in evts) / 1e3, len(evts)


def device_ms(fn, names: Sequence[str] = (), per_call: Optional[int] = None,
              reps: int = 25, events: Optional[int] = None) -> Tuple[float, float]:
    """Device time of one call of ``fn`` in ms, from ``reps`` calls after
    warm-up in one device_window. No L2 flush: on every path a kernel reads
    what the one before it has just written.

    With ``names`` (a hand-written kernel; ``per_call``, default 1, the
    launches of those CUDA functions one call makes): the summed duration of
    their events over ``reps``. Without names (a plain version, a library
    call, a graph replay): that of every device event; ``events``, where
    given, is the device events one call makes (a graph replay's: its
    kernels, memsets and copies). Either way the window must see every
    launch's device events, and exactly ``per_call * reps`` (or ``events *
    reps``) of the counted ones; a window that sees fewer raises
    ShortWindowError with both counts. Returns (ms, events per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    want = (per_call or 1) * reps if names else (events * reps if events is not None else None)
    total_us, n = device_events(fn, names, reps, want)
    return total_us / reps / 1e3, n / reps


def call_ms(fn, reps: int = 25) -> float:
    """What one call of ``fn`` costs a caller that waits for it: CUDA events
    around one call on an idle card, median of ``reps`` after warm-up, in ms.
    It includes the call's host work (wrapper checks, allocation, ctypes),
    so it is not a kernel time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]

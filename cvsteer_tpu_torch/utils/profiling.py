"""Profiling hooks on torch.profiler, and the port's one device timer.

The counterpart of cvsteer_tpu.utils.profiling: Chrome traces of a block
(:func:`trace_session`), named spans that show on the profiler's timeline
and as NVTX ranges (:func:`annotate`, :func:`step_annotation`), the CUDA
allocator's memory figures (:func:`device_memory_stats`,
:class:`MemoryHighWater`), and the device time of CUDA kernels by name
(:func:`trace_device_events`, :func:`trace_device_us`).

:func:`device_ms` and :func:`call_ms` are the timers that chip_smoke.py,
kernels/tile_sweep.py and cvsteer_tpu_torch.probes share, so their numbers
compare: ``device_ms`` is the device time of a call's kernels, read from
torch.profiler over 25 calls after warm-up with no L2 flush; ``call_ms``
is CUDA events around one call on an idle card, host work included.
Without a CUDA device the hooks do nothing and the timers raise.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import sys
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


@contextlib.contextmanager
def trace_session(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block and write ``<log_dir>/trace.json`` (a
    Chrome trace: host spans, and device kernels where there is a card).
    No-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _cuda() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span: a torch.profiler record_function, and an NVTX range
    where there is a card."""
    import torch

    nvtx = _cuda()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_annotation(name: str, step: Optional[int] = None):
    """The span of one step: ``name#step``."""
    return annotate(f"{name}#{step or 0}")


def device_memory_stats() -> dict:
    """Bytes the CUDA allocator holds for tensors on each card, now and at
    its peak: ``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}}``; empty
    without a card."""
    import torch

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


def device_time_attr() -> str:
    """The FunctionEvent attribute this torch names a device event's time
    under (``device_time_total``; ``cuda_time_total`` in older releases)."""
    from torch.autograd.profiler_util import FunctionEvent

    return "device_time_total" if hasattr(FunctionEvent, "device_time_total") else "cuda_time_total"


def kernel_named(kernel: str, name: str) -> bool:
    """Whether a device event's (demangled or mangled) kernel name is the
    CUDA function ``name``."""
    return bool(re.search(rf"(?<![A-Za-z0-9_]){name}(?=[<(])", kernel)) or f"{len(name)}{name}E" in kernel


def _device_events(run_once: Callable[[], object], reps: int):
    """The device events of ``reps`` calls of ``run_once`` inside
    torch.profiler: kernels, memsets and copies; the profiler's own
    annotations and every host event (the runtime's calls) never."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not _cuda():
        raise RuntimeError("device time needs a CUDA device")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_once()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_events(fn, names: Sequence[str] = (), reps: int = 25) -> Tuple[float, int]:
    """(summed device time in us, event count) of ``reps`` calls of ``fn``:
    the kernels of the CUDA functions ``names``, or with no names every
    device kernel, memset and copy."""
    attr = device_time_attr()
    total_us, n = 0.0, 0
    for evt in _device_events(fn, reps):
        if names and not any(kernel_named(evt.name, nm) for nm in names):
            continue
        total_us += getattr(evt, attr)
        n += 1
    return total_us, n


def trace_device_events(run_once, iters: int = 4) -> Dict[str, float]:
    """Device time by kernel name (us, summed over ``iters`` calls of
    ``run_once``): a Counter over every device kernel, memset and copy.
    Raises without a CUDA device. Divide by ``iters`` for per-call."""
    attr = device_time_attr()
    dur = collections.Counter()
    for evt in _device_events(run_once, iters):
        dur[evt.name] += getattr(evt, attr)
    return dur


def trace_device_us(run_once, iters: int = 4) -> float:
    """Total device us per ``run_once`` call (see trace_device_events)."""
    return sum(trace_device_events(run_once, iters).values()) / iters


def window_ms(fn, reps: int = 25) -> float:
    """CUDA events around ``reps`` back-to-back calls of ``fn``, per call
    (ms): the device time plus whatever gaps the host leaves between the
    calls' kernels."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, names: Sequence[str] = (), per_call: Optional[int] = None, reps: int = 25,
              tries: int = 5) -> Tuple[float, float]:
    """Device time of one call of ``fn`` in ms, from ``reps`` calls after
    warm-up inside torch.profiler. No L2 flush: on every path a kernel reads
    what the one before it has just written.

    A hand-written kernel (``names`` and ``per_call``, the CUDA launches
    one call makes): the mean duration of its kernel events times
    ``per_call``. The profiler now and then misses a device event of a
    window, so a window with fewer than ``per_call * reps`` events is taken
    again, up to ``tries`` times, and the fullest one is used. Without
    names (a plain version or a library call): the device time of every
    event in the first window that has any, over ``reps``.

    Now and then the profiler reports no device event at all for a window.
    Such a window is taken again; when all ``tries`` are empty the time is
    :func:`window_ms`'s (an upper bound of the device time), a note goes to
    stderr and the events seen per call are 0. Returns (ms, events seen per
    call)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = per_call or 1
    want = per_call * reps if names else 1
    best = (0.0, 0)
    for _ in range(tries):
        got = device_events(fn, names, reps)
        if got[0] > 0.0 and got[1] > best[1]:
            best = got
        if best[1] >= want:
            break
    total_us, n = best
    if n == 0:
        print(f"device_ms: torch.profiler reported no device time for {tuple(names) or 'the call'} "
              f"in {tries} windows; timed with CUDA events around the window", file=sys.stderr)
        return window_ms(fn, reps), 0.0
    if not names:
        return total_us / reps / 1e3, n / reps
    return total_us / n * per_call / 1e3, n / reps


def call_ms(fn, reps: int = 25) -> float:
    """What one call of ``fn`` costs a caller that waits for it: CUDA events
    around one call on an idle card, median of ``reps`` after warm-up, in ms.
    It includes the call's host work (wrapper checks, allocation, ctypes),
    so it is not a kernel time."""
    import torch

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

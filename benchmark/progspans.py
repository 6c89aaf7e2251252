"""The program's own spans, for the per-layer readers that take host time
from the program.

The program (cvsteer_tpu_torch.utils.profiling) records every span into an
in-memory ring, profiler or not, stamped with ``time.time_ns()``: the host
clock kineto stamps its events with, so ring times and the traced stretch's
device events compare. Host figures come from a fixed stretch of the
measured window, where no profiler runs: its ticks or batches OFFSET to
OFFSET + COUNT, counted from the window's first, the same work in every
run whatever the window's length (the window grows slower ticks as its
keyframes pile up). The traced stretch gives only the device's idle time
against the same spans. A program that keeps no ring, a window shorter
than OFFSET + COUNT, and a ring that lost a span the reader needs give
None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

#: the host readers' stretch: the window's ticks or batches OFFSET ..
#: OFFSET + COUNT - 1
OFFSET, COUNT = 50, 200


def recorded() -> Optional[list]:
    """The program's closed spans in the order they opened (``index``,
    ``name``, ``start_ns``, ``end_ns``, ``parent``, ``attrs``), or None
    where the program keeps no ring."""
    try:
        from cvsteer_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def window_calls(run) -> Optional[range]:
    """The run's numbers (0: its first tick or batch, warm-up included) of
    the stretch the host readers read; None where the window ran fewer than
    OFFSET + COUNT."""
    c = run.counters
    if "warmup_ticks" in c:
        first, n = c["warmup_ticks"], c.get("window_ticks", 0)
    else:
        first, n = run.traffic.get("warmup_batches"), c.get("window_batches", 0)
    if first is None or n < OFFSET + COUNT:
        return None
    return range(first + OFFSET, first + OFFSET + COUNT)


def fleet_steps(spans) -> List[Tuple[object, list]]:
    """Each ``fleet.step`` span with the ``fleet.wait`` spans inside it, in
    order."""
    root, waits, steps = {}, {}, []
    for s in spans:
        if s.name == "fleet.step":
            r = s.index
            steps.append(s)
            waits[r] = []
        else:
            r = root.get(s.parent)
            if r is None:
                continue
            if s.name == "fleet.wait":
                waits[r].append(s)
        root[s.index] = r
    return [(s, waits[s.index]) for s in steps]


def window_ticks(run) -> Optional[List[Tuple[object, int]]]:
    """The stretch's fleet ticks, by the ``fleet.step`` span's ``tick``:
    (fleet.step span, ns its fleet.wait spans cover)."""
    want, spans = window_calls(run), recorded()
    if want is None or spans is None:
        return None
    ticks = [(s, sum(w.end_ns - w.start_ns for w in ws)) for s, ws in fleet_steps(spans)
             if s.attrs.get("tick", -1) in want]
    return ticks if len(ticks) == COUNT else None


def window_extracts(run) -> Optional[list]:
    """The stretch's ``features.extract`` spans: the harness makes one call
    a tick or batch, so call k is the k-th of the run, counted where the
    ring still holds the run's first span."""
    want, spans = window_calls(run), recorded()
    if want is None or not spans or spans[0].index != 0:
        return None
    calls = [s for s in spans if s.name == "features.extract"]
    return calls[want.start: want.stop] if len(calls) >= want.stop else None


def host_pieces(step, waits) -> List[Tuple[int, int]]:
    """A fleet.step's interval less its fleet.wait spans."""
    out, cur = [], step.start_ns
    for w in sorted(waits, key=lambda w: w.start_ns):
        out.append((cur, w.start_ns))
        cur = w.end_ns
    out.append((cur, step.end_ns))
    return [(a, b) for a, b in out if b > a]


def busy_union(trace) -> List[Tuple[int, int]]:
    """The traced stretch's device intervals, merged (ns)."""
    merged = []
    for a, b in sorted((s, s + d) for _, s, d in trace.device_events()):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_within(pieces, busy) -> int:
    """ns of ``pieces`` (disjoint intervals) in which no device interval of
    ``busy`` (merged, sorted) runs."""
    starts = [a for a, _ in busy]
    idle = 0
    for a, b in pieces:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += (b - a) - covered
    return idle

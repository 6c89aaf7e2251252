"""fleet_host_idle_pct: the share of the fleet's own host time in which the
device is idle, in %: inside the traced stretch (``run.trace.block``), of
the ``fleet.step`` spans less their ``fleet.wait`` spans, the part no
device interval runs in. Read under the profiler, as ``device_idle_pct``
is; a share, since the profiler stretches that host time ~1.7x and the
idle time with it."""

from benchmark import progspans


def read(run):
    tr = run.trace
    spans = progspans.recorded()
    if tr is None or spans is None or not tr.launches:
        return None
    lo, hi = tr.block
    pieces = [p for s, ws in progspans.fleet_steps(spans) if lo <= s.start_ns and s.end_ns <= hi
              for p in progspans.host_pieces(s, ws)]
    host = sum(b - a for a, b in pieces)
    if not host:
        return None
    return 100.0 * progspans.idle_within(pieces, progspans.busy_union(tr)) / host

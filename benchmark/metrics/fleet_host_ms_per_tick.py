"""fleet_host_ms_per_tick: the fleet's own host time a tick, in ms: over
the measured window's ticks 50 to 249 (unprofiled; progspans), the mean
``fleet.step`` span less the ``fleet.wait`` spans inside it (the host
blocked on the fetches)."""

from benchmark import progspans


def read(run):
    ticks = progspans.window_ticks(run)
    if ticks is None:
        return None
    return sum(s.end_ns - s.start_ns - w for s, w in ticks) / len(ticks) / 1e6

"""fleet_wait_ms_per_tick: the host's time blocked on the fleet's fetches a
tick, in ms: over the measured window's ticks 50 to 249 (unprofiled;
progspans), the mean summed ``fleet.wait`` spans inside each
``fleet.step``."""

from benchmark import progspans


def read(run):
    ticks = progspans.window_ticks(run)
    if ticks is None:
        return None
    return sum(w for _, w in ticks) / len(ticks) / 1e6

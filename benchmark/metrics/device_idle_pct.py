"""device_idle_pct: the share of the traced window in which no operation
ran on the device (the union of device intervals, chip_smoke.py's
``_busy``), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.launches:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)

"""fp_row_use_pct: FP's useful rows, in %: over the measured window's ticks
50 to 249 (progspans), 100 x the streams that promoted over the stack rows
FP's replay computed, on the ticks where FP ran (``fleet.step``'s
``promoted`` and ``fp_rows``)."""

from benchmark import progspans


def read(run):
    ticks = progspans.window_ticks(run)
    if ticks is None:
        return None
    ran = [s.attrs for s, _ in ticks if s.attrs.get("fp_rows", 0) > 0]
    rows = sum(a["fp_rows"] for a in ran)
    if not rows:
        return None
    return 100.0 * sum(a["promoted"] for a in ran) / rows

"""Per-layer metric readers: one file per metric, ``read(run)`` returning a
number or None where the traced run holds nothing to read (benchmark/run.py
loads the file named after the metric). Shared reductions live here."""

from benchmark.devtrace import ShortWindowError


def graph_ms(run, k: int):
    """Mean device ms of the k-th CUDA graph launch of each step span that
    has one; raises when replays of that graph show different counts of
    device events (a replay the trace lost part of)."""
    tr = run.trace
    if tr is None:
        return None
    replays = [g[k] for g in tr.graph_replays("step") if len(g) > k]
    if not replays:
        return None
    counts = {len(r.events) for r in replays}
    if len(counts) != 1:
        raise ShortWindowError(f"graph launch {k} of a step: replays with {sorted(counts)} device events")
    return sum(d for r in replays for _, _, d in r.events) / 1e6 / len(replays)

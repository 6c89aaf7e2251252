"""frontend_host_ms_per_frame: the front-end's host time per frame, in ms:
over the ``features.extract`` spans of the measured window's ticks or
batches 50 to 249 (unprofiled; progspans), their summed duration over
their summed ``frames``."""

from benchmark import progspans


def read(run):
    calls = progspans.window_extracts(run)
    if calls is None:
        return None
    frames = sum(s.attrs.get("frames", 0) for s in calls)
    if not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) / frames / 1e6

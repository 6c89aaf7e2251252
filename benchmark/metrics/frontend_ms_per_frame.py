"""frontend_ms_per_frame: device ms of the traced window's extract_features
calls (every kernel, memset and copy they launched) per frame."""


def read(run):
    tr = run.trace
    if tr is None or not tr.spans.get("frontend") or not run.trace_frames:
        return None
    return 1e3 * tr.device_s("frontend") / run.trace_frames

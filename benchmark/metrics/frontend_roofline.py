"""frontend_roofline: the front-end's least time (benchmark.work: bytes
over HBM bandwidth or flops over the float32 peak, whichever is larger,
from the configuration's shapes) over the device time of every kernel,
memset and copy that the traced window's extract_features calls launched,
whatever implements them, in %."""

from benchmark import harness


def read(run):
    tr = run.trace
    calls = len(tr.spans.get("frontend", [])) if tr is not None else 0
    dev_s = tr.device_s("frontend") if calls else 0.0
    if not calls or dev_s <= 0:
        return None
    return 100.0 * harness.frontend_work(run)["least_s"] * calls / dev_s

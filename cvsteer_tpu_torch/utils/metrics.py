"""Host-side metrics and per-phase timing (twin of cvsteer_tpu.utils.metrics).

:class:`Metrics` records counters, gauges and a frames/s meter and writes
structured JSON log lines from rank 0 only. :class:`StepTimer` accumulates
the wall time of named spans. On the card PyTorch returns before the
device finishes, so a span that is to measure device work synchronizes the
device at both ends: pass ``sync=torch.cuda.synchronize`` for that. Both
read the host clock; neither names a device metric.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, TextIO


def _is_host_zero() -> bool:
    """Rank 0 of an initialized torch.distributed group; true otherwise."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class Metrics:
    """Counters, gauges and a frames/s meter since construction."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._frames = 0
        self.stream = stream if stream is not None else sys.stderr

    def count(self, name: str, n: float = 1.0) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def frame(self, n: int = 1) -> None:
        self._frames += n

    @property
    def fps(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._frames / dt if dt > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.counters)
        out.update(self.gauges)
        out["fps"] = round(self.fps, 2)
        out["uptime_s"] = round(time.perf_counter() - self._t0, 3)
        return out

    def log(self, step: Optional[int] = None, **extra) -> None:
        """Write one JSON log line (rank 0 only)."""
        if not _is_host_zero():
            return
        rec = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = step
        rec.update(self.snapshot())
        rec.update(extra)
        print(json.dumps(rec), file=self.stream)


class StepTimer:
    """Accumulates the wall time of named spans."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.total_s[name] += time.perf_counter() - t0
            self.count[name] += 1

    def means_ms(self) -> Dict[str, float]:
        return {k: 1e3 * v / self.count[k] for k, v in self.total_s.items()}

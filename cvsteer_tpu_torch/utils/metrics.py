"""Per-phase wall-clock timing (the StepTimer of cvsteer_tpu.utils.metrics).

On the card PyTorch returns before the device finishes, so a span that is
to measure device work synchronizes the device at both ends: pass
``sync=torch.cuda.synchronize`` for that. Timing is a host clock either
way; it names no device metric.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


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

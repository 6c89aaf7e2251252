"""The multi-process runtime: joining the world, a barrier, a cross-rank
checksum and a heartbeat with a failure callback (the twin of
cvsteer_tpu.parallel.multihost, in torchrun's terms).

- :func:`initialize_distributed` joins the default process group from
  arguments or torchrun's environment (``MASTER_ADDR``:``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``); a no-op for a run that is one process.
- :func:`device_barrier` all-reduces a ones token on this rank's device:
  the world's sum, or 1.0 with no process group.
- :func:`allreduce_checksum`: the sum of |x| over every rank's shard, the
  same on every rank: a replicated value whose checksum differs from the
  one recomputed locally shows that the ranks' states diverged.
- :class:`Heartbeat`: a barrier every ``interval_s`` on a daemon thread,
  over a gloo group of its own (so it never interleaves with the main
  thread's collectives); a probe that misses its deadline, or fails, fires
  ``on_failure`` once (checkpoint and exit: the recovery is a restart from
  the checkpoint).
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

from cvsteer_tpu_torch.parallel import halo
from cvsteer_tpu_torch.parallel.mesh import _set_device, backend_for


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
) -> bool:
    """Join the default process group; True when the world has more than
    one process.

    ``coordinator_address`` ("host:port") falls back to ``MASTER_ADDR``:
    ``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``, ``process_id`` to
    ``RANK``. With no address anywhere this is a no-op that returns False;
    with a group already joined it returns whether that world has more than
    one process. ``device_type`` "cuda" (this rank on ``cuda:{LOCAL_RANK %
    device_count}``; raises without a card) or "cpu"; the backend is
    parallel.mesh.backend_for's."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return False
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; pass device_type='cpu' "
                               "to run on the CPU")
        _set_device()
    n = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend_for(device_type), init_method=f"tcp://{coordinator_address}",
                            world_size=n, rank=rank)
    return n > 1


def _rank_device() -> torch.device:
    """This rank's card when it has one in use, else the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_barrier(group: Optional[dist.ProcessGroup] = None) -> float:
    """Block until every rank of ``group`` (the world by default) has
    joined; returns the summed ones token (the rank count), 1.0 with no
    process group."""
    token = torch.ones(1, device=_rank_device())
    if not dist.is_initialized():
        return float(token)
    return float(halo.all_reduce_sum(token, group or dist.group.WORLD))


def allreduce_checksum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of |x| over every rank's shard ``x`` (float64 for a float64
    ``x``, else float32), the same on every rank of ``group``."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return halo.all_reduce_sum(x.abs().sum(dtype=dtype), group)


class Heartbeat:
    """A liveness probe every ``interval_s`` with a failure callback.

    Each probe all-reduces a CPU token over a gloo group made for the
    heartbeat, with its own timeout ``timeout_s`` (directly, not through
    parallel.halo: the probe thread stays out of the main thread's
    collective log); when it fails or does not complete within
    ``timeout_s`` (a rank dropped out), ``on_failure`` fires once and the
    probing ends. Construct it on every rank at the same point (making its
    group is a collective). :meth:`stop` ends the probing of
    every rank at the same probe: it asks, and the ranks stop after the
    first probe that carries the request, so no rank is left in a probe its
    peers never join. With no process group each probe passes at once."""

    def __init__(
        self,
        interval_s: float = 30.0,
        timeout_s: float = 120.0,
        on_failure: Optional[Callable[[], None]] = None,
    ):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.on_failure = on_failure
        self.beats = 0
        self.failed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._group = None
        if dist.is_initialized():
            self._group = dist.new_group(backend="gloo",
                                         timeout=datetime.timedelta(seconds=timeout_s))

    def _probe_once(self):
        """(passed within the deadline, a rank asked to stop)."""
        done = threading.Event()
        out = {}

        def probe():
            try:
                token = torch.tensor([1.0, float(self._stop.is_set())])
                if self._group is not None:
                    dist.all_reduce(token, group=self._group)
                out["stop"] = bool(token[1] > 0)
            except Exception:  # a dead peer resets the connection: a missed probe
                pass
            finally:
                done.set()

        threading.Thread(target=probe, daemon=True).start()
        return done.wait(self.timeout_s) and "stop" in out, out.get("stop", False)

    def _loop(self):
        while True:
            self._stop.wait(self.interval_s)
            ok, stop = self._probe_once()
            if not ok:
                self.failed = True
                if self.on_failure is not None:
                    self.on_failure()
                return
            self.beats += 1
            if stop:
                return

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Ask every rank to stop, and wait (up to ``timeout_s``) for this
        rank's probing to end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s)

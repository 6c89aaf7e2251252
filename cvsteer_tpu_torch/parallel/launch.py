"""A world of ranks on one host, spawned from Python: what the tests and
the card's smoke run use where a user would launch with torchrun.

``spawn_world(fn, n)`` starts ``n`` processes (the spawn start method, so
nothing of the parent's state leaks in), gives each torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), joins the
default process group, calls ``fn(rank, *args)`` and returns every rank's
result in rank order. The backend is parallel.mesh.backend_for's rule; the
group joins through a FileStore in a private directory. The ranks run on
the card (``cuda:{rank % device_count}``) unless the caller asks for the
CPU. A rank that raises fails the call: the others are stopped and the
error re-raised.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cvsteer_tpu_torch.parallel.mesh import backend_for


def _rank_entry(rank, fn, nprocs, args, workdir, device_type, timeout_s):
    torch.set_num_threads(1)  # the ranks share the host's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.cuda.init()
    dist.init_process_group(
        backend_for(device_type), store=dist.FileStore(os.path.join(workdir, "store"), nprocs),
        rank=rank, world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        out = fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_world(fn: Callable, nprocs: int, args: Sequence = (), *, device_type: str = "cuda",
                timeout_s: float = 300.0, workdir: Optional[str] = None) -> List:
    """``[fn(rank, *args) for rank in range(nprocs)]``, each in a process of
    its own (one intra-op thread) joined into one world; ``fn`` must be
    picklable (a module-level function). ``timeout_s``: the collectives'
    timeout."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    with tempfile.TemporaryDirectory(prefix="cvsteer_world_", dir=workdir) as tmp:
        mp.start_processes(
            _rank_entry,
            args=(fn, nprocs, tuple(args), tmp, device_type, timeout_s),
            nprocs=nprocs, start_method="spawn",
        )
        out = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

"""Ring halo exchange for spatially sharded convolution, and the transport
every sharded path's collectives go through (the twin of
cvsteer_tpu.parallel.halo).

When image rows are sharded over a mesh axis, each rank needs ``radius``
boundary rows from its neighbours to compute a (2 radius + 1)-tap
convolution without a seam. The neighbour transfers are one
``dist.batch_isend_irecv`` on the axis's process group; the global image
borders use REFLECT_101 (the OpenCV sepFilter2D default the goldens were
produced with).

Transport: torch's gloo backend does not list CUDA tensors for send, recv
or all_gather, so under gloo every collective on a CUDA tensor is staged
through host memory here: the device queue is drained, the tensor copied
to the host, the collective run, the result copied back. The math stays on
the card. Under NCCL the tensors go as they are. :data:`transport_stats`
sums the staged calls' host seconds and bytes, so a run can state what
share of a sharded call the staging took. Inside
:func:`record_collectives` every collective, staged or not, is listed as
(op, elements): what a run checks its collective count against (the
reference read the same count from the compiled HLO).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: Staged transport since the last :func:`reset_transport_stats`: calls,
#: host seconds (device queue drained first, so no compute is counted) and
#: bytes sent from this rank.
transport_stats = {"calls": 0, "seconds": 0.0, "bytes": 0}

# the list record_collectives installed (None: nothing is recorded)
_recording: Optional[List[Tuple[str, int]]] = None

# tags of the two halo directions: both neighbours are one rank at a space
# size of 2, so a message says which halo it fills
_TAG_TOP, _TAG_BOTTOM = 1, 2


def reset_transport_stats() -> None:
    transport_stats.update(calls=0, seconds=0.0, bytes=0)


@contextlib.contextmanager
def record_collectives():
    """Yields a list that gains one (op, elements of this rank's input)
    entry per call of :func:`all_gather`, :func:`gather`,
    :func:`all_reduce_sum`, :func:`exchange` (the elements sent) and
    :func:`all_gather_object` (one object) made inside the block. A call
    over no group (a group of one by convention) is no collective and is
    not listed. Outside such a block nothing is recorded."""
    global _recording
    outer, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = outer


def _log(op: str, elements: int) -> None:
    if _recording is not None:
        _recording.append((op, elements))


def staged(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> bool:
    """Whether a collective on ``t`` over ``group`` stages through the host
    (a CUDA tensor under gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Staging:
    """Host staging of one collective: ``host(t)`` gives the tensor to
    hand to gloo, ``back(t)`` returns a result to the device; the host time
    and bytes go into :data:`transport_stats`."""

    def __init__(self, like: torch.Tensor, group):
        self.on = staged(like, group)
        self.device = like.device

    def __enter__(self):
        if self.on:
            torch.cuda.current_stream(self.device).synchronize()
            self.t0 = time.perf_counter()
        return self

    def host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return t.contiguous()
        transport_stats["bytes"] += t.numel() * t.element_size()
        return t.cpu()

    def empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="cpu" if self.on else self.device)

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.on else t

    def __exit__(self, *exc):
        if self.on and exc[0] is None:
            transport_stats["calls"] += 1
            transport_stats["seconds"] += time.perf_counter() - self.t0


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on all ranks), in group-rank order;
    ``group`` None is a group of one."""
    if group is None:
        return [t]
    _log("all_gather", t.numel())
    with _Staging(t, group) as st:
        buf = st.host(t)
        out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, buf, group=group)
        return [st.back(o) for o in out]


def gather(t: torch.Tensor, dst: int, group) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` on group rank ``dst`` (None on the others)."""
    if group is None:
        return [t]
    _log("gather", t.numel())
    with _Staging(t, group) as st:
        buf = st.host(t)
        me = dist.get_rank(group)
        out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))] if me == dst else None
        dist.gather(buf, out, group_dst=dst, group=group)
        return None if out is None else [st.back(o) for o in out]


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``."""
    if group is None:
        return t
    _log("all_reduce", t.numel())
    with _Staging(t, group) as st:
        buf = st.host(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return st.back(buf)


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[Tuple[int, ...], int, int]],
             like: torch.Tensor, group) -> List[torch.Tensor]:
    """Point-to-point transfers in one ``batch_isend_irecv``: ``sends``
    (tensor, group-rank peer, tag), ``recvs`` (shape, group-rank peer, tag)
    of ``like``'s dtype; returns the received tensors on ``like``'s
    device."""
    _log("exchange", sum(t.numel() for t, _, _ in sends))
    with _Staging(like, group) as st:
        ops, out = [], []
        for t, peer, tag in sends:
            ops.append(dist.P2POp(dist.isend, st.host(t), dist.get_global_rank(group, peer),
                                  group=group, tag=tag))
        for shape, peer, tag in recvs:
            buf = st.empty(shape, like.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer),
                                  group=group, tag=tag))
            out.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [st.back(b) for b in out]


def all_gather_object(obj, group) -> list:
    """Every rank's picklable ``obj``, in group-rank order (no staging: the
    pickles travel on the host under gloo, on the current card under
    NCCL)."""
    if group is None:
        return [obj]
    _log("all_gather_object", 1)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _reflect101_top(x: torch.Tensor, r: int) -> torch.Tensor:
    """REFLECT_101 halo above row 0: rows r, r-1, ..., 1 (row 0 not repeated)."""
    return x[..., 1 : r + 1, :].flip(-2)


def _reflect101_bottom(x: torch.Tensor, r: int) -> torch.Tensor:
    """REFLECT_101 halo below the last row: rows -2, -3, ..., -(r+1)."""
    return x[..., -(r + 1) : -1, :].flip(-2)


def halo_exchange_rows(x: torch.Tensor, radius: int, group) -> torch.Tensor:
    """Return ``x`` extended with ``radius`` halo rows above and below.

    ``x``: this rank's row block ``[..., h_local, W]`` of an image whose
    rows are sharded over ``group`` (group rank 0 holds the top; None is a
    group of one). Interior halos come from the neighbours; the first and
    last ranks make their outer halo with REFLECT_101 (so nothing crosses
    the ring's wrap-around edge). Requires ``h_local > radius``."""
    r = int(radius)
    if r == 0:
        return x
    if x.shape[-2] <= r:
        raise ValueError(f"halo_exchange_rows: {x.shape[-2]} rows <= radius {r}")
    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    shape = tuple(x.shape[:-2]) + (r, x.shape[-1])
    sends, recvs, slots = [], [], []
    if idx > 0:  # my top rows are the previous rank's bottom halo
        sends.append((x[..., :r, :], idx - 1, _TAG_BOTTOM))
        recvs.append((shape, idx - 1, _TAG_TOP))
        slots.append("top")
    if idx < n - 1:  # my bottom rows are the next rank's top halo
        sends.append((x[..., -r:, :], idx + 1, _TAG_TOP))
        recvs.append((shape, idx + 1, _TAG_BOTTOM))
        slots.append("bottom")
    got = dict(zip(slots, exchange(sends, recvs, x, group))) if sends else {}
    top = got["top"] if idx > 0 else _reflect101_top(x, r)
    bottom = got["bottom"] if idx < n - 1 else _reflect101_bottom(x, r)
    return torch.cat([top, x, bottom], dim=-2)

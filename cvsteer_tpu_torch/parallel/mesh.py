"""Mesh construction over torch.distributed (the twin of
cvsteer_tpu.parallel.mesh).

JAX's mesh is one controller's named grid of devices; here a mesh is a
``DeviceMesh`` over the ranks of the default process group, one process per
rank, and the world size plays the part of JAX's device count. A run of
several ranks is launched by torchrun (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) or by a
caller that has already initialized the default group; with neither, the
world is this one process and :func:`make_mesh` sets up a 1-rank group
itself.

The backend follows a rule: NCCL when every rank of a host has a card of
its own, gloo otherwise (every CPU run, and several ranks sharing one
card: NCCL refuses two ranks on one GPU). Collectives on CUDA tensors
under gloo stage through host memory (parallel.halo).
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def backend_for(device_type: str) -> str:
    """The process-group backend for ranks on ``device_type``: gloo on the
    CPU; on CUDA, NCCL when each rank of this host has a card of its own
    (``LOCAL_WORLD_SIZE`` <= the cards), else gloo."""
    if device_type == "cpu":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def _set_device() -> None:
    """This rank's card, ``cuda:{LOCAL_RANK % device_count}``, made current
    and initialized (so DeviceMesh keeps it rather than pick by LOCAL_RANK)."""
    torch.cuda.set_device(_env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    torch.cuda.init()


def _init_world(device_type: str) -> None:
    """Join torchrun's world (``WORLD_SIZE`` set), or make a 1-rank one."""
    if device_type == "cuda":
        _set_device()
    backend = backend_for(device_type)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axes: Mapping[str, int], device_type: str = "cuda") -> DeviceMesh:
    """Build a named mesh over the world, e.g. ``make_mesh({"data": 4,
    "space": 2})``.

    Axis sizes must multiply to the world size. An axis size of -1 is
    inferred (at most one). ``device_type`` is ``"cuda"`` (each rank on
    ``cuda:{LOCAL_RANK % device_count}``) unless the caller asks for
    ``"cpu"``; without a GPU, ``"cuda"`` raises."""
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' to run on the CPU")
    n = _world_size()
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    if not dist.is_initialized():
        _init_world(device_type)
    elif device_type == "cuda":
        _set_device()
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_axis(mesh: DeviceMesh, name: Optional[str]) -> Tuple[int, int, Optional[dist.ProcessGroup]]:
    """(size, this rank's index, process group) of axis ``name``; (1, 0,
    None) when the mesh has no such axis."""
    if name is None or name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name), mesh.get_group(name)


def sharded_axis(mesh: DeviceMesh, name: str) -> Tuple[int, int, dist.ProcessGroup]:
    """:func:`mesh_axis` of the axis a call shards over: a ValueError when
    the mesh has no such axis (never a silent unsharded run)."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {name!r}: {mesh.mesh_dim_names}")
    return mesh_axis(mesh, name)

"""Batch- and row-sharded steerable front-end over a mesh (the twin of
cvsteer_tpu.parallel.frontend_sharded).

The image batch is sharded over the ``data`` mesh axis and image rows over
the ``space`` axis; the separable convolution's row overlap comes from a
ring halo exchange (parallel.halo). All per-pixel math after the bank is
local, so a rank's block is bit for bit the same rows of the single-device
pipeline's result: the bank is ops.sepconv.filter_bank_xla, the
shift-and-add loop whose sums run in kernel A's order.

The reference's shard_map is one controller over many devices; here every
rank runs these functions. Every rank is called with the same full host
batch ``[B, H, W]``; :func:`shard_batch` returns this rank's ``(data,
space)`` block on its device, the ``sharded_*`` functions map a block to
its result block, and :func:`gather_blocks` rebuilds the full result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.filters import g4 as fg4
from cvsteer_tpu_torch.ops.sepconv import filter_bank_xla
from cvsteer_tpu_torch.parallel import halo
from cvsteer_tpu_torch.parallel.halo import halo_exchange_rows
from cvsteer_tpu_torch.parallel.mesh import mesh_axis, rank_device


def _bank_local(block: torch.Tensor, xtaps, ytaps, mesh, space_axis) -> torch.Tensor:
    """The bank of a row block ``[b, h, W]``: halo rows from the
    neighbours when the mesh has ``space_axis``, else plain REFLECT_101
    padding."""
    group = mesh_axis(mesh, space_axis)[2]
    if group is None:
        return filter_bank_xla(block, xtaps, ytaps)
    r = (np.asarray(xtaps).shape[1] - 1) // 2
    haloed = halo_exchange_rows(block, r, group)
    return filter_bank_xla(haloed, xtaps, ytaps, pad_axes=(False, True))


def _maps_from_magnitude_phase(magnitude, phase):
    return (
        fg2.find_edges(magnitude, phase),
        fg2.find_dark_lines(magnitude, phase),
        fg2.find_bright_lines(magnitude, phase),
    )


def _g2_maps_local(basis: torch.Tensor):
    """(edges, dark, bright) of a G2/H2 basis block."""
    _, c2, c3 = fg2.energy_coefficients(basis)
    theta, _ = fg2.dominant_orientation(c2, c3)
    return _maps_from_magnitude_phase(*fg2.magnitude_phase(*fg2.steer(basis, theta)))


def _g4_maps_local(basis: torch.Tensor):
    """(edges, dark, bright) of a G4/H4 basis block: the G2 extractors fed
    the G4/H4 magnitude, as the single-device G4 path does."""
    _, c2, c3 = fg4.energy_coefficients(basis)
    theta, _ = fg4.dominant_orientation(c2, c3)
    return _maps_from_magnitude_phase(*fg4.magnitude_phase(*fg4.steer(basis, theta)))


def sharded_g2_maps(
    block: torch.Tensor,
    mesh,
    bank: Optional[fg2.G2Bank] = None,
    *,
    data_axis: str = "data",
    space_axis: Optional[str] = "space",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(edges, lines_dark, lines_bright) of this rank's block (from
    :func:`shard_batch`) of a batch ``[B, H, W]``; each row block must be
    taller than the kernel radius. ``data_axis`` is the reference's
    signature: a rank's block already is its data slice."""
    bank = fg2.g2_bank() if bank is None else bank
    return _g2_maps_local(_bank_local(block, bank.xtaps, bank.ytaps, mesh, space_axis))


def sharded_g4_maps(
    block: torch.Tensor,
    mesh,
    bank: Optional[fg4.G4Bank] = None,
    *,
    data_axis: str = "data",
    space_axis: Optional[str] = "space",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """G4/H4 analog of :func:`sharded_g2_maps` (cli --mesh --filters g4)."""
    bank = fg4.g4_bank() if bank is None else bank
    return _g4_maps_local(_bank_local(block, bank.xtaps, bank.ytaps, mesh, space_axis))


def sharded_filter_bank(
    block: torch.Tensor,
    xtaps,
    ytaps,
    mesh,
    *,
    data_axis: str = "data",
    space_axis: Optional[str] = "space",
) -> torch.Tensor:
    """Any separable tap bank over a mesh: this rank's block ``[b, h, W]``
    -> ``[b, K, h, W]``, bit for bit the same rows of the single-device
    filter_bank_xla result."""
    return _bank_local(block, xtaps, ytaps, mesh, space_axis)


def shard_batch(images, mesh, data_axis: str = "data", space_axis: str = "space") -> torch.Tensor:
    """This rank's block of a host batch ``images [B, H, W]`` (numpy or
    torch, the same on every rank) on this rank's device: batch over
    ``data_axis``, rows over ``space_axis``, each where the mesh has it."""
    images = torch.as_tensor(images)
    B, H = images.shape[:2]
    nd, d, _ = mesh_axis(mesh, data_axis)
    ns, s, _ = mesh_axis(mesh, space_axis)
    if B % nd or H % ns:
        raise ValueError(f"batch {B} x rows {H} does not shard over data={nd}, space={ns}")
    b, h = B // nd, H // ns
    return images[d * b : (d + 1) * b, s * h : (s + 1) * h].to(rank_device(mesh)).contiguous()


def gather_blocks(block, mesh, *, row_dim: Optional[int] = -2, dst: int = 0,
                  data_axis: str = "data", space_axis: str = "space"):
    """The full result from every rank's block, on global rank ``dst`` (the
    others get None): blocks concatenated over ``space`` along ``row_dim``
    (None: the result is replicated over ``space``, and space rank 0's is
    taken), then over ``data`` along dim 0. ``block`` is a tensor or a
    tuple (a NamedTuple included) of them."""
    if isinstance(block, tuple):
        parts = [gather_blocks(t, mesh, row_dim=row_dim, dst=dst, data_axis=data_axis,
                               space_axis=space_axis) for t in block]
        if parts[0] is None:
            return None
        return type(block)(*parts) if hasattr(block, "_fields") else tuple(parts)
    nd, _, _ = mesh_axis(mesh, data_axis)
    ns, _, _ = mesh_axis(mesh, space_axis)
    names = tuple(mesh.mesh_dim_names)
    every = halo.gather(block, dst, dist.group.WORLD)  # indexed by global rank
    if every is None:
        return None
    grid = {}  # (data, space) coordinates -> that rank's block
    for pos, rank in enumerate(mesh.mesh.flatten().tolist()):
        c = dict(zip(names, np.unravel_index(pos, tuple(mesh.mesh.shape))))
        grid[(int(c.get(data_axis, 0)), int(c.get(space_axis, 0)))] = every[rank]
    rows = [
        grid[(d, 0)] if row_dim is None else torch.cat([grid[(d, s)] for s in range(ns)], row_dim)
        for d in range(nd)
    ]
    return torch.cat(rows, 0)

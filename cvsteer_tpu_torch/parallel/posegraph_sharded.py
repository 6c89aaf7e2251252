"""Edge-sharded pose-graph optimization over a mesh axis (the twin of
cvsteer_tpu.parallel.posegraph_sharded).

Each rank of the ``edge_axis`` group holds an E/n slice of the edge list (a
map block's constraints) and every pose. The normal matrix is never built:
the matrix-free Jacobi-PCG of slam.posegraph sums over the ranks one [P, 6]
Hv product per CG iteration, the right-hand side and the Jacobi blocks once
per LM iteration, and each cost (``group``). The traffic does not grow with
the edges.

Every rank is called with the whole graph and cuts its own slice (or with
:func:`place_pose_graph`'s slice); the poses come back the same on every
rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cvsteer_tpu_torch.parallel.mesh import rank_device, sharded_axis
from cvsteer_tpu_torch.slam.posegraph import PGOStats, PoseGraph, Poses, optimize_pose_graph


class EdgeShard(PoseGraph):
    """One rank's edge slice of a padded PoseGraph (``fixed`` whole), as
    :func:`place_pose_graph` returns it."""

    __slots__ = ()


def pad_edges(graph: PoseGraph, num_shards: int) -> PoseGraph:
    """The edge list padded to a multiple of ``num_shards`` with weight-0
    edges (0 -> 0, identity measurement)."""
    E = graph.i.shape[0]
    pad = -(-E // num_shards) * num_shards - E
    if pad == 0:
        return graph

    def zeros(a, *shape):
        return torch.zeros((pad,) + shape, dtype=a.dtype, device=a.device)

    eye = torch.eye(3, dtype=graph.R_z.dtype, device=graph.R_z.device).expand(pad, 3, 3)
    return PoseGraph(
        i=torch.cat([graph.i, zeros(graph.i)]), j=torch.cat([graph.j, zeros(graph.j)]),
        R_z=torch.cat([graph.R_z, eye]), t_z=torch.cat([graph.t_z, zeros(graph.t_z, 3)]),
        weight=torch.cat([graph.weight, zeros(graph.weight)]), fixed=graph.fixed,
    )


def place_pose_graph(graph: PoseGraph, mesh, edge_axis: str = "data") -> EdgeShard:
    """The graph padded to the shard count, this rank's edge slice on its
    device (an :class:`EdgeShard`)."""
    n, idx, _ = sharded_axis(mesh, edge_axis)
    graph = pad_edges(graph, n)
    El = graph.i.shape[0] // n
    dev = rank_device(mesh)
    sl = slice(idx * El, (idx + 1) * El)
    return EdgeShard(*(a.to(dev) if f == "fixed" else a[sl].to(dev).contiguous()
                       for f, a in zip(graph._fields, graph)))


def optimize_pose_graph_sharded(
    poses: Poses,
    graph: PoseGraph,
    mesh,
    *,
    edge_axis: str = "data",
    iterations: int = 20,
    lam0: float = 1e-6,
    cg_iterations: int = 50,
) -> Tuple[Poses, PGOStats]:
    """LM-PCG pose-graph optimization with the edges sharded over
    ``edge_axis`` of ``mesh``; every rank of the mesh calls it with the
    whole graph or its :func:`place_pose_graph` slice, and gets the same
    poses and summed costs."""
    _, _, group = sharded_axis(mesh, edge_axis)
    if not isinstance(graph, EdgeShard):
        graph = place_pose_graph(graph, mesh, edge_axis)
    dev = rank_device(mesh)
    return optimize_pose_graph(
        Poses(poses.R.to(dev), poses.t.to(dev)), PoseGraph(*graph), iterations=iterations,
        lam0=lam0, solver="pcg", cg_iterations=cg_iterations, group=group,
    )

"""Sim(3) pose-graph optimization: scale-drift-aware monocular closures
(twin of cvsteer_tpu.slam.posegraph_sim3).

Each pose carries a 7th degree of freedom, its local map scale, and edges
measure relative similarities; after optimization the per-pose scales
rescale the local maps (Strasdat-style). The solvers are slam.posegraph's
with dof 7: a dense Cholesky of the [7P, 7P] system and matrix-free
Jacobi-PCG, under the same LM loop.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cvsteer_tpu_torch.slam import lie_lanes as ll
from cvsteer_tpu_torch.slam import sim3
from cvsteer_tpu_torch.slam.posegraph import (
    _dense_core,
    _edge_jacobians,
    _lm,
    _pcg_core,
    _robust_cost,
    _robust_weight,
)
from cvsteer_tpu_torch.slam.sim3 import Sim3
from cvsteer_tpu_torch.utils.precision import precise


class Sim3Graph(NamedTuple):
    """Masked fixed-size Sim(3) pose graph.

    i, j:    [E] edge endpoints; measurement Z_ij ~ T_j o T_i^{-1}.
    s_z:     [E] relative scales; R_z [E, 3, 3]; t_z [E, 3].
    weight:  [E] edge weights (0 = padding).
    fixed:   [P] poses held constant (gauge: anchor pose and scale).
    """

    i: torch.Tensor
    j: torch.Tensor
    s_z: torch.Tensor
    R_z: torch.Tensor
    t_z: torch.Tensor
    weight: torch.Tensor
    fixed: torch.Tensor


class Sim3Stats(NamedTuple):
    cost: torch.Tensor
    initial_cost: torch.Tensor
    lambda_final: torch.Tensor


def _residual_fn(poses: Sim3, graph: Sim3Graph):
    """Residual closure res(xi_i, xi_j) -> [E, 7] in the sim3.exp chart
    (omega, v, sigma), left perturbation T <- exp(xi) o T; xi shared by
    every edge's endpoint (see slam.posegraph._residual_fn)."""
    gi, gj = graph.i.long(), graph.j.long()
    Ri, ti, si = poses.R[gi], poses.t[gi], poses.s[gi]
    Rj, tj, sj = poses.R[gj], poses.t[gj], poses.s[gj]
    szi = 1.0 / graph.s_z  # Z^{-1} = (1/sz, Rz^T, -(1/sz) Rz^T tz)
    Rzi = ll.transpose(graph.R_z)
    tzi = ll.scale(-szi, ll.matvec(Rzi, graph.t_z))

    def res(xi_i, xi_j):
        dRi, dRj = ll.exp_so3(xi_i[:3]), ll.exp_so3(xi_j[:3])
        dsi, dsj = torch.exp(xi_i[6]), torch.exp(xi_j[6])
        # T' = dT o T: s = ds s, R = dR R, t = ds dR t + dv
        si_n = dsi * si
        Ri_n = ll.matmul(dRi, Ri)
        ti_n = dsi * ll.matvec(dRi, ti) + xi_i[3:6]
        sj_n = dsj * sj
        Rj_n = ll.matmul(dRj, Rj)
        tj_n = dsj * ll.matvec(dRj, tj) + xi_j[3:6]
        si_inv = 1.0 / si_n
        Ri_inv = ll.transpose(Ri_n)
        ti_inv = ll.scale(-si_inv, ll.matvec(Ri_inv, ti_n))
        s_rel = sj_n * si_inv  # T_j' o T_i'^{-1}
        R_rel = ll.matmul(Rj_n, Ri_inv)
        t_rel = ll.add(ll.scale(sj_n, ll.matvec(Rj_n, ti_inv)), tj_n)
        s_e = szi * s_rel  # Z^{-1} o rel
        R_e = ll.matmul(Rzi, R_rel)
        t_e = ll.add(ll.scale(szi, ll.matvec(Rzi, t_rel)), tzi)
        return torch.cat([ll.log_so3(R_e), t_e, torch.log(s_e)[:, None]], -1)

    return res


def edge_residuals(poses: Sim3, graph: Sim3Graph) -> torch.Tensor:
    """[E, 7] residuals."""
    z = poses.t.new_zeros(7)
    return _residual_fn(poses, graph)(z, z)


def cost(poses: Sim3, graph: Sim3Graph, huber_delta: float = 0.0,
         robust_kernel: str = "huber") -> torch.Tensor:
    """Total (optionally robustified) edge cost (see posegraph.cost)."""
    return _robust_cost(edge_residuals(poses, graph), graph.weight, huber_delta, robust_kernel)


@precise()
def optimize_pose_graph_sim3(
    poses: Sim3,
    graph: Sim3Graph,
    *,
    iterations: int = 20,
    lam0: float = 1e-6,
    huber_delta: float = 0.0,
    robust_kernel: str = "huber",
    solver: str = "dense",
    cg_iterations: int = 50,
) -> Tuple[Sim3, Sim3Stats]:
    """LM optimization of the 7-dof pose graph. solver='dense': exact
    Cholesky of the [7P, 7P] system (small P); solver='pcg': matrix-free
    Jacobi-PCG (large P)."""
    free = (~graph.fixed).to(poses.t.dtype)[:, None]

    def step(ps, lam):
        Ji, Jj, r = _edge_jacobians(_residual_fn(ps, graph), 7, ps.t)
        w = _robust_weight(r, graph.weight, huber_delta, robust_kernel)
        if solver == "pcg":
            dx = _pcg_core(Ji, Jj, r, w, graph.i, graph.j, graph.fixed, lam, cg_iterations, dof=7)
        else:
            dx = _dense_core(Ji, Jj, r, w, graph.i, graph.j, graph.fixed, lam, dof=7)
        return sim3.compose(sim3.exp(dx * free), ps)

    def cost_fn(ps):
        return cost(ps, graph, huber_delta, robust_kernel)

    c0 = cost_fn(poses)
    ps, cf, lam = _lm(poses, c0, step, cost_fn, iterations, lam0)
    return ps, Sim3Stats(cost=cf, initial_cost=c0, lambda_final=lam)


def apply_scale_correction(X: torch.Tensor, anchor_pose_old: Sim3,
                           anchor_pose_new: Sim3) -> torch.Tensor:
    """Move landmarks with their anchor's Sim(3) correction:
    X' = T_new^{-1} (T_old X); camera-frame coordinates are invariant."""
    return sim3.transform(sim3.compose(sim3.invert(anchor_pose_new), anchor_pose_old), X)

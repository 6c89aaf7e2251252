"""Pose-graph optimization: Levenberg-Marquardt over SE(3) with relative-pose
edges (twin of cvsteer_tpu.slam.posegraph).

A fixed-size masked edge list, LM damping with accept/reject on the device,
and two solvers for the damped Gauss-Newton step: a dense Cholesky of the
assembled ``[6P, 6P]`` system (small P) and matrix-free Jacobi-PCG with a
fixed ``cg_iterations`` (large P). Edge Jacobians come from one forward-mode
pass (``torch.func.jvp``, vmapped) of the residual over the 12 tangent
basis directions, as the reference takes them with ``jax.linearize``. The
LM loop is a Python loop over device tensors: no host sync per iteration.

Pose convention: T_i = (R_i, t_i), world -> camera-i. An edge (i, j)
measures Z_ij ~ T_j o T_i^{-1}; its residual is log(Z_ij^{-1} o T_j o
T_i^{-1}) as a 6-vector (omega, v).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cvsteer_tpu_torch.slam import lie_lanes as ll
from cvsteer_tpu_torch.slam import se3
from cvsteer_tpu_torch.utils.precision import precise


class PoseGraph(NamedTuple):
    """Masked fixed-size pose graph.

    i, j:   [E] int edge endpoints.
    R_z:    [E, 3, 3] measured relative rotations.
    t_z:    [E, 3] measured relative translations.
    weight: [E] edge weights (0 masks a padding edge).
    fixed:  [P] bool, poses held constant (gauge anchor).
    """

    i: torch.Tensor
    j: torch.Tensor
    R_z: torch.Tensor
    t_z: torch.Tensor
    weight: torch.Tensor
    fixed: torch.Tensor


class Poses(NamedTuple):
    R: torch.Tensor  # [P, 3, 3]
    t: torch.Tensor  # [P, 3]


def relative_pose(poses: Poses, i, j) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_j o T_i^{-1} for index arrays i, j."""
    Ri_inv, ti_inv = se3.invert(poses.R[i], poses.t[i])
    return se3.compose(poses.R[j], poses.t[j], Ri_inv, ti_inv)


class PGOStats(NamedTuple):
    cost: torch.Tensor
    initial_cost: torch.Tensor
    lambda_final: torch.Tensor


def _residual_fn(poses: Poses, graph: PoseGraph):
    """Residual closure res(xi_i, xi_j) -> [E, 6]. ``xi_i``/``xi_j`` are [6]
    left perturbations shared by every edge's endpoint: each edge depends
    only on its own endpoints, so the derivative in a shared direction is
    the per-edge Jacobian column."""
    gi, gj = graph.i.long(), graph.j.long()
    Ri, ti, Rj, tj = poses.R[gi], poses.t[gi], poses.R[gj], poses.t[gj]
    Rzi = ll.transpose(graph.R_z)
    tzi = ll.neg(ll.matvec(Rzi, graph.t_z))

    def res(xi_i, xi_j):
        dRi, dti = ll.exp_se3(xi_i)
        dRj, dtj = ll.exp_se3(xi_j)
        Ri_n = ll.matmul(dRi, Ri)
        ti_n = ll.add(ll.matvec(dRi, ti), dti)
        Rj_n = ll.matmul(dRj, Rj)
        tj_n = ll.add(ll.matvec(dRj, tj), dtj)
        Rrel = ll.matmul(Rj_n, ll.transpose(Ri_n))  # T_j o T_i^{-1}
        trel = ll.sub(tj_n, ll.matvec(Rrel, ti_n))
        Re = ll.matmul(Rzi, Rrel)  # Z^{-1} o T_rel
        te = ll.add(ll.matvec(Rzi, trel), tzi)
        return torch.cat([ll.log_so3(Re), te], -1)

    return res


def _edge_jacobians(res, dof: int, like: torch.Tensor):
    """(Ji [E, dof, dof], Jj [E, dof, dof], r [E, dof]) of a residual
    closure: J[e, a, k] = d r_a / d xi[k] at 0, from one vmapped
    forward-mode pass over the 2 dof basis directions."""
    z = like.new_zeros(dof)
    basis = torch.eye(2 * dof, dtype=like.dtype, device=like.device)

    def column(tan):
        return torch.func.jvp(res, (z, z), (tan[:dof], tan[dof:]))[1]

    cols = torch.func.vmap(column)(basis)  # [2 dof, E, dof]
    J = cols.permute(1, 2, 0)  # [E, residual row, basis direction]
    return J[..., :dof], J[..., dof:], res(z, z)


def edge_residuals(poses: Poses, graph: PoseGraph) -> torch.Tensor:
    """[E, 6] residuals."""
    z = poses.t.new_zeros(6)
    return _residual_fn(poses, graph)(z, z)


def _robust_cost(r, weight, huber_delta: float, robust_kernel: str):
    sq = torch.sum(r * r, -1)
    if huber_delta > 0:
        rn = torch.sqrt(sq + 1e-20)
        if robust_kernel == "tukey":
            c = 3.0 * huber_delta
            u = torch.clamp(1.0 - (rn / c) ** 2, 0.0, 1.0)
            rho = (c * c / 6.0) * (1.0 - u ** 3)
        else:
            d = huber_delta
            rho = torch.where(rn <= d, 0.5 * sq, d * (rn - 0.5 * d))
        return torch.sum(weight * rho)
    return 0.5 * torch.sum(weight * sq)


def cost(poses: Poses, graph: PoseGraph, huber_delta: float = 0.0,
         robust_kernel: str = "huber") -> torch.Tensor:
    """Total (optionally robustified) edge cost. ``huber_delta`` > 0 bounds
    each edge's influence: 'huber' (quadratic inside the width, linear
    outside) or 'tukey' (redescending biweight with cutoff 3 x delta: gross
    outliers get zero influence)."""
    return _robust_cost(edge_residuals(poses, graph), graph.weight, huber_delta, robust_kernel)


def _robust_weight(r, weight, huber_delta: float, robust_kernel: str = "huber"):
    """IRLS edge weights: huber min(1, delta/||r||); tukey (1 - (||r||/c)^2)^2
    inside c = 3 delta and 0 outside; ``weight`` itself when delta <= 0."""
    if huber_delta <= 0:
        return weight
    rn = torch.sqrt(torch.sum(r * r, -1) + 1e-20)
    if robust_kernel == "tukey":
        c = 3.0 * huber_delta
        u = torch.clamp(1.0 - (rn / c) ** 2, 0.0, 1.0)
        return weight * u * u
    return weight * torch.clamp_max(huber_delta / rn, 1.0)


def _apply(poses: Poses, dx: torch.Tensor, fixed: torch.Tensor) -> Poses:
    free = (~fixed).to(dx.dtype)[:, None]
    dR, dt = se3.exp_se3(dx * free)
    R_new, t_new = se3.compose(dR, dt, poses.R, poses.t)
    return Poses(R=R_new, t=t_new)


def _dense_core(Ji, Jj, r, w, g_i, g_j, fixed, lam, *, dof):
    """Damped GN update dx [P, dof] by a dense Cholesky of H = G^T diag(w) G,
    G [dof E, dof P] the one-hot-expanded edge Jacobians (columns c P + p).
    A matrix that is not positive definite yields NaN: the step is then
    rejected."""
    P = fixed.shape[0]
    E = g_i.shape[0]
    sw = torch.sqrt(w)
    Si = ll.onehot(g_i.long(), P)  # [E, P]
    Sj = ll.onehot(g_j.long(), P)
    G = (
        (Ji * sw[:, None, None])[..., None] * Si[:, None, None, :]
        + (Jj * sw[:, None, None])[..., None] * Sj[:, None, None, :]
    )  # [E, a, c, P]
    G = G.permute(1, 0, 2, 3).reshape(dof * E, dof * P)
    rw = (r * sw[:, None]).T.reshape(-1)  # rows (a, e)
    H = G.T @ G
    b = -(rw @ G)
    free = (~fixed).to(H.dtype).repeat(dof)  # [dof P], c-major
    eye = torch.eye(dof * P, dtype=H.dtype, device=H.device)
    H = H + lam * eye
    H = H * free[None, :] * free[:, None]
    H = H + torch.diag(1.0 - free) + 1e-10 * eye
    b = b * free
    L, info = torch.linalg.cholesky_ex(H)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    dx = torch.where(info == 0, dx, float("nan"))
    return dx.reshape(dof, P).T


def _pcg_core(Ji, Jj, r, w, g_i, g_j, fixed, lam, cg_iterations: int, *, dof):
    """Damped GN update dx [P, dof] by matrix-free Jacobi-preconditioned CG
    (``cg_iterations`` fixed): the normal matrix is never built; each Hv
    product applies the edge Jacobians and scatters back through a one-hot
    ``[2E, P]`` matmul. The SE(3) solver calls it with dof 6, the Sim(3) one
    with dof 7."""
    P = fixed.shape[0]
    E = g_i.shape[0]
    freeP = (~fixed).to(r.dtype)[:, None]  # [P, 1]
    idx2 = torch.cat([g_i, g_j]).long()  # [2E]

    S = ll.onehot(idx2, P)  # [2E, P]

    def segsum(vals):  # [2E, C] -> [P, C] segment sums over idx2
        return S.T @ vals

    def both(Yi, Yj):
        return segsum(torch.cat([Yi, Yj], 0))

    wc = w[:, None]
    b = both(-(Ji * r[:, :, None]).sum(1) * wc, -(Jj * r[:, :, None]).sum(1) * wc) * freeP
    Di = torch.einsum("eac,ead->ecd", Ji, Ji) * w[:, None, None]
    Dj = torch.einsum("eac,ead->ecd", Jj, Jj) * w[:, None, None]
    Dm = both(Di.reshape(E, dof * dof), Dj.reshape(E, dof * dof)).reshape(P, dof, dof)
    eye = torch.eye(dof, dtype=r.dtype, device=r.device)
    D_inv, _ = torch.linalg.inv_ex(Dm + (lam + 1e-8) * eye)

    def precond(V):  # [P, dof]
        return torch.einsum("pac,pc->pa", D_inv, V) * freeP

    def hv(V):
        Vm = V * freeP
        rows = Vm[idx2]
        u = (torch.einsum("eac,ec->ea", Ji, rows[:E])
             + torch.einsum("eac,ec->ea", Jj, rows[E:])) * wc
        out = both(torch.einsum("eac,ea->ec", Ji, u), torch.einsum("eac,ea->ec", Jj, u))
        return (out + lam * Vm) * freeP

    x = torch.zeros_like(b)
    res = b
    z = precond(res)
    p = z
    rz = torch.sum(res * z)
    for _ in range(cg_iterations):
        hp = hv(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-20)
        x = x + alpha * p
        res = res - alpha * hp
        z = precond(res)
        rz_new = torch.sum(res * z)
        p = z + rz_new / torch.clamp_min(rz, 1e-20) * p
        rz = rz_new
    return x


def _lm(poses, c0, step, cost_fn, iterations: int, lam0: float):
    """The LM loop: ``step(poses, lam)`` proposes a candidate, kept when its
    cost drops (lambda / 3), else dropped (lambda x 10); all on the device."""
    ps, cur = poses, c0
    lam = torch.full((), lam0, dtype=c0.dtype, device=c0.device)
    for _ in range(iterations):
        cand = step(ps, lam)
        cand_cost = cost_fn(cand)
        accept = cand_cost < cur
        ps = type(ps)(*(torch.where(accept, a, b) for a, b in zip(cand, ps)))
        cur = torch.where(accept, cand_cost, cur)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 10.0), 1e-9, 1e6)
    return ps, cur, lam


@precise()
def optimize_pose_graph(
    poses: Poses,
    graph: PoseGraph,
    *,
    iterations: int = 20,
    lam0: float = 1e-6,
    solver: str = "dense",
    cg_iterations: int = 50,
    axis_name: Optional[str] = None,
    huber_delta: float = 0.0,
    robust_kernel: str = "huber",
) -> Tuple[Poses, PGOStats]:
    """LM pose-graph optimization with a fixed iteration count.

    solver='dense': exact Cholesky of the [6P, 6P] system (small P);
    solver='pcg': matrix-free Jacobi-PCG (large P). ``axis_name`` (edges
    sharded over a mesh axis) belongs to parallel/posegraph_sharded, which
    is not ported yet."""
    if axis_name is not None:
        raise NotImplementedError(
            "optimize_pose_graph(axis_name=...): the edge-sharded pose graph "
            "(parallel/posegraph_sharded) is not ported yet"
        )

    def step(ps, lam):
        Ji, Jj, r = _edge_jacobians(_residual_fn(ps, graph), 6, ps.t)
        w = _robust_weight(r, graph.weight, huber_delta, robust_kernel)
        if solver == "pcg":
            dx = _pcg_core(Ji, Jj, r, w, graph.i, graph.j, graph.fixed, lam, cg_iterations, dof=6)
        else:
            dx = _dense_core(Ji, Jj, r, w, graph.i, graph.j, graph.fixed, lam, dof=6)
        return _apply(ps, dx, graph.fixed)

    def cost_fn(ps):
        return cost(ps, graph, huber_delta, robust_kernel)

    c0 = cost_fn(poses)
    ps, cf, lam = _lm(poses, c0, step, cost_fn, iterations, lam0)
    return ps, PGOStats(cost=cf, initial_cost=c0, lambda_final=lam)

"""Windowed bundle adjustment: Schur-complement Levenberg-Marquardt over a
dense masked observation grid (twin of cvsteer_tpu.slam.ba).

The observation structure is a dense masked grid ``[C cameras, L
landmarks]``. Per iteration: analytic Jacobians ``J_c [C, L, 2, 6]`` and
``J_l [C, L, 2, 3]``; landmark blocks ``H_ll [L, 3, 3]`` inverted in closed
form; the reduced camera system ``S [C*6, C*6]`` assembled by one matmul
over the landmark axis and solved by a dense Cholesky factorization; then
landmark back-substitution. The damping's accept/reject is computed on the
device (``torch.where``), so a fixed iteration count runs with no host
round trip. (The reference kept per-observation quantities as lists of
[C, L] arrays to dodge the TPU's (8, 128) tile padding; on the card plain
stacked tensors are the natural layout.)

Projection model: normalized pinhole u = (x/z, y/z). Gauge freedom is
removed by freezing ``fixed_cameras``.

Landmark sharding (parallel.ba_sharded): with ``group``, the process
group of a mesh axis over which the landmarks are split, every rank holds
its landmark slice and all the cameras. Each LM iteration then sums the
camera side of the reduced system (the Schur term, its right-hand side,
H_cc and b_c) over the ranks in one packed all-reduce, and each cost in one
scalar all-reduce; every rank solves the same summed camera system, and
the back-substitution stays local. ``group`` None is the single device.

On the card, float32 problems take two hand-written kernels an iteration
(ops.cuda_ba: the linearization and the camera side of the Schur
complement in one, the updates and the candidate's cost in the other),
each launched once for every problem of a vmapped batch; the dense
Cholesky solve between them stays here. The CPU and float64 run the plain
code below, which the kernels' decomposition and its tests follow.

Both solvers run inside the device engine's captured CUDA graphs
(slam.vo_device): every tensor they make is made on the device (no copy
from host memory), and the ``*_ex`` factorizations leave their status on
the device, so nothing synchronizes the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from cvsteer_tpu_torch.ops import cuda_ba
from cvsteer_tpu_torch.slam import se3
from cvsteer_tpu_torch.utils.precision import precise


class BAProblem(NamedTuple):
    """uv [C, L, 2] observed normalized coordinates; mask [C, L]; fixed_cameras
    [C] bool; huber_delta: robust-kernel width in normalized units (<= 0
    disables)."""

    uv: torch.Tensor
    mask: torch.Tensor
    fixed_cameras: torch.Tensor
    huber_delta: float = 0.0


class BAState(NamedTuple):
    """R [C, 3, 3], t [C, 3] (world->camera: p = R X + t), X [L, 3]."""

    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor


class BAStats(NamedTuple):
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int
    lambda_final: torch.Tensor


def _project(R, t, X):
    """p [C, L, 3] camera-frame points, u [C, L, 2], z [C, L] (guarded)."""
    p = torch.einsum("cij,lj->cli", R, X) + t[:, None, :]
    z = p[..., 2]
    z_safe = torch.where(z.abs() > 1e-9, z, 1e-9)
    return p, p[..., :2] / z_safe[..., None], z_safe


def _weights(r, z, problem: BAProblem):
    w = problem.mask.to(r.dtype) * (z > 1e-6)
    if problem.huber_delta > 0:
        rn = torch.sqrt(r[..., 0] ** 2 + r[..., 1] ** 2)
        w = w * torch.clamp_max(problem.huber_delta / torch.clamp_min(rn, 1e-12), 1.0)
    return w


def residuals(state: BAState, problem: BAProblem) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r [C, L, 2], weight [C, L]) with Huber IRLS weights folded in."""
    _, u, z = _project(state.R, state.t, state.X)
    r = u - problem.uv
    return r, _weights(r, z, problem)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    # the transport lives in parallel/, whose package imports this module
    # (and slam.posegraph, which takes this helper)
    from cvsteer_tpu_torch.parallel.halo import all_reduce_sum

    return all_reduce_sum(t, group)


def cost(state: BAState, problem: BAProblem,
         group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The robust cost; with ``group``, summed over the landmark shards."""
    r, w = residuals(state, problem)
    c = 0.5 * torch.sum(w * (r[..., 0] ** 2 + r[..., 1] ** 2))
    return c if group is None else _all_reduce_sum(c, group)


def _jacobians(state: BAState, problem: BAProblem):
    """(J_c [C, L, 2, 6], J_l [C, L, 2, 3], r [C, L, 2], w [C, L])."""
    p, u, z = _project(state.R, state.t, state.X)
    r = u - problem.uv
    w = _weights(r, z, problem)
    inv_z = 1.0 / z
    zero = torch.zeros_like(inv_z)
    dudp = torch.stack(
        [
            torch.stack([inv_z, zero, -u[..., 0] * inv_z], -1),
            torch.stack([zero, inv_z, -u[..., 1] * inv_z], -1),
        ],
        -2,
    )  # [C, L, 2, 3]
    q = p - state.t[:, None, :]  # R X
    J_w = dudp @ -se3.hat(q)  # dp/domega = -hat(R X)
    J_c = torch.cat([J_w, dudp], dim=-1)  # dp/dv = I
    J_l = dudp @ state.R[:, None]  # dp/dX = R
    return J_c, J_l, r, w


def _inv3(M: torch.Tensor, lam) -> torch.Tensor:
    """Closed-form inverse of the damped 3x3 blocks M [L, 3, 3] + lam I."""
    a, b, c = M[:, 0, 0] + lam, M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1] + lam, M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2] + lam
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    return torch.stack(
        [torch.stack([A, B, Cc], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        -2,
    ) * inv[:, None, None]


class NormalEquations(NamedTuple):
    """All blocks of the (damped) BA normal equations for one linearization."""

    H_cc: torch.Tensor  # [C, 6, 6]
    H_ll: torch.Tensor  # [L, 3, 3]
    W: torch.Tensor  # [C, L, 6, 3]
    b_c: torch.Tensor  # [C, 6]
    b_l: torch.Tensor  # [L, 3]


def build_normal_equations(state: BAState, problem: BAProblem) -> NormalEquations:
    """The blocks of :func:`_normal_equations` by name."""
    return NormalEquations(*_normal_equations(state, problem))


def _normal_equations(state: BAState, problem: BAProblem):
    """(H_cc [C,6,6], H_ll [L,3,3], W [C,L,6,3], b_c [C,6], b_l [L,3]); the
    Huber weight is split as sqrt(w) onto both operands."""
    J_c, J_l, r, w = _jacobians(state, problem)
    sw = torch.sqrt(w)[..., None, None]
    Jcw, Jlw = J_c * sw, J_l * sw
    rw = r * sw[..., 0]
    H_cc = torch.einsum("clai,claj->cij", Jcw, Jcw)
    b_c = -torch.einsum("clai,cla->ci", Jcw, rw)
    H_ll = torch.einsum("clak,clam->lkm", Jlw, Jlw)
    W = torch.einsum("clai,clak->clik", Jcw, Jlw)
    b_l = -torch.einsum("clak,cla->lk", Jlw, rw)
    return H_cc, H_ll, W, b_c, b_l


def _block_diag_add(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S [C, 6, C, 6] with ``blocks [C, 6, 6]`` added on its diagonal."""
    C = S.shape[0]
    diag = torch.eye(C, dtype=torch.bool, device=S.device)[:, None, :, None]
    return torch.where(diag, S + blocks[:, :, None, :], S)


def reduced_system(H_cc, H_ll, W, b_c, b_l, lam, fixed,
                   group: Optional[dist.ProcessGroup] = None):
    """Schur complement: (S [C, 6, C, 6], b_s [C, 6], H_ll^-1 [L, 3, 3]).
    With ``group`` (landmark shards) the camera-side pieces are summed over
    the ranks, in one all-reduce of C^2 36 + C 36 + 2 C 6 floats, before
    the damping and the gauge."""
    S, bs_lm, Hinv = _schur_terms(H_ll, W, b_l, lam)
    return (*_camera_system(S, bs_lm, H_cc, b_c, lam, fixed, group), Hinv)


def _schur_terms(H_ll, W, b_l, lam):
    """The landmark side of :func:`reduced_system`, undamped on the cameras:
    (S = -W H_ll^-1 W^T [C, 6, C, 6], bs_lm = W H_ll^-1 b_l [C, 6], H_ll^-1
    [L, 3, 3]) with H_ll damped by ``lam``."""
    C, L = W.shape[:2]
    Hinv = _inv3(H_ll, lam)
    WHinv = torch.einsum("clik,lkm->clim", W, Hinv)
    A2 = WHinv.permute(0, 2, 1, 3).reshape(C * 6, L * 3)  # columns (l, k)
    B2 = W.permute(0, 2, 1, 3).reshape(C * 6, L * 3)
    S = -(A2 @ B2.T).reshape(C, 6, C, 6)
    bs_lm = (A2 @ b_l.reshape(L * 3)).reshape(C, 6)
    return S, bs_lm, Hinv


def _camera_system(S, bs_lm, H_cc, b_c, lam, fixed, group):
    """(S, b_s) of :func:`reduced_system` from its undamped camera-side
    pieces: summed over the landmark shards, damped, gauged."""
    if group is not None:
        parts = (S, bs_lm, H_cc, b_c)
        summed = _all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]), group)
        S, bs_lm, H_cc, b_c = (a.view(p.shape) for a, p in zip(
            summed.split([p.numel() for p in parts]), parts))
    eye6 = torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    S = _block_diag_add(S, H_cc + lam * eye6)
    b_s = b_c - bs_lm
    # gauge: fixed cameras get identity rows/cols and zero rhs
    free = (~fixed).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = _block_diag_add(S, eye6 * (1.0 - free)[:, None, None])
    return S, b_s * free[:, None]


def solve_reduced_dense(S: torch.Tensor, b_s: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of the reduced camera system; [C, 6]. A matrix that is
    not positive definite yields NaN (and its step is then rejected)."""
    C = S.shape[0]
    A = S.reshape(C * 6, C * 6)
    A = A + 1e-10 * torch.eye(C * 6, dtype=A.dtype, device=A.device)
    Lc, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b_s.reshape(C * 6, 1), Lc)[:, 0]
    x = torch.where(info == 0, x, float("nan"))
    return x.reshape(C, 6)


def back_substitute(W, Hinv, b_l, dx_c) -> torch.Tensor:
    """Landmark updates dX [L, 3] given camera updates dx_c [C, 6]."""
    rhs = b_l - torch.einsum("clik,ci->lk", W, dx_c)
    return torch.einsum("lkj,lj->lk", Hinv, rhs)


def apply_updates(state: BAState, dx_c, dX, fixed) -> BAState:
    free = (~fixed).to(dx_c.dtype)[:, None]
    R_new = se3.exp_so3(dx_c[:, :3] * free) @ state.R
    return BAState(R=R_new, t=state.t + dx_c[:, 3:] * free, X=state.X + dX)


def _fused(state: BAState, problem: BAProblem) -> bool:
    """float32 on the card takes ops.cuda_ba's kernels."""
    return cuda_ba.takes(state.R, state.t, state.X, problem.uv)


def ba_step(state: BAState, problem: BAProblem, lam,
            group: Optional[dist.ProcessGroup] = None) -> Tuple[BAState, torch.Tensor]:
    """One damped Gauss-Newton step: (candidate state, its cost). ``group``:
    the landmark shards' process group (the camera system is summed over it
    and solved on every rank; the landmark update stays local)."""
    if _fused(state, problem):
        uv, mask, huber = problem.uv, problem.mask.to(torch.float32), problem.huber_delta
        S, bs_lm, H_cc, b_c, lm = cuda_ba.schur(*state, uv, mask, lam, huber)
        S, b_s = _camera_system(S, bs_lm, H_cc, b_c, lam, problem.fixed_cameras, group)
        dx_c = solve_reduced_dense(S, b_s)
        *cand, c = cuda_ba.update(*state, uv, mask, dx_c, problem.fixed_cameras, lm, huber)
        return BAState(*cand), (c if group is None else _all_reduce_sum(c, group))
    H_cc, H_ll, W, b_c, b_l = _normal_equations(state, problem)
    S, b_s, Hinv = reduced_system(H_cc, H_ll, W, b_c, b_l, lam, problem.fixed_cameras, group)
    dx_c = solve_reduced_dense(S, b_s)
    dX = back_substitute(W, Hinv, b_l, dx_c)
    new_state = apply_updates(state, dx_c, dX, problem.fixed_cameras)
    return new_state, cost(new_state, problem, group)


@precise()
def refine_pose(
    X: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    R0: torch.Tensor,
    t0: torch.Tensor,
    *,
    iterations: int = 10,
    huber_delta: float = 0.0,
    lam0: float = 1e-4,
):
    """Motion-only BA (the PnP refinement of VO): one camera pose against
    fixed landmarks ``X [M, 3]`` observed at ``uv [M, 2]`` where ``mask``.
    Returns (R, t, inlier_mask); inliers are judged at 3x the Huber width
    (all masked points when huber_delta <= 0)."""
    mask = mask if mask.dtype == torch.bool else mask > 0
    problem = BAProblem(
        uv=uv[None], mask=mask[None],
        fixed_cameras=torch.zeros(1, dtype=torch.bool, device=X.device),
        huber_delta=huber_delta,
    )
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    cur = cost(BAState(R[None], t[None], X), problem)
    lam = torch.full((), lam0, dtype=X.dtype, device=X.device)
    for _ in range(iterations):
        J_c, _, r, w = _jacobians(BAState(R[None], t[None], X), problem)
        sw = torch.sqrt(w)[..., None, None]
        Jcw = (J_c * sw)[0]
        rw = (r * sw[..., 0])[0]
        H = torch.einsum("lai,laj->ij", Jcw, Jcw) + lam * eye6
        b = -torch.einsum("lai,la->i", Jcw, rw)
        dx, _ = torch.linalg.solve_ex(H, b)
        R_new = se3.exp_so3(dx[:3]) @ R
        t_new = t + dx[3:]
        new_cost = cost(BAState(R_new[None], t_new[None], X), problem)
        accept = new_cost < cur
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        cur = torch.where(accept, new_cost, cur)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 10.0), 1e-9, 1e6)
    r, _ = residuals(BAState(R[None], t[None], X), problem)
    rn = torch.linalg.vector_norm(r[0], dim=-1)
    thresh = 3.0 * huber_delta if huber_delta > 0 else float("inf")
    return R, t, (rn < thresh) & mask


@precise()
def bundle_adjust(
    state: BAState,
    problem: BAProblem,
    *,
    iterations: int = 20,
    lam0: float = 1e-4,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[BAState, BAStats]:
    """Levenberg-Marquardt BA with a fixed iteration count: a rejected step
    raises lambda x10 and keeps the old state; an accepted one lowers it
    x(1/3). ``group``: the process group of the mesh axis the landmarks
    are sharded over (parallel.ba_sharded); every rank then takes the same
    decisions on the summed costs."""
    if _fused(state, problem):  # the mask as the kernels read it, once
        problem = problem._replace(mask=problem.mask.to(torch.float32))
        c0 = cuda_ba.cost(*state, problem.uv, problem.mask, problem.huber_delta)
        c0 = c0 if group is None else _all_reduce_sum(c0, group)
    else:
        c0 = cost(state, problem, group)
    cur = c0
    lam = torch.full((), lam0, dtype=state.X.dtype, device=state.X.device)
    for _ in range(iterations):
        cand, cand_cost = ba_step(state, problem, lam, group)
        accept = cand_cost < cur
        state = BAState(*(torch.where(accept, a, b) for a, b in zip(cand, state)))
        cur = torch.where(accept, cand_cost, cur)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 10.0), 1e-9, 1e6)
    return state, BAStats(cost=cur, initial_cost=c0, iterations=iterations, lambda_final=lam)

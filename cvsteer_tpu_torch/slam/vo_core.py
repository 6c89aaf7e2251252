"""Shared VO numeric rules (twin of the default-path pieces of
cvsteer_tpu.slam.vo_core): dual-init PnP, projective rescue, the
triangulation gate, the per-landmark reprojection signal and the culling
bar, with the reference's constants."""

from __future__ import annotations

import math

import torch

from cvsteer_tpu_torch.slam.ba import refine_pose
from cvsteer_tpu_torch.slam.ba import residuals as ba_residuals

#: minimum triangulated depth (in either view) for a landmark candidate
MIN_TRI_DEPTH = 1e-3
#: maximum |coordinate| for a triangulated landmark
MAX_LM_COORD = 1e4
#: constant-velocity guard: reject per-frame rotations beyond this
MAX_PRED_ROT_DEG = 30.0
#: constant-velocity guard: reject per-frame translations beyond this
MAX_PRED_SHIFT = 10.0


def pnp_dual_refine(
    X, uv, use, Rp, tp, R1, t1, *, iterations, huber_delta, min_track, dual_init,
    lam0=1e-4,
):
    """Motion-only PnP from the prediction (Rp, tp); with ``dual_init`` also
    from the reference pose (R1, t1), picking the latter when the
    prediction keeps < ``min_track`` inliers and it does better. Returns
    (R, t, n_inliers) as tensors."""
    R, t, inl = refine_pose(
        X, uv, use, Rp, tp, iterations=iterations, huber_delta=huber_delta, lam0=lam0
    )
    n = inl.sum()
    if dual_init:
        Rb, tb, ib = refine_pose(
            X, uv, use, R1, t1, iterations=iterations, huber_delta=huber_delta, lam0=lam0
        )
        nb = ib.sum()
        pick_b = (n < min_track) & (nb > n)
        R = torch.where(pick_b, Rb, R)
        t = torch.where(pick_b, tb, t)
        n = torch.where(pick_b, nb, n)
    return R, t, n


def guided_rescue(
    desc_a, valid_a, X_slots, sel_slots, desc_b, valid_b, uv_all, idx, R, t,
    *, radius_norm, min_sim,
):
    """Projective rescue of unmatched landmark-bearing keyframe features:
    project each one's landmark with (R, t) and accept the MUTUALLY best
    frame feature within ``radius_norm`` whose descriptor cosine clears
    ``min_sim``. Rescues never displace ratio matches or claimed frame
    features. Returns the merged match index [A]."""
    B = desc_b.shape[0]
    claimed = torch.zeros(B + 1, dtype=torch.bool, device=idx.device)
    claimed[torch.where(idx >= 0, idx, B)] = True
    claimed = claimed[:B]
    p = X_slots @ R.T + t
    z = p[:, 2]
    uv_pred = p[:, :2] / torch.clamp_min(z[:, None], 1e-6)
    elig_a = valid_a & sel_slots & (idx < 0) & (z > MIN_TRI_DEPTH)
    elig_b = valid_b & ~claimed
    d2 = torch.sum((uv_pred[:, None, :] - uv_all[None, :, :]) ** 2, -1)  # [A, B]
    sim = desc_a @ desc_b.T
    ok = (
        elig_a[:, None] & elig_b[None, :]
        & (d2 < radius_norm * radius_norm) & (sim > min_sim)
    )
    s = torch.where(ok, sim, -2.0)
    best_j = torch.argmax(s, dim=1)  # [A]
    best_i = torch.argmax(s, dim=0)  # [B]
    hit = torch.gather(s, 1, best_j[:, None])[:, 0] > -2.0
    mutual = best_i[best_j] == torch.arange(s.shape[0], device=s.device)
    return torch.where(hit & mutual, best_j, idx)


def triangulation_gate(Xc, P1, P2, min_ray_angle_deg: float = 1.0):
    """Acceptance mask for triangulated candidates ``Xc [F, 3]``: positive
    depth in both views, bounded coordinates, and a ray angle between the
    two views of at least ``min_ray_angle_deg`` (0 disables; the monocular
    scale-stability guard)."""
    z1 = Xc @ P1[2, :3] + P1[2, 3]
    z2 = Xc @ P2[2, :3] + P2[2, 3]
    ok = (z1 > MIN_TRI_DEPTH) & (z2 > MIN_TRI_DEPTH) & (Xc.abs() < MAX_LM_COORD).all(1)
    if float(min_ray_angle_deg) > 0.0:
        C1 = -P1[:3, :3].T @ P1[:3, 3]
        C2 = -P2[:3, :3].T @ P2[:3, 3]
        r1 = Xc - C1
        r2 = Xc - C2
        cos = torch.sum(r1 * r2, -1) / torch.clamp_min(
            torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1),
            1e-12,
        )
        ok = ok & (cos < math.cos(math.radians(min_ray_angle_deg)))
    return ok


def masked_mean_reproj(final, problem):
    """[L] mask-weighted mean reprojection-error norm per landmark column of
    a BA solution (zero where unobserved) — the culling signal."""
    r, _ = ba_residuals(final, problem)
    rn = torch.linalg.vector_norm(r, dim=-1)
    m = problem.mask.to(rn.dtype)
    obs = m.sum(dim=0)
    return torch.where(obs > 0, (rn * m).sum(dim=0) / torch.clamp_min(obs, 1.0), 0.0)


def cull_bar(huber_delta) -> float:
    """Reprojection-error culling threshold: 3x the Huber width, floored."""
    return 3.0 * max(float(huber_delta), 1e-4)

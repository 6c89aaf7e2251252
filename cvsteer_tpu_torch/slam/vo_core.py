"""Shared VO numeric rules (twin of cvsteer_tpu.slam.vo_core): dual-init
PnP, projective rescue, the triangulation gate, the median matched flow,
the per-landmark reprojection signal and the culling bar, the ground-plane
height observation and its controller, and the keyframe signature and
closure-candidate rule, with the reference's constants. The fleet's
constant-velocity prediction waits for the serving port.

Every rule here also runs inside the device engine's captured CUDA graphs
(slam.vo_device), so none reads a tensor on the host, indexes with a 0-dim
tensor or assigns a Python scalar through an index (a host-to-device copy
that a capturing stream refuses)."""

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

# --- ground-prior control law (see slam.vo.apply_ground_prior) -------------
#: ignore scale errors below this log-ratio
GROUND_DEADBAND = 0.015
#: proportional gain on the log-scale error
GROUND_GAIN = 0.5
#: per-promotion step cap near convergence (log-ratio)
GROUND_MAX_STEP = 0.05
#: FAR regime threshold and its larger step cap (the init transient)
GROUND_FAR = 0.15
GROUND_MAX_STEP_FAR = 0.15


def ground_controller(h_obs, do_obs, hist, *, target):
    """The in-step ground-prior controller: (hist', r).

    ``h_obs`` this frame's height observation (0 = none), ``do_obs`` whether
    to record it, ``hist [3]`` the rolling observation window (newest
    first). Returns the updated window and the correction ratio r to apply
    as a similarity about the newest camera center: 1.0 inside the deadband
    or while the window is cold. The tensor twin of the host law
    (slam.vo.ground_correction_ratio over smoothed_ground)."""
    hist2 = torch.where(do_obs, torch.cat([h_obs.reshape(1), hist[:-1]]), hist)
    h_sm = torch.sort(hist2).values[1]  # median of 3; 0 while a slot is cold
    e = torch.where(h_sm > 1e-9, torch.log(target / torch.clamp_min(h_sm, 1e-9)), 0.0)
    cap = torch.where(e.abs() > GROUND_FAR, GROUND_MAX_STEP_FAR, GROUND_MAX_STEP)
    r = torch.exp(torch.clamp(GROUND_GAIN * e, -cap, cap))
    apply = do_obs & (e.abs() >= GROUND_DEADBAND)
    return hist2, torch.where(apply, r, 1.0)


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
    claimed = torch.zeros(B + 1, dtype=torch.bool, device=idx.device).index_put_(
        (torch.where(idx >= 0, idx, B),), torch.ones_like(idx, dtype=torch.bool)
    )[:B]
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


def median_flow(uv_kf, valid_kf, uv_new, idx):
    """Median image displacement (normalized units) of the keyframe
    features matched into the new frame (``idx [A]``, -1 = unmatched);
    0.0 when none is matched. The flow-driven keyframe rule compares it
    with VOConfig.kf_min_flow_norm."""
    matched = (idx >= 0) & valid_kf
    disp = torch.linalg.vector_norm(uv_kf - uv_new[torch.clamp_min(idx, 0)], dim=-1)
    d = torch.where(matched, disp, torch.inf)
    cnt = matched.sum()
    med = torch.sort(d).values.gather(0, (cnt // 2).reshape(1))[0]
    return torch.where(cnt > 0, med, 0.0)


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


def ground_height_obs(X, use, v_pix, R, t, cy, *, min_pts=8):
    """Camera-frame height of the dominant consistent-height cluster of
    bottom-of-image tracked landmarks: the ground-plane scale observation.

    Selection: tracked associations (``use``) whose observing pixel row
    ``v_pix`` lies below 1.25 cy, with positive height and depth in the
    pose (R, t). Each selected point votes for the points within +-8 % of
    its own height; the best-supported point's band is the ground (walls
    below camera height spread their heights, the ground shares one), and
    the estimate is its mean height. 0.0 when fewer than ``min_pts`` points
    support it."""
    p = X @ R.T + t
    y = p[:, 1]
    sel = use & (v_pix > 1.25 * cy) & (y > 1e-3) & (p[:, 2] > MIN_TRI_DEPTH)
    pair_ok = (
        ((y[None, :] - y[:, None]).abs() < 0.08 * y[:, None]) & sel[None, :] & sel[:, None]
    )
    best = torch.argmax(pair_ok.to(torch.float32).sum(1))
    band = pair_ok[best.reshape(1)][0]
    cnt = band.to(torch.float32).sum()
    h = torch.where(band, y, 0.0).sum() / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt >= min_pts, h, 0.0)


def signature_device(desc, valid):
    """Keyframe global descriptor: the mean of the valid local descriptors,
    L2-normalized (slam.vo.keyframe_signature is the host twin)."""
    cnt = valid.to(torch.float32).sum()
    s = torch.where(valid[..., None], desc, 0.0).sum(-2) / torch.clamp_min(cnt, 1.0)
    n = torch.linalg.vector_norm(s)
    return torch.where(n > 1e-9, s / torch.clamp_min(n, 1e-30), s)


def closure_candidates(sigs, sig_new, j, *, min_gap, top):
    """Top-``top`` closure candidate rows for a new keyframe that will take
    index ``j``, against signature-store rows [0, j - min_gap]; masked rows
    score -inf. Returns (idx [top], score [top]). ``torch.topk`` orders
    ties otherwise than ``lax.top_k``: compare candidates as sets."""
    s = sigs @ sig_new
    rows = torch.arange(sigs.shape[0], device=sigs.device)
    s = torch.where(rows <= j - min_gap, s, -torch.inf)
    score, idx = torch.topk(s, top)
    return idx, score

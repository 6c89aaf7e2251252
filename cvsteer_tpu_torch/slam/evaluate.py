"""Trajectory evaluation: Umeyama Sim(3)/SE(3) alignment + ATE RMSE.

The BASELINE metric for configs 4-5 (ATE RMSE on TUM-RGBD / KITTI style
trajectories). Monocular trajectories are aligned with similarity transforms
(scale is unobservable); stereo/ground-truth-scaled ones with SE(3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def camera_centers(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World-frame camera centers c = -R^T t from world->camera poses."""
    return -np.einsum("fji,fj->fi", R, t)


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    src, dst: [N, 3]. Returns (s, R, t).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    traj_R: np.ndarray,
    traj_t: np.ndarray,
    gt_R: np.ndarray,
    gt_t: np.ndarray,
    *,
    align_scale: bool = True,
) -> float:
    """Absolute trajectory error (RMSE over camera centers) after alignment."""
    c_est = camera_centers(traj_R, traj_t)
    c_gt = camera_centers(gt_R, gt_t)
    s, R, t = umeyama(c_est, c_gt, with_scale=align_scale)
    aligned = s * c_est @ R.T + t
    err = np.linalg.norm(aligned - c_gt, axis=1)
    return float(np.sqrt((err**2).mean()))

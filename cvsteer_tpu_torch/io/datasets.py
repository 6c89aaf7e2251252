"""Dataset readers: TUM-RGBD monocular sequences + plain image directories.

BASELINE configs 4-5 name TUM-RGBD / KITTI odometry; this module parses
their on-disk layouts into (image paths, ground-truth poses) without
touching any heavy dependency — decode happens through
cvsteer_tpu_torch.io.imageio.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class Sequence(NamedTuple):
    """image_paths [F]; timestamps [F]; gt poses world->camera (or None)."""

    image_paths: List[str]
    timestamps: np.ndarray
    gt_R: Optional[np.ndarray]  # [F, 3, 3]
    gt_t: Optional[np.ndarray]  # [F, 3]


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    """TUM (qx, qy, qz, qw) quaternions -> rotation matrices [N, 3, 3]."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    R = np.empty((len(q), 3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _read_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def load_tum_rgbd(root: str, *, max_frames: Optional[int] = None) -> Sequence:
    """Parse a TUM-RGBD sequence directory (rgb.txt + groundtruth.txt).

    Ground-truth rows are ``t tx ty tz qx qy qz qw`` (camera->world); we
    associate each rgb frame with the nearest gt timestamp and convert to
    world->camera. Sequences without groundtruth.txt load with gt_R=None.
    """
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    if max_frames:
        rgb = rgb[:max_frames]
    ts = np.array([t for t, _ in rgb])
    paths = [os.path.join(root, p) for _, p in rgb]

    gt_path = os.path.join(root, "groundtruth.txt")
    gt_R = gt_t = None
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(v) for v in line.split()])
        g = np.asarray(rows)
        # nearest-timestamp association
        idx = np.abs(g[:, 0:1] - ts[None, :]).argmin(axis=0)
        twc = g[idx, 1:4]
        Rwc = _quat_to_R(g[idx, 4:8])
        # world->camera: R = Rwc^T, t = -R twc
        gt_R = np.swapaxes(Rwc, 1, 2).astype(np.float32)
        gt_t = -np.einsum("fij,fj->fi", gt_R, twc).astype(np.float32)
    return Sequence(paths, ts, gt_R, gt_t)


def load_kitti_odometry(
    root: str, sequence: str = "00", *, max_frames: Optional[int] = None
) -> Sequence:
    """Parse a KITTI odometry sequence (image_0/ + poses/<seq>.txt).

    Pose rows are 3x4 camera->world matrices; converted to world->camera.
    """
    img_dir = os.path.join(root, "sequences", sequence, "image_0")
    names = sorted(os.listdir(img_dir))
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(img_dir, n) for n in names]
    ts = np.arange(len(paths), dtype=np.float64) * 0.1

    pose_path = os.path.join(root, "poses", sequence + ".txt")
    gt_R = gt_t = None
    if os.path.exists(pose_path):
        P = np.loadtxt(pose_path)[: len(paths)].reshape(-1, 3, 4)
        Rwc, twc = P[:, :, :3], P[:, :, 3]
        gt_R = np.swapaxes(Rwc, 1, 2).astype(np.float32)
        gt_t = -np.einsum("fij,fj->fi", gt_R, twc).astype(np.float32)
    return Sequence(paths, ts, gt_R, gt_t)


def load_image_dir(root: str, *, max_frames: Optional[int] = None) -> Sequence:
    """Alphabetical image directory (no ground truth)."""
    exts = (".png", ".jpg", ".jpeg", ".pgm", ".bmp")
    names = sorted(n for n in os.listdir(root) if n.lower().endswith(exts))
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(root, n) for n in names]
    return Sequence(paths, np.arange(len(paths), dtype=np.float64), None, None)


def open_sequence(path: str, **kw) -> Sequence:
    """Dispatch on layout: TUM (rgb.txt), KITTI (sequences/), or image dir."""
    if os.path.exists(os.path.join(path, "rgb.txt")):
        return load_tum_rgbd(path, **kw)
    if os.path.isdir(os.path.join(path, "sequences")):
        return load_kitti_odometry(path, **kw)
    return load_image_dir(path, **kw)

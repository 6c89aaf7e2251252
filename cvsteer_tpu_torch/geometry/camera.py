"""Camera intrinsics, Brown-Conrady distortion, pixel <-> ray conversions
(twin of cvsteer_tpu.geometry.camera; OpenCV's (k1, k2, p1, p2, k3) model).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_NO_DIST: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)


class Intrinsics(NamedTuple):
    """Pinhole intrinsics + optional distortion ``dist = (k1, k2, p1, p2, k3)``;
    all-zero (the default) is the pure pinhole model."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, float, float, float, float] = _NO_DIST

    @property
    def matrix(self) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(float(d) != 0.0 for d in self.dist)


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Ideal normalized (x, y) [..., 2] -> distorted normalized coords."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_d: torch.Tensor, dist, iterations: int = 8) -> torch.Tensor:
    """Distorted normalized coords [..., 2] -> ideal normalized (x, y), by
    the fixed-point inversion cv2.undistortPoints uses."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def normalize_pixels(yx: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Pixel (row, col) [..., 2] -> ideal normalized rays (x, y) [..., 2]."""
    x = (yx[..., 1] - K.cx) / K.fx
    y = (yx[..., 0] - K.cy) / K.fy
    xy = torch.stack([x, y], dim=-1)
    if K.has_distortion:
        xy = undistort_normalized(xy, K.dist)
    return xy


def pixels_from_normalized(xy: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Ideal normalized (x, y) [..., 2] -> pixel (row, col) [..., 2]."""
    if K.has_distortion:
        xy = distort_normalized(xy, K.dist)
    col = xy[..., 0] * K.fx + K.cx
    row = xy[..., 1] * K.fy + K.cy
    return torch.stack([row, col], dim=-1)


def undistort_normalized_np(xy_d: np.ndarray, dist, iterations: int = 8) -> np.ndarray:
    """NumPy twin of :func:`undistort_normalized` for host-side paths."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], -1).astype(xy_d.dtype)

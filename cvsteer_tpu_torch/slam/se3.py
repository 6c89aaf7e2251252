"""SO(3)/SE(3) operations (twin of cvsteer_tpu.slam.se3).

Rotations are [..., 3, 3] matrices; rigid transforms (R, t) act as
x -> R x + t. Tangent vectors xi = (omega[3], v[3]), rotation first.
Closed forms with Taylor fallbacks near theta = 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        -2,
    )


def _abc_coefficients(w: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), [..., 1, 1]."""
    th2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-8
    th2_safe = torch.where(small, 1.0, th2)
    theta = torch.sqrt(th2_safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(theta)) / th2_safe)
    c = torch.where(
        small, 1.0 / 6.0 - th2 / 120.0, (theta - torch.sin(theta)) / (th2_safe * theta)
    )
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    W = hat(w)
    a, b, _ = _abc_coefficients(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] (angle in [0, pi])."""
    w_vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )  # = 2 sin(theta) * axis
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    sin2 = 0.25 * torch.sum(w_vee * w_vee, dim=-1)
    small_sin = sin2 < 1e-12
    sin = torch.sqrt(torch.where(small_sin, 1.0, sin2))
    sin = torch.where(small_sin, 0.0, sin)
    theta = torch.atan2(sin, cos)
    small = theta < 1e-4
    factor = torch.where(
        small, 0.5 + theta * theta / 12.0, theta / torch.where(small_sin, 1.0, 2.0 * sin)
    )
    w = factor[..., None] * w_vee
    # near pi: recover the axis from the diagonal of R + I
    near_pi = cos < -1.0 + 1e-6
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    sgn = torch.where(w_vee >= 0.0, 1.0, -1.0)
    w_pi = axis * sgn * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def exp_se3(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 6] (omega, v) -> (R [..., 3, 3], t [..., 3])."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    a, b, c = _abc_coefficients(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return R, (V @ v[..., None])[..., 0]


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) . (Rb, tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def invert(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, X):
    """Apply to points X [..., 3]."""
    return (R @ X[..., None])[..., 0] + t


def rotation_geodesic(Ra, Rb) -> torch.Tensor:
    """Angle between rotations (radians)."""
    M = Ra.transpose(-1, -2) @ Rb
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))

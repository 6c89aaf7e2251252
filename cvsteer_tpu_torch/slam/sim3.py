"""Sim(3) group operations: similarity transforms (s, R, t) acting as
x -> s R x + t (twin of cvsteer_tpu.slam.sim3).

Tangent chart (omega[3], v[3], sigma): R = exp(omega), s = exp(sigma), and
the translation applied directly (the pose-graph solver needs only a
consistent local chart around 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvsteer_tpu_torch.slam import se3


class Sim3(NamedTuple):
    """s [...], R [..., 3, 3], t [..., 3] acting as x -> s R x + t."""

    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor


def identity(batch_shape=(), device=None) -> Sim3:
    """The identity transform, of shape ``batch_shape``."""
    batch_shape = tuple(batch_shape)
    return Sim3(
        s=torch.ones(batch_shape, device=device),
        R=torch.eye(3, device=device).expand(batch_shape + (3, 3)),
        t=torch.zeros(batch_shape + (3,), device=device),
    )


def compose(a: Sim3, b: Sim3) -> Sim3:
    """a o b (apply b first)."""
    return Sim3(
        s=a.s * b.s,
        R=a.R @ b.R,
        t=a.s[..., None] * (a.R @ b.t[..., None])[..., 0] + a.t,
    )


def invert(a: Sim3) -> Sim3:
    Rt = a.R.transpose(-1, -2)
    s_inv = 1.0 / a.s
    return Sim3(s=s_inv, R=Rt, t=-s_inv[..., None] * (Rt @ a.t[..., None])[..., 0])


def transform(a: Sim3, X: torch.Tensor) -> torch.Tensor:
    return a.s[..., None] * (a.R @ X[..., None])[..., 0] + a.t


def exp(xi: torch.Tensor) -> Sim3:
    """Tangent [..., 7] = (omega, v, sigma) -> Sim3."""
    return Sim3(s=torch.exp(xi[..., 6]), R=se3.exp_so3(xi[..., :3]), t=xi[..., 3:6])


def log(a: Sim3) -> torch.Tensor:
    """Sim3 -> [..., 7]; inverse of :func:`exp` on its chart."""
    return torch.cat([se3.log_so3(a.R), a.t, torch.log(a.s)[..., None]], dim=-1)


def from_se3(R: torch.Tensor, t: torch.Tensor, s=None) -> Sim3:
    if s is None:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    return Sim3(s=torch.as_tensor(s, dtype=R.dtype, device=R.device), R=R, t=t)

"""Pose recovery from an essential matrix + DLT triangulation (twin of
cvsteer_tpu.geometry.pose): cheirality voting over the 4 (R, t)
candidates; inhomogeneous DLT solved in closed form via the adjugate."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cvsteer_tpu_torch.utils.precision import precise


@precise()
def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E -> (R1, R2, t) with ||t|| = 1; candidates are (R1|R2) x (+-t)."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device
    )
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, U[:, 2]


def _projection(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[3, 4] projection for normalized cameras: x = [R | t] X."""
    return torch.cat([R, t[:, None]], dim=1)


@precise()
def triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: euclidean points [N, 3] from normalized image
    coordinates [N, 2] under projections P1/P2 [3, 4]. The 4 DLT rows give
    the least-squares system A[:, :3] X = -A[:, 3], whose 3x3 normal
    equations invert via the adjugate."""
    rows = torch.stack(
        [
            x1[..., 0:1] * P1[2] - P1[0],
            x1[..., 1:2] * P1[2] - P1[1],
            x2[..., 0:1] * P2[2] - P2[0],
            x2[..., 1:2] * P2[2] - P2[1],
        ],
        dim=-2,
    )  # [N, 4, 4]
    B = rows[..., :3]
    c = rows[..., 3]
    M = torch.einsum("...ij,...ik->...jk", B, B)
    r = -torch.einsum("...ij,...i->...j", B, c)
    a, b_, cc = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f = M[..., 1, 1], M[..., 1, 2]
    i = M[..., 2, 2]
    A_ = e * i - f * f
    Bc = cc * f - b_ * i
    Cc = b_ * f - cc * e
    E_ = a * i - cc * cc
    F_ = cc * b_ - a * f
    I_ = a * e - b_ * b_
    det = a * A_ + b_ * Bc + cc * Cc
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    x = (A_ * r[..., 0] + Bc * r[..., 1] + Cc * r[..., 2]) * inv_det
    y = (Bc * r[..., 0] + E_ * r[..., 1] + F_ * r[..., 2]) * inv_det
    z = (Cc * r[..., 0] + F_ * r[..., 1] + I_ * r[..., 2]) * inv_det
    return torch.stack([x, y, z], dim=-1)


class TwoViewPose(NamedTuple):
    R: torch.Tensor  # [3, 3] rotation camera1 -> camera2
    t: torch.Tensor  # [3] unit translation
    points: torch.Tensor  # [N, 3] triangulated points in camera-1 frame
    cheirality: torch.Tensor  # [N] bool: point in front of both cameras
    num_good: torch.Tensor


@precise()
def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor) -> TwoViewPose:
    """Select the (R, t) candidate with the best cheirality vote."""
    R1, R2, t = decompose_essential(E)
    P1 = torch.cat(
        [torch.eye(3, dtype=E.dtype, device=E.device),
         torch.zeros((3, 1), dtype=E.dtype, device=E.device)], dim=1,
    )
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    scores, Xs, goods = [], [], []
    for R, tt in cands:
        X = triangulate(P1, _projection(R, tt), x1, x2)
        z1 = X[:, 2]
        z2 = (X @ R.T + tt)[:, 2]
        good = (z1 > 0) & (z2 > 0) & valid
        scores.append(good.sum())
        Xs.append(X)
        goods.append(good)
    scores = torch.stack(scores)
    best = torch.argmax(scores)
    return TwoViewPose(
        R=torch.stack([c[0] for c in cands])[best],
        t=torch.stack([c[1] for c in cands])[best],
        points=torch.stack(Xs)[best],
        cheirality=torch.stack(goods)[best],
        num_good=scores[best],
    )

"""Phase descriptors from the steered quadrature pair (twin of the G2 path
of cvsteer_tpu.features.descriptors).

Recipe: a G x G grid of sample offsets (spacing in pixels) rotated by the
keypoint's dominant orientation theta; at each sample the 7 basis
responses are bilinearly interpolated (kernel D on the card) and steered
to theta; the (g2, h2) pairs of all samples form a vector [2 G^2] that is
L2-normalized. Every step but the sampling is elementwise per keypoint,
so the keypoints of all pyramid levels go through it together
(:func:`phase_descriptors_levels`, one kernel D launch per frame).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cvsteer_tpu_torch.features.keypoints import Keypoints
from cvsteer_tpu_torch.filters.g2 import G2A, G2B, G2C, H2A, H2B, H2C, H2D
from cvsteer_tpu_torch.ops.cuda_desc import sample_patches, sample_patches_levels


def _grid_offsets(grid: int, spacing: float) -> np.ndarray:
    """[G*G, 2] (dy, dx) offsets centered on the keypoint."""
    c = (grid - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    return np.stack([(ys - c) * spacing, (xs - c) * spacing], -1).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _grid_offsets_on(grid: int, spacing: float, device: str) -> torch.Tensor:
    """_grid_offsets as a float32 tensor on ``device``, made once: a copy
    from host memory each call would make the host wait for the device
    (read only; cached per grid, spacing and device)."""
    return torch.as_tensor(_grid_offsets(grid, spacing), dtype=torch.float32, device=device)


def _rotated_grid_coords(keypoints: Keypoints, grid: int, spacing: float):
    """(ys, xs [..., N, S], ct, st [..., N]): keypoint-oriented grid
    coordinates; broadcasts over any leading batch axes."""
    offsets = _grid_offsets_on(grid, float(spacing), str(keypoints.yx.device))
    theta = keypoints.theta
    ct, st = torch.cos(theta), torch.sin(theta)
    dy = offsets[:, 0] * ct[..., None] - offsets[:, 1] * st[..., None]
    dx = offsets[:, 0] * st[..., None] + offsets[:, 1] * ct[..., None]
    ys = keypoints.yx[..., 0:1] + dy
    xs = keypoints.yx[..., 1:2] + dx
    return ys, xs, ct, st


def _rotated_grid_samples_batch(
    basis: torch.Tensor, keypoints: Keypoints, grid: int, spacing: float
):
    """(samples [B, N, S, C], ct, st [B, N]) — kernel D on the card."""
    ys, xs, ct, st = _rotated_grid_coords(keypoints, grid, spacing)
    samples = sample_patches(basis.contiguous(), ys.contiguous(), xs.contiguous())
    return samples, ct, st


def _canonicalize_pi(g_even: torch.Tensor, h_odd: torch.Tensor):
    """Make the descriptor invariant to the orientation's pi ambiguity: a pi
    flip of theta is a point reflection of the (point-symmetric) sample
    grid plus a sign flip of the odd half, so flip when sum(h) < 0."""
    flip = torch.sum(h_odd, dim=-1, keepdim=True) < 0
    g_c = torch.where(flip, g_even.flip(-1), g_even)
    h_c = torch.where(flip, -h_odd.flip(-1), h_odd)
    return g_c, h_c


def _steer_g2_normalize(samples, ct, st, valid, pi_invariant: bool = False):
    """Steer (g2, h2) per keypoint and L2-normalize; broadcasts over any
    leading batch axes (samples [..., S, C], ct/st/valid [...])."""
    ct2, st2 = ct * ct, st * st
    ct3, st3 = ct2 * ct, st2 * st

    def w(v):
        return v[..., None]

    g2 = (
        w(ct2) * samples[..., G2A]
        - 2.0 * w(ct * st) * samples[..., G2B]
        + w(st2) * samples[..., G2C]
    )
    h2 = (
        w(ct3) * samples[..., H2A]
        - 3.0 * w(ct2 * st) * samples[..., H2B]
        + 3.0 * w(ct * st2) * samples[..., H2C]
        - w(st3) * samples[..., H2D]
    )
    if pi_invariant:
        g2, h2 = _canonicalize_pi(g2, h2)
    desc = torch.cat([g2, h2], dim=-1)  # [..., 2*S]
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp_min(norm, 1e-12)
    return torch.where(valid[..., None], desc, 0.0)


def phase_descriptors_batch(
    basis: torch.Tensor,
    keypoints: Keypoints,
    *,
    grid: int = 4,
    spacing: float = 3.0,
    pi_invariant: bool = False,
) -> torch.Tensor:
    """``basis [B, 7, H, W]``, keypoint fields ``[B, N, ...]`` ->
    descriptors ``[B, N, grid*grid*2]``."""
    samples, ct, st = _rotated_grid_samples_batch(basis, keypoints, grid, spacing)
    return _steer_g2_normalize(
        samples, ct, st, keypoints.valid, pi_invariant=pi_invariant
    )


def phase_descriptors_levels(
    bases,
    keypoints: Keypoints,
    counts,
    *,
    grid: int = 4,
    spacing: float = 3.0,
    pi_invariant: bool = False,
) -> torch.Tensor:
    """Descriptors of several pyramid levels' keypoints at once: ``bases``
    one ``[B, 7, H_l, W_l]`` per level, keypoint fields ``[B, N, ...]``
    holding ``counts[l]`` keypoints of level l after those of the levels
    before it (level coordinates) -> ``[B, N, grid*grid*2]``, the same
    values as :func:`phase_descriptors_batch` level by level."""
    ys, xs, ct, st = _rotated_grid_coords(keypoints, grid, spacing)
    samples = sample_patches_levels(bases, ys.contiguous(), xs.contiguous(), counts)
    return _steer_g2_normalize(
        samples, ct, st, keypoints.valid, pi_invariant=pi_invariant
    )

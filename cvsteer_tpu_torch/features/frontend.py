"""Multi-scale feature extraction: pyramid -> detector maps -> keypoints +
phase descriptors (twin of cvsteer_tpu.features.frontend).

The structure is the reference's fused TPU path (_extract_features_tpu),
on every device: per pyramid level one g2_features_full call (kernels A + C
on the card) produces the basis and the packed selection maps, top-k runs
on the 3x3-cell table (detect_keypoints_packed), and descriptors sample
the basis (kernel D on the card). The pyramid is kernel B. On a CPU tensor
the same structure runs with the kernels' plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvsteer_tpu_torch.features.descriptors import phase_descriptors_batch
from cvsteer_tpu_torch.features.keypoints import detect_keypoints_packed
from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.ops.cuda_frontend import g2_features_full
from cvsteer_tpu_torch.ops.pyramid import gaussian_pyramid


class FrontendConfig(NamedTuple):
    """The reference's FrontendConfig, field for field.

    Ported: order 2, score 'corner', nms_radius >= 2 (the packed selection
    needs at most one NMS survivor per 3x3 cell), upright_desc,
    desc_pi_invariant, level_capacity_decay. Descriptor sampling is fp32 in
    the port whatever ``desc_fp32_sampling`` says (kernel D reads fp32
    corners), so that field changes nothing here."""

    levels: int = 5
    keypoints_per_level: int = 256
    nms_radius: int = 2
    threshold: float = 1.0
    descriptor_grid: int = 4
    descriptor_spacing: float = 3.0
    score: str = "corner"
    order: int = 2
    level_capacity_decay: float = 1.0
    upright_desc: bool = False
    desc_pi_invariant: bool = False
    desc_fp32_sampling: bool = False

    def level_capacity(self, level: int) -> int:
        if self.level_capacity_decay == 1.0:
            return self.keypoints_per_level
        c = self.keypoints_per_level * (self.level_capacity_decay ** level)
        return max(32, int(c) // 8 * 8)

    @property
    def capacity(self) -> int:
        return sum(self.level_capacity(l) for l in range(self.levels))

    @property
    def descriptor_dim(self) -> int:
        return 2 * self.descriptor_grid * self.descriptor_grid


class Features(NamedTuple):
    """Fixed-capacity multi-scale features for one image (or a batch).

    yx:    [..., N, 2] level-0 pixel coordinates.
    score: [..., N] detector response.
    theta: [..., N] dominant orientation.
    level: [..., N] pyramid level (int32).
    desc:  [..., N, D] unit descriptors.
    valid: [..., N] mask.
    """

    yx: torch.Tensor
    score: torch.Tensor
    theta: torch.Tensor
    level: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def _check_config(cfg: FrontendConfig) -> None:
    if cfg.order == 4:
        raise NotImplementedError(
            "G4/H4 features are not ported yet (a later PR ports filters/g4.py)"
        )
    if cfg.order != 2:
        raise ValueError(f"order must be 2 or 4, got {cfg.order}")
    if cfg.score != "corner":
        raise NotImplementedError(
            f"score={cfg.score!r} is not ported yet (the generic detector "
            "path comes with a later PR)"
        )
    if cfg.nms_radius < 2:
        raise NotImplementedError(
            "nms_radius < 2 needs the generic detector path, not ported yet"
        )


def extract_features(
    images: torch.Tensor,
    bank=None,
    cfg: FrontendConfig = FrontendConfig(),
) -> Features:
    """Features of ``images [H, W]`` or ``[B, H, W]`` (any float dtype; the
    features live on the images' device)."""
    _check_config(cfg)
    if bank is None:
        bank = fg2.g2_bank()
    single = images.dim() == 2
    imgs = (images[None] if single else images).to(torch.float32).contiguous()
    levels = gaussian_pyramid(imgs, cfg.levels)
    parts = []
    for lvl, lv_imgs in enumerate(levels):
        p3, dym, dxm, ctm, stm, basis = g2_features_full(
            lv_imgs, bank.xtaps, bank.ytaps,
            threshold=cfg.threshold, nms_radius=cfg.nms_radius,
        )
        kp = detect_keypoints_packed(
            p3, dym, dxm, ctm, stm, max_keypoints=cfg.level_capacity(lvl)
        )
        kp_d = kp._replace(theta=torch.zeros_like(kp.theta)) if cfg.upright_desc else kp
        desc = phase_descriptors_batch(
            basis, kp_d,
            grid=cfg.descriptor_grid, spacing=cfg.descriptor_spacing,
            pi_invariant=cfg.desc_pi_invariant,
        )
        parts.append(Features(
            yx=kp.yx * float(2**lvl),
            score=kp.score,
            theta=kp.theta,
            level=torch.full(kp.score.shape, lvl, dtype=torch.int32, device=imgs.device),
            desc=desc,
            valid=kp.valid,
        ))
    feats = Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))
    if single:
        feats = Features(*(x[0] for x in feats))
    return feats

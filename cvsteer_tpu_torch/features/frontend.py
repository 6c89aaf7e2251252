"""Multi-scale feature extraction: pyramid -> detector maps -> keypoints +
phase descriptors (twin of cvsteer_tpu.features.frontend).

The structure is the reference's fused TPU path (_extract_features_tpu),
on every device: one g2_features_levels call (one kernel C launch on the
card) produces every level's basis and packed selection maps, top-k runs
per level on the 3x3-cell table (detect_keypoints_packed), and the
descriptors of all levels' keypoints are computed together, sampling each
level's basis (one kernel D launch). The pyramid is kernel B. On a CPU
tensor the same structure runs with the kernels' plain versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.features.descriptors import phase_descriptors_levels
from cvsteer_tpu_torch.features.keypoints import Keypoints, detect_keypoints_packed
from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.ops.cuda_frontend import g2_features_levels
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
            "G4/H4 features are not ported yet: they need the generic detector "
            "path (detect_keypoints, detect_keypoints_cs, "
            "detect_keypoints_premasked) and the G4 descriptors "
            "(phase_descriptors_g4); the G4/H4 bank itself is ported"
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


@functools.lru_cache(maxsize=None)
def _level_tables(counts: Tuple[int, ...], device: str):
    """(scale [N] float32, level [N] int32): each keypoint's level-0 scale
    2^l and its level, for ``counts[l]`` keypoints of each level l. Read
    only; cached per layout and device."""
    level = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    scale = np.exp2(level).astype(np.float32)
    return torch.from_numpy(scale).to(device), torch.from_numpy(level).to(device)


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
    maps = g2_features_levels(
        levels, bank.xtaps, bank.ytaps, threshold=cfg.threshold, nms_radius=cfg.nms_radius
    )
    kps = [
        detect_keypoints_packed(p3, dym, dxm, ctm, stm, max_keypoints=cfg.level_capacity(lvl))
        for lvl, (p3, dym, dxm, ctm, stm, _) in enumerate(maps)
    ]
    counts = tuple(k.capacity for k in kps)
    kp = Keypoints(*(torch.cat(f, dim=1) for f in zip(*kps)))  # level coordinates
    kp_d = kp._replace(theta=torch.zeros_like(kp.theta)) if cfg.upright_desc else kp
    desc = phase_descriptors_levels(
        [m[5] for m in maps], kp_d, counts,
        grid=cfg.descriptor_grid, spacing=cfg.descriptor_spacing,
        pi_invariant=cfg.desc_pi_invariant,
    )
    scale, level = _level_tables(counts, str(imgs.device))
    feats = Features(
        yx=kp.yx * scale[:, None],
        score=kp.score,
        theta=kp.theta,
        level=level.expand(kp.score.shape).clone(),
        desc=desc,
        valid=kp.valid,
    )
    if single:
        feats = Features(*(x[0] for x in feats))
    return feats

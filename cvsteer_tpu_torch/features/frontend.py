"""Multi-scale feature extraction: pyramid -> detector maps -> keypoints +
phase descriptors (twin of cvsteer_tpu.features.frontend).

Two structures, as in the reference:

- the fused path (the reference's _extract_features_tpu), for order 2 with
  the corner score and nms_radius >= 2, on every device: one
  g2_features_levels call (one kernel C launch on the card) produces every
  level's basis and packed selection maps, top-k runs per level on the
  3x3-cell table (detect_keypoints_packed);
- the generic path (_extract_features_generic) for order 4, the
  'strength' score and nms_radius < 2: per level the basis (kernel A with
  the G2 or the G4/H4 bank), the energy coefficients and the score maps in
  plain PyTorch, then NMS, exact top-k and subpixel refinement
  (detect_keypoints_cs).

Both sample the descriptors of all levels' keypoints together, each level's
keypoints from its basis (one kernel D launch, C = 7 or 11; the reference
samples per level, with the same values). The pyramid is kernel B. On a
CPU tensor the same structures run with the kernels' plain versions.

Each call is the program span ``features.extract`` (attrs ``frames``, the
batch size, and ``path``, ``fused`` or ``generic``) with the children
``features.pyramid``, ``features.level`` (one per level in the generic
path, attr ``level``; the fused path's levels as one), ``features.descriptors``
and ``features.assemble`` (utils/profiling.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.features.descriptors import phase_descriptors_levels
from cvsteer_tpu_torch.features.keypoints import (
    Keypoints,
    detect_keypoints_cs,
    detect_keypoints_packed,
)
from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.filters import g4 as fg4
from cvsteer_tpu_torch.ops.cuda_frontend import g2_features_levels
from cvsteer_tpu_torch.ops.pyramid import gaussian_pyramid
from cvsteer_tpu_torch.utils.profiling import annotate


class FrontendConfig(NamedTuple):
    """The reference's FrontendConfig, field for field.

    ``order`` 2 (G2/H2) or 4 (G4/H4); ``score`` 'corner' (c1 - |(c2, c3)|)
    or 'strength' (|(c2, c3)|). Order 2 with the corner score and
    nms_radius >= 2 (at most one NMS survivor per 3x3 cell) takes the fused
    path, everything else the generic one. Descriptor sampling is fp32 in
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
    if cfg.order not in (2, 4):
        raise ValueError(f"order must be 2 or 4, got {cfg.order}")


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
    features live on the images' device). ``bank`` must match ``cfg.order``
    when given."""
    _check_config(cfg)
    single = images.dim() == 2
    # the packed cells need nms_radius >= 2
    fused = cfg.order == 2 and cfg.score == "corner" and cfg.nms_radius >= 2
    with annotate("features.extract", frames=1 if single else int(images.shape[0]),
                  path="fused" if fused else "generic"):
        imgs = (images[None] if single else images).to(torch.float32).contiguous()
        if fused:
            feats = _extract_features_fused(imgs, fg2.g2_bank() if bank is None else bank, cfg)
        elif cfg.order == 4:
            bank = fg4.g4_bank() if bank is None else bank
            feats = _extract_features_generic(
                imgs, cfg, basis_fn=lambda im: fg4.g4_basis(im, bank),
                coeff_fn=fg4.energy_coefficients,
            )
        else:
            bank = fg2.g2_bank() if bank is None else bank
            feats = _extract_features_generic(
                imgs, cfg, basis_fn=lambda im: fg2.g2_basis(im, bank),
                coeff_fn=fg2.energy_coefficients,
            )
        if single:
            feats = Features(*(x[0] for x in feats))
        return feats


def _assemble(kp: Keypoints, desc: torch.Tensor, counts, device) -> Features:
    """Features from the levels' keypoints one after the other (level
    coordinates, ``counts[l]`` of level l) and their descriptors."""
    scale, level = _level_tables(tuple(counts), str(device))
    return Features(
        yx=kp.yx * scale[:, None],
        score=kp.score,
        theta=kp.theta,
        level=level.expand(kp.score.shape).clone(),
        desc=desc,
        valid=kp.valid,
    )


def _extract_features_fused(imgs: torch.Tensor, bank, cfg: FrontendConfig) -> Features:
    """The fused path on ``imgs [B, H, W]`` float32."""
    with annotate("features.pyramid"):
        levels = gaussian_pyramid(imgs, cfg.levels)
    with annotate("features.level"):
        maps = g2_features_levels(
            levels, bank.xtaps, bank.ytaps, threshold=cfg.threshold, nms_radius=cfg.nms_radius
        )
        kps = [
            detect_keypoints_packed(p3, dym, dxm, ctm, stm, max_keypoints=cfg.level_capacity(lvl))
            for lvl, (p3, dym, dxm, ctm, stm, _) in enumerate(maps)
        ]
    return _describe([m[5] for m in maps], kps, cfg, imgs.device)


def _describe(bases, kps, cfg: FrontendConfig, device) -> Features:
    """Every level's descriptors in one sampling call, then the Features:
    the tail both paths share."""
    with annotate("features.descriptors"):
        counts = tuple(k.capacity for k in kps)
        kp = Keypoints(*(torch.cat(f, dim=1) for f in zip(*kps)))  # level coordinates
        kp_d = kp._replace(theta=torch.zeros_like(kp.theta)) if cfg.upright_desc else kp
        desc = phase_descriptors_levels(
            bases, kp_d, counts, grid=cfg.descriptor_grid, spacing=cfg.descriptor_spacing,
            pi_invariant=cfg.desc_pi_invariant,
        )
    with annotate("features.assemble"):
        return _assemble(kp, desc, counts, device)


def _score_maps(lv_imgs, *, basis_fn, coeff_fn, score: str = "corner"):
    """(basis, score, ct, st) of one pyramid level ``[B, H, W]``: the front
    half of the per-level pipeline (also the sharded front-end's)."""
    basis = basis_fn(lv_imgs)  # [B, K, H, W]
    c1, c2, c3 = coeff_fn(basis)
    theta, strength = fg2.dominant_orientation(c2, c3)
    score_map = fg2.corner_strength(c1, c2, c3) if score == "corner" else strength
    return basis, score_map, torch.cos(theta), torch.sin(theta)


def _level_keypoints(lv_imgs, lvl: int, cfg: FrontendConfig, *, basis_fn, coeff_fn,
                     approx: bool = False):
    """(basis, keypoints in level coordinates) of one pyramid level: basis
    -> score -> NMS, exact top-k and subpixel refinement."""
    basis, score_map, ctm, stm = _score_maps(
        lv_imgs, basis_fn=basis_fn, coeff_fn=coeff_fn, score=cfg.score
    )
    kp = detect_keypoints_cs(
        score_map, ctm, stm, max_keypoints=cfg.level_capacity(lvl),
        nms_radius=cfg.nms_radius, threshold=cfg.threshold, approx=approx,
    )
    return basis, kp


def _level_features(lv_imgs, lvl: int, cfg: FrontendConfig, *, basis_fn, coeff_fn,
                    desc_batch_fn, approx: bool = False) -> Features:
    """One whole pyramid level: basis -> score -> detect -> descriptors
    (``desc_batch_fn``: phase_descriptors_batch or phase_descriptors_g4_batch,
    sampling this level alone), coordinates in level-0 pixels."""
    basis, kp = _level_keypoints(
        lv_imgs, lvl, cfg, basis_fn=basis_fn, coeff_fn=coeff_fn, approx=approx
    )
    kp_d = kp._replace(theta=torch.zeros_like(kp.theta)) if cfg.upright_desc else kp
    desc = desc_batch_fn(
        basis, kp_d, grid=cfg.descriptor_grid, spacing=cfg.descriptor_spacing,
        pi_invariant=cfg.desc_pi_invariant,
    )
    scale = float(2**lvl)
    return Features(
        yx=kp.yx * scale,
        score=kp.score,
        theta=kp.theta,
        level=torch.full(kp.score.shape, lvl, dtype=torch.int32, device=kp.score.device),
        desc=desc,
        valid=kp.valid,
    )


def _extract_features_generic(imgs: torch.Tensor, cfg: FrontendConfig, *, basis_fn,
                              coeff_fn) -> Features:
    """The order-agnostic path on ``imgs [B, H, W]`` float32: pyramid ->
    basis -> energy coefficients -> detector per level, then every level's
    descriptors in one sampling call. The 2nd-harmonic (c1, c2, c3) mean
    the same for both orders (filters.g4.energy_coefficients)."""
    with annotate("features.pyramid"):
        levels = gaussian_pyramid(imgs, cfg.levels)
    bases, kps = [], []
    for lvl, lv in enumerate(levels):
        with annotate("features.level", level=lvl):
            basis, kp = _level_keypoints(lv, lvl, cfg, basis_fn=basis_fn, coeff_fn=coeff_fn)
        bases.append(basis)
        kps.append(kp)
    return _describe(bases, kps, cfg, imgs.device)

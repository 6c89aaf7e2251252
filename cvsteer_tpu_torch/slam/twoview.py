"""Two-view reconstruction: images in, relative pose and sparse points out
(twin of cvsteer_tpu.slam.twoview; BASELINE config 3 as one call).

Steerable features -> descriptor matching -> essential RANSAC ->
cheirality-voted pose -> triangulation, all on the images' device. RANSAC
draws its minimal sets from a ``torch.Generator`` (seeded 0 when none is
given), or takes them injected (``sets``, the test seam the tests use to
feed the reference's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig, extract_features
from cvsteer_tpu_torch.features.matching import match_descriptors
from cvsteer_tpu_torch.geometry.camera import Intrinsics, normalize_pixels
from cvsteer_tpu_torch.geometry.epipolar import ransac_essential
from cvsteer_tpu_torch.geometry.pose import recover_pose
from cvsteer_tpu_torch.utils.precision import precise


class TwoViewResult(NamedTuple):
    """R/t: camera-a -> camera-b (||t|| = 1); points in the camera-a frame."""

    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor  # [N, 3] triangulated matches (camera-a frame)
    point_valid: torch.Tensor  # [N] inlier & cheirality mask
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    E: torch.Tensor


def two_view_pose(
    image_a: torch.Tensor,
    image_b: torch.Tensor,
    intrinsics: Intrinsics,
    *,
    cfg: FrontendConfig = FrontendConfig(),
    match_ratio: float = 0.85,
    ransac_hypotheses: int = 512,
    ransac_threshold_px: float = 1.5,
    generator: Optional[torch.Generator] = None,
    sets: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Relative pose between two grayscale images ``[H, W]`` (on their
    device). ``ransac_threshold_px``: Sampson inlier bound in pixels."""
    return two_view_pose_from_features(
        extract_features(image_a, cfg=cfg), extract_features(image_b, cfg=cfg), intrinsics,
        match_ratio=match_ratio, ransac_hypotheses=ransac_hypotheses,
        ransac_threshold_px=ransac_threshold_px, generator=generator, sets=sets,
    )


@precise()
def two_view_pose_from_features(
    fa: Features,
    fb: Features,
    intrinsics: Intrinsics,
    *,
    match_ratio: float = 0.85,
    ransac_hypotheses: int = 512,
    ransac_threshold_px: float = 1.5,
    generator: Optional[torch.Generator] = None,
    sets: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    if generator is None and sets is None:
        generator = torch.Generator(device=fa.desc.device).manual_seed(0)
    f_mean = 0.5 * (intrinsics.fx + intrinsics.fy)
    m = match_descriptors(fa.desc, fa.valid, fb.desc, fb.valid, ratio=match_ratio)
    xa = normalize_pixels(fa.yx, intrinsics)
    xb = normalize_pixels(fb.yx, intrinsics)[torch.clamp_min(m.index, 0)]
    res = ransac_essential(
        xa, xb, m.valid, generator, num_hypotheses=ransac_hypotheses,
        inlier_threshold=(ransac_threshold_px / f_mean) ** 2, sets=sets,
    )
    pose = recover_pose(res.E, xa, xb, res.inliers)
    return TwoViewResult(
        R=pose.R, t=pose.t, points=pose.points, point_valid=pose.cheirality & res.inliers,
        num_matches=m.count, num_inliers=res.num_inliers, E=res.E,
    )

"""Gaussian image pyramids (the twin of cvsteer_tpu.ops.pyramid).

Downsampling follows cv2.pyrDown: the 5-tap binomial blur [1,4,6,4,1]/16
applied separably with REFLECT_101 borders, then decimation by 2 keeping
even indices. Level l has shape ceil(H / 2^l) x ceil(W / 2^l). On the card
the whole pyramid is one launch of kernel B (ops.cuda_frontend.
pyr_down_levels), which takes any shape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cvsteer_tpu_torch.ops.cuda_frontend import _BINOMIAL5, filter_bank, pyr_down, pyr_down_levels


def blur5(image: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur with REFLECT_101 borders (kernel A)."""
    taps = _BINOMIAL5.reshape(1, -1)
    return filter_bank(image, taps, taps)[..., 0, :, :]


def gaussian_pyramid(image: torch.Tensor, levels: int = 5) -> Tuple[torch.Tensor, ...]:
    """``levels`` images, level 0 being the input: [..., H/2^l, W/2^l]."""
    return pyr_down_levels(image, levels)


def level_shapes(h: int, w: int, levels: int) -> Sequence[Tuple[int, int]]:
    """Static (H, W) per level, matching ``gaussian_pyramid`` (ceil halving)."""
    shapes = [(h, w)]
    for _ in range(levels - 1):
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return shapes


__all__ = ["blur5", "gaussian_pyramid", "level_shapes", "pyr_down"]

"""8-bit conversions of float maps (the twin of cvsteer_tpu.utils.imageproc).

The reference CLI/test turn float maps into 8 bits either with a fixed gain
(cv::Mat::convertTo, example/steer.cpp:95-99) or by min-max normalization to
[0, 255] (cv::normalize NORM_MINMAX, example/steer.cpp:102-104). Both round
half to even as OpenCV's saturate_cast does; torch.round does the same.
"""

from __future__ import annotations

import torch


def normalize_minmax_u8(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Min-max normalize to [0, 255] and round to uint8.

    ``axes``: the axes min/max are taken over (default: all, the per-image
    cv::normalize); for a batch pass the image axes, ``axes=(-2, -1)``.
    bfloat16 maps are normalized in float32."""
    x = x.to(torch.float32)
    if axes is None:
        lo, hi = torch.min(x), torch.max(x)
    else:
        lo = torch.amin(x, dim=axes, keepdim=True)
        hi = torch.amax(x, dim=axes, keepdim=True)
    scale = 255.0 / torch.clamp_min(hi - lo, torch.finfo(torch.float32).tiny)
    y = (x - lo) * scale
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def convert_scale_u8(x: torch.Tensor, gain: float) -> torch.Tensor:
    """Fixed-gain conversion to uint8 with saturation (cv::Mat::convertTo)."""
    return torch.clamp(torch.round(x.to(torch.float32) * gain), 0, 255).to(torch.uint8)


def bgr_to_gray_f32(image_u8: torch.Tensor) -> torch.Tensor:
    """BGR uint8 ``[..., H, W, 3]`` -> float32 grayscale ``[..., H, W]`` in
    0..255: ITU-R BT.601 luma rounded to integers, as cv::cvtColor
    (COLOR_BGR2GRAY) gives for 8-bit input."""
    b = image_u8[..., 0].to(torch.float32)
    g = image_u8[..., 1].to(torch.float32)
    r = image_u8[..., 2].to(torch.float32)
    return torch.round(0.299 * r + 0.587 * g + 0.114 * b)

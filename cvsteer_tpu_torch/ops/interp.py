"""Bilinear sampling for descriptor extraction (twin of cvsteer_tpu.ops.interp).

Fixed-size sets of sample coordinates gather from a channels-last map with
edge clamping: coordinates clip to the image, the +1 corners clamp to the
last row/column. Two accuracy classes, as in the reference package:

- :func:`bilinear_sample_channels_last` — fp32 corners (the accuracy the
  port's descriptor kernel D computes);
- :func:`bilinear_sample_channels_last_pair_bf16` — the reference's
  production class: corners stored in bfloat16 (each pixel paired with its
  right neighbour), combine in fp32.
"""

from __future__ import annotations

import torch


def _corners(H: int, W: int, ys: torch.Tensor, xs: torch.Tensor):
    ys = torch.clamp(ys.reshape(-1), 0.0, H - 1.0)
    xs = torch.clamp(xs.reshape(-1), 0.0, W - 1.0)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    y0, x0 = y0f.long(), x0f.long()
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    return y0, x0, y1, x1, (ys - y0f)[:, None], (xs - x0f)[:, None]


def bilinear_sample_channels_last(
    img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """Sample ``img [H, W, C]`` at float (y, x) coordinates ``[S...]``;
    returns ``[S..., C]``."""
    H, W, C = img.shape
    s_shape = ys.shape
    y0, x0, y1, x1, wy, wx = _corners(H, W, ys, xs)
    flat = img.reshape(H * W, C)
    v00, v01 = flat[y0 * W + x0], flat[y0 * W + x1]
    v10, v11 = flat[y1 * W + x0], flat[y1 * W + x1]
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bot * wy
    return out.reshape(tuple(s_shape) + (C,))


def bilinear_sample_channels_last_pair_bf16(
    img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """Like :func:`bilinear_sample_channels_last` with bfloat16 corners: the
    table pairs each pixel with its right neighbour (edge-clamped)."""
    H, W, C = img.shape
    s_shape = ys.shape
    y0, x0, y1, _, wy, wx = _corners(H, W, ys, xs)
    imgb = img.to(torch.bfloat16)
    right = torch.cat([imgb[:, 1:], imgb[:, -1:]], dim=1)
    tbl = torch.cat([imgb, right], dim=-1).reshape(H * W, 2 * C)
    rt = tbl[y0 * W + x0].to(torch.float32)  # (v00 | v01)
    rb = tbl[y1 * W + x0].to(torch.float32)  # (v10 | v11)
    top = rt[:, :C] * (1.0 - wx) + rt[:, C:] * wx
    bot = rb[:, :C] * (1.0 - wx) + rb[:, C:] * wx
    out = top * (1.0 - wy) + bot * wy
    return out.reshape(tuple(s_shape) + (C,))

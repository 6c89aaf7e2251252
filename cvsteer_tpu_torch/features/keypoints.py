"""Keypoint selection from the packed pooled score map (twin of
cvsteer_tpu.features.keypoints.detect_keypoints_packed).

Kernel C (ops.cuda_frontend.g2_features_full) leaves at every pixel of
``p3`` the centered 3x3-window max of the NMS/threshold/border-masked
corner score, with the winner's (y%3)*3 + x%3 offset in the low 4 mantissa
bits. ``p3[..., 1::3, 1::3]`` is then the non-overlapping 3x3-cell max
table — sound for nms_radius >= 2, which admits at most one survivor per
cell — so top-k runs on 9x fewer elements and each winner's pixel decodes
from its bits. The reference extracted the cells with one-hot MXU matmuls
(_p3_cells), a TPU gather workaround; here it is a plain strided slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvsteer_tpu_torch.ops.cuda_frontend import P3_SENTINEL


class Keypoints(NamedTuple):
    """A fixed-capacity keypoint set (invalid slots masked).

    yx:     [..., N, 2] float32 subpixel (row, col) coordinates.
    score:  [..., N] detector response.
    theta:  [..., N] dominant orientation at the keypoint, (-pi/2, pi/2].
    valid:  [..., N] bool mask.
    """

    yx: torch.Tensor
    score: torch.Tensor
    theta: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.yx.shape[-2]


def detect_keypoints_packed(
    p3: torch.Tensor,
    dy: torch.Tensor,
    dx: torch.Tensor,
    ct: torch.Tensor,
    st: torch.Tensor,
    *,
    max_keypoints: int = 512,
) -> Keypoints:
    """Top-``max_keypoints`` selection from ``p3 [..., H, W]`` (any leading
    batch axes); dy/dx are the per-pixel subpixel offsets and (ct, st) the
    half-angle orientation maps of the same level."""
    *batch, H, W = p3.shape
    B = 1
    for b in batch:
        B *= b
    cells = p3.reshape(B, H, W)[:, 1::3, 1::3]
    Hc, Wc = cells.shape[-2:]
    kk = min(max_keypoints, Hc * Wc)
    vals, cidx = torch.topk(cells.reshape(B, Hc * Wc), kk, dim=-1)
    if kk < max_keypoints:
        pad = max_keypoints - kk
        vals = torch.cat(
            [vals, torch.full((B, pad), float("-inf"), device=p3.device)], -1
        )
        cidx = torch.cat(
            [cidx, torch.zeros((B, pad), dtype=cidx.dtype, device=p3.device)], -1
        )
    # masked cells carry the finite sentinel; padding is -inf
    valid = vals > P3_SENTINEL * 0.5
    bits = vals.contiguous().view(torch.int32)
    off = (bits & 15).long()
    score = (bits & ~15).view(torch.float32)
    yi = (cidx // Wc) * 3 + off // 3
    xi = (cidx % Wc) * 3 + off % 3
    flat_idx = torch.clamp(yi * W + xi, 0, H * W - 1)

    tbl = torch.stack(
        [m.reshape(B, H * W) for m in (dy, dx, ct, st)], -1
    )  # [B, H*W, 4]
    rows = torch.gather(tbl, 1, flat_idx[..., None].expand(-1, -1, 4))
    yx = torch.stack(
        [yi.to(torch.float32) + rows[..., 0], xi.to(torch.float32) + rows[..., 1]],
        dim=-1,
    )
    theta = torch.atan2(rows[..., 3], rows[..., 2])
    out = Keypoints(
        yx=torch.where(valid[..., None], yx, 0.0),
        score=torch.where(valid, score, 0.0),
        theta=torch.where(valid, theta, 0.0),
        valid=valid,
    )
    n = max_keypoints
    return Keypoints(
        yx=out.yx.reshape(*batch, n, 2),
        score=out.score.reshape(*batch, n),
        theta=out.theta.reshape(*batch, n),
        valid=out.valid.reshape(*batch, n),
    )

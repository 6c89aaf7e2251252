"""Keypoint detection (twin of cvsteer_tpu.features.keypoints).

The generic detector (:func:`detect_keypoints`, :func:`detect_keypoints_cs`,
:func:`detect_keypoints_premasked`): local-maximum NMS on a score map,
threshold, border, top-N selection and quadratic subpixel refinement, all
static shapes, over any leading batch axes (the reference vmaps one image
at a time). Selection is exact (``torch.topk``) on every device, which is
what the reference does off the TPU; ``approx`` is accepted and leaves it
exact. ``pool`` keeps its meaning: with ``approx`` the top-k runs on the
maxima of ``pool x pool`` cells, the same set as the full top-k except
where two exactly equal maxima share a cell (see :func:`_select_and_refine`).

The packed selection (:func:`detect_keypoints_packed`): kernel C
(ops.cuda_frontend.g2_features_full) leaves at every pixel of ``p3`` the
centered 3x3-window max of the NMS/threshold/border-masked
corner score, with the winner's (y%3)*3 + x%3 offset in the low 4 mantissa
bits. ``p3[..., 1::3, 1::3]`` is then the non-overlapping 3x3-cell max
table — sound for nms_radius >= 2, which admits at most one survivor per
cell — so top-k runs on 9x fewer elements and each winner's pixel decodes
from its bits. The reference extracted the cells with one-hot MXU matmuls
(_p3_cells), a TPU gather workaround; here it is a plain strided slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

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


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``x [..., H, W]`` as ``[B, H * W]``."""
    return x.reshape(-1, x.shape[-2] * x.shape[-1])


def _masked(valid, yx, scores, theta, batch) -> Keypoints:
    """Keypoints with the invalid slots zeroed, reshaped to ``batch``."""
    n = valid.shape[-1]
    return Keypoints(
        yx=torch.where(valid[..., None], yx, 0.0).reshape(*batch, n, 2),
        score=torch.where(valid, scores, 0.0).reshape(*batch, n),
        theta=torch.where(valid, theta, 0.0).reshape(*batch, n),
        valid=valid.reshape(*batch, n),
    )


def _maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, -inf padded, over the trailing two axes."""
    H, W = x.shape[-2:]
    return F.max_pool2d(x.reshape(-1, 1, H, W), k, stride=1, padding=k // 2).reshape(x.shape)


def _subpixel_offset(ym: torch.Tensor, y0: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """1-D quadratic peak offset in [-0.5, 0.5] from neighbor samples."""
    denom = ym - 2.0 * y0 + yp
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
    return torch.clamp(off, -0.5, 0.5)


def _detect_core(
    strength: torch.Tensor,
    aux: Sequence[torch.Tensor],
    max_keypoints: int,
    nms_radius: int,
    threshold: float,
    border: Optional[int],
    approx: bool,
    row_range=None,
    row_offset: int = 0,
):
    """NMS + top-N selection + subpixel refinement of ``strength [..., H, W]``.

    Returns (yx, scores, valid, aux_rows) over the flattened batch ``[B, N,
    ...]``, ``aux_rows [B, N, len(aux)]`` holding each aux map's value at the
    keypoint. Keypoints lie at least ``border`` (default nms_radius + 1,
    >= 1) pixels from the edge, so the edge-clamped neighbor reads of the
    refinement agree with interior ones. ``row_range=(lo, hi)`` replaces the
    row part of the border mask with a half-open row window (columns keep
    ``border``): a row slab with halos keeps the true NMS neighborhood but
    only the rows it owns produce keypoints (needs 1 <= lo, hi <= H - 1).
    ``row_offset`` is added to each keypoint's integer row before its
    subpixel offset (a slab's rows in image coordinates, rounded as the
    whole image's are).
    """
    H, W = strength.shape[-2:]
    k = 2 * nms_radius + 1
    b = (nms_radius + 1) if border is None else border
    dev = strength.device
    is_max = strength >= _maxpool_same(strength, k)
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    if row_range is None:
        row_ok = (row >= b) & (row < H - b)
    else:
        row_ok = (row >= row_range[0]) & (row < row_range[1])
    in_border = row_ok & (col >= b) & (col < W - b)
    mask = is_max & in_border & (strength > threshold)
    score_masked = torch.where(mask, strength, float("-inf"))
    return _select_and_refine(
        strength, score_masked, aux, max_keypoints, approx, pool=nms_radius + 1 if approx else 1,
        row_offset=row_offset,
    )


def _select_and_refine(
    strength: torch.Tensor,
    score_masked: torch.Tensor,
    aux: Sequence[torch.Tensor],
    max_keypoints: int,
    approx: bool,
    pool: int = 1,
    row_offset: int = 0,
):
    """Top-N selection on a pre-masked score ``[..., H, W]``, then the
    subpixel and aux picks (:func:`_gather_refine`).

    With ``approx`` and ``pool`` = s > 1 the top-k input is first reduced to
    the maxima of s x s cells. That is sound when s <= nms_radius + 1: NMS
    admits no two survivors within Chebyshev distance r (each strictly beats
    its r-window), so a cell holds at most one survivor and the cell top-k is
    the full top-k, on s^2-fold fewer elements. The one divergence: two
    exactly equal maxima within r of each other (ties survive the >= NMS)
    can share a cell and collapse into one. The selection itself is exact
    ``torch.topk`` either way."""
    H, W = strength.shape[-2:]
    sm = score_masked.reshape(-1, H, W)
    B = sm.shape[0]
    kk = min(max_keypoints, H * W)  # tiny pyramid levels: fewer pixels than k
    Hp, Wp = -(-H // pool), -(-W // pool)
    if approx and pool > 1 and kk < Hp * Wp:
        sm = F.pad(sm, (0, Wp * pool - W, 0, Hp * pool - H), value=float("-inf"))
        cells = (
            sm.reshape(B, Hp, pool, Wp, pool).permute(0, 1, 3, 2, 4).reshape(B, Hp * Wp, pool * pool)
        )
        flat_scores, cell_idx = torch.topk(cells.amax(-1), kk, dim=-1)
        rows = torch.gather(cells, 1, cell_idx[..., None].expand(-1, -1, pool * pool))
        off = torch.argmax(rows, dim=-1)
        cy = (cell_idx // Wp) * pool + off // pool
        cx = (cell_idx % Wp) * pool + off % pool
        flat_idx = cy * W + cx  # padded picks are -inf -> masked invalid
    else:
        flat_scores, flat_idx = torch.topk(sm.reshape(B, H * W), kk, dim=-1)
    if kk < max_keypoints:
        pad = max_keypoints - kk
        flat_scores = F.pad(flat_scores, (0, pad), value=float("-inf"))
        flat_idx = F.pad(flat_idx, (0, pad))
    return _gather_refine(strength, aux, flat_scores, flat_idx, row_offset)


def _gather_refine(
    strength: torch.Tensor,
    aux: Sequence[torch.Tensor],
    flat_scores: torch.Tensor,
    flat_idx: torch.Tensor,
    row_offset: int = 0,
):
    """Subpixel offsets and aux picks at preselected flat indices ``[..., N]``
    of ``strength [..., H, W]`` (the edge-clamped 4-neighborhood read at
    computed indices: the reference's shifted-map table, by index)."""
    H, W = strength.shape[-2:]
    n = flat_scores.shape[-1]
    flat_idx = torch.clamp(flat_idx.reshape(-1, n), 0, H * W - 1)  # cross-level padding guard
    flat_scores = flat_scores.reshape(-1, n)
    valid = torch.isfinite(flat_scores)
    yi, xi = flat_idx // W, flat_idx % W
    s = _flat(strength)

    def at(y, x):
        return torch.gather(s, 1, y * W + x)

    s0 = torch.gather(s, 1, flat_idx)
    dy = _subpixel_offset(at((yi - 1).clamp_min(0), xi), s0, at((yi + 1).clamp_max(H - 1), xi))
    dx = _subpixel_offset(at(yi, (xi - 1).clamp_min(0)), s0, at(yi, (xi + 1).clamp_max(W - 1)))
    yx = torch.stack([(yi + row_offset).to(torch.float32) + dy, xi.to(torch.float32) + dx], dim=-1)
    rows = [torch.gather(_flat(a), 1, flat_idx) for a in aux]
    aux_rows = torch.stack(rows, -1) if rows else yx.new_zeros(yx.shape[:-1] + (0,))
    return yx, flat_scores, valid, aux_rows


def refine_selected_cs(
    raw: torch.Tensor,
    ct: torch.Tensor,
    st: torch.Tensor,
    flat_scores: torch.Tensor,
    flat_idx: torch.Tensor,
) -> Keypoints:
    """Keypoints of ``raw [..., H, W]`` at externally selected flat indices
    ``[..., N]`` (a cross-level batched top-k), (ct, st) the half-angle maps."""
    yx, scores, valid, aux = _gather_refine(raw, [ct, st], flat_scores, flat_idx)
    theta = torch.atan2(aux[..., 1], aux[..., 0])
    return _masked(valid, yx, scores, theta, raw.shape[:-2])


def detect_keypoints_premasked(
    raw: torch.Tensor,
    masked: torch.Tensor,
    ct: torch.Tensor,
    st: torch.Tensor,
    *,
    max_keypoints: int = 512,
    approx: bool = False,
    pool: int = 1,
) -> Keypoints:
    """Selection-only detector for pre-masked scores: ``masked`` is -inf
    outside the accepted maxima (NMS, threshold and border applied by the
    caller), ``raw`` the unmasked score (the refinement reads its real
    neighbors), (ct, st) the half-angle maps. ``pool``: the cell
    pre-reduction of :func:`_select_and_refine` (with ``approx``), sound for
    pool <= nms_radius + 1."""
    yx, scores, valid, aux = _select_and_refine(
        raw, masked, [ct, st], max_keypoints, approx, pool=pool
    )
    theta = torch.atan2(aux[..., 1], aux[..., 0])
    return _masked(valid, yx, scores, theta, raw.shape[:-2])


def detect_keypoints(
    strength: torch.Tensor,
    theta: torch.Tensor,
    *,
    max_keypoints: int = 512,
    nms_radius: int = 2,
    threshold: float = 0.0,
    border: Optional[int] = None,
    approx: bool = False,
) -> Keypoints:
    """Up to ``max_keypoints`` local maxima of ``strength [..., H, W]``, each
    with its orientation from ``theta [..., H, W]``. ``border`` (default
    nms_radius + 1) masks a frame where the filter support is incomplete."""
    yx, scores, valid, aux = _detect_core(
        strength, [theta], max_keypoints, nms_radius, threshold, border, approx
    )
    return _masked(valid, yx, scores, aux[..., 0], strength.shape[:-2])


def detect_keypoints_cs(
    strength: torch.Tensor,
    ct: torch.Tensor,
    st: torch.Tensor,
    *,
    max_keypoints: int = 512,
    nms_radius: int = 2,
    threshold: float = 0.0,
    border: Optional[int] = None,
    approx: bool = False,
    row_range=None,
) -> Keypoints:
    """:func:`detect_keypoints` with (cos, sin) orientation maps in place of
    theta: atan2 runs only on the selected keypoints. ``row_range``: see
    :func:`_detect_core`."""
    yx, scores, valid, aux = _detect_core(
        strength, [ct, st], max_keypoints, nms_radius, threshold, border, approx,
        row_range=row_range,
    )
    theta = torch.atan2(aux[..., 1], aux[..., 0])
    return _masked(valid, yx, scores, theta, strength.shape[:-2])


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

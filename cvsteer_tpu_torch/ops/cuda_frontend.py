"""Front-end kernels A, B and C with their plain PyTorch versions.

The port's counterpart of cvsteer_tpu.ops.pallas_frontend:

- :func:`filter_bank` (kernel A, ``kernels/csrc/filter_bank.cu``) — the
  separable bank ``[..., H, W] -> [..., K, H, W]``;
- :func:`pyr_down` (kernel B, ``kernels/csrc/pyr_down.cu``) — cv2.pyrDown;
- :func:`g2_features_full` (kernel C, ``kernels/csrc/g2_features.cu``, on
  top of kernel A) — the per-level detector maps
  ``(p3, dy, dx, ct, st, basis)``.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises (there is no fallback), and it
adds one to its launch count (cvsteer_tpu_torch.kernels.launch_counts)
where it launches. The plain versions are what the CPU tests exercise and
what the card's kernel checks compare against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain

#: Masked-score sentinel of the packed pooled selection map (p3): the most
#: negative float32 exactly representable in bfloat16 (-255 * 2^120), with
#: zero low mantissa bits. Kept identical to the reference package's
#: pallas_frontend.P3_SENTINEL so p3 maps compare bit for bit.
P3_SENTINEL = -255.0 * 2.0**120

_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: cpu or cuda only")
    return False


def _require(t: torch.Tensor, name: str, ndim_min: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() < ndim_min:
        raise ValueError(f"{name}: expected >= {ndim_min} dims, got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# Kernel A: separable bank
# ---------------------------------------------------------------------------


def filter_bank(image: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """``image [..., H, W]`` -> ``[..., K, H, W]`` float32 (REFLECT_101).

    Plain version: ops.sepconv.filter_bank_plain. Kernel limits: K <= 11,
    T <= 13 (odd)."""
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    if _on_cpu(image):
        return filter_bank_plain(image, xt, yt)
    _require(image, "image", 2)
    K, T = xt.shape
    if yt.shape != (K, T) or K > 11 or T > 13 or T % 2 == 0:
        raise ValueError(f"filter_bank: unsupported taps {xt.shape}/{yt.shape}")
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty(tuple(batch) + (K, h, w), dtype=torch.float32, device=image.device)
    if n == 0:
        return out
    lib = kernels.library()
    kernels.count_launch("filter_bank")
    err = lib.cvs_filter_bank(
        image.data_ptr(), out.data_ptr(), n, h, w, K, T,
        xt.ctypes.data_as(ctypes.c_void_p), yt.ctypes.data_as(ctypes.c_void_p),
        kernels.stream_handle(image.device),
    )
    kernels.check(err, "filter_bank")
    return out


# ---------------------------------------------------------------------------
# Kernel B: pyramid down
# ---------------------------------------------------------------------------


def pyr_down_plain(image: torch.Tensor) -> torch.Tensor:
    """blur5 then keep even rows/cols (cv2.pyrDown semantics)."""
    taps = _BINOMIAL5.reshape(1, -1)
    return filter_bank_plain(image, taps, taps)[..., 0, ::2, ::2]


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """``[..., H, W]`` -> ``[..., ceil(H/2), ceil(W/2)]``; any H, W."""
    if _on_cpu(image):
        return pyr_down_plain(image)
    _require(image, "image", 2)
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty(
        tuple(batch) + (-(-h // 2), -(-w // 2)), dtype=torch.float32,
        device=image.device,
    )
    if n == 0:
        return out
    lib = kernels.library()
    kernels.count_launch("pyr_down")
    err = lib.cvs_pyr_down(
        image.data_ptr(), out.data_ptr(), n, h, w,
        kernels.stream_handle(image.device),
    )
    kernels.check(err, "pyr_down")
    return out


# ---------------------------------------------------------------------------
# Kernel C: per-level detector maps
# ---------------------------------------------------------------------------


def g2_feature_maps_plain(basis: torch.Tensor):
    """(score, ct, st) from the G2/H2 basis ``[..., 7, H, W]``: the corner
    score c1 - |(c2, c3)| and the transcendental-free half-angle
    orientation (the reference's _g2_feature_maps_reference_xla)."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = [basis[..., k, :, :] for k in range(7)]
    c1 = (
        0.5 * (g2b * g2b)
        + 0.25 * (g2a * g2c)
        + 0.375 * (g2a * g2a + g2c * g2c)
        + 0.3125 * (h2a * h2a + h2d * h2d)
        + 0.5625 * (h2b * h2b + h2c * h2c)
        + 0.375 * (h2a * h2c + h2b * h2d)
    )
    c2 = (
        0.5 * (g2a * g2a - g2c * g2c)
        + 0.46875 * (h2a * h2a - h2d * h2d)
        + 0.28125 * (h2b * h2b - h2c * h2c)
        + 0.1875 * (h2a * h2c - h2b * h2d)
    )
    c3 = (
        -(g2a * g2b) - g2b * g2c - 0.9375 * (h2c * h2d + h2a * h2b)
        - 1.6875 * h2b * h2c - 0.1875 * h2a * h2d
    )
    rho = torch.sqrt(c2 * c2 + c3 * c3)
    pos = rho > 0.0
    inv_rho = torch.where(pos, 1.0 / rho, 0.0)
    cos2t = torch.where(pos, c2 * inv_rho, 1.0)
    ct = torch.sqrt(torch.clamp_min(0.5 * (1.0 + cos2t), 0.0))
    st_mag = torch.sqrt(torch.clamp_min(0.5 * (1.0 - cos2t), 0.0))
    st = torch.where(c3 >= 0.0, st_mag, -st_mag)
    return c1 - rho, ct, st


def _edge_shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = x[i - d] along ``dim`` (d = +-1), edge-replicated."""
    n = x.shape[dim]
    if d > 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def select_maps_plain(score: torch.Tensor, threshold: float, nms_radius: int):
    """(p3, dy, dx) from the corner score ``[..., H, W]``.

    p3: centered 3x3 window max of the NMS/threshold/border-masked score
    with each survivor's (y%3)*3 + x%3 offset in its low 4 mantissa bits
    and P3_SENTINEL where masked; dy/dx: per-pixel quadratic subpixel
    offsets, zero on the outer 1-pixel frame."""
    *batch, h, w = score.shape
    s4 = score.reshape(-1, 1, h, w)
    k = 2 * nms_radius + 1
    mx = F.max_pool2d(s4, k, stride=1, padding=nms_radius).reshape(score.shape)
    row = torch.arange(h, device=score.device)[:, None]
    col = torch.arange(w, device=score.device)[None, :]
    bo = nms_radius + 1
    in_b = (row >= bo) & (row < h - bo) & (col >= bo) & (col < w - bo)
    keep = (score >= mx) & (score > threshold) & in_b

    obits = ((row % 3) * 3 + col % 3).to(torch.int32)
    sbits = score.contiguous().view(torch.int32)
    packed_f = ((sbits & ~15) | obits).view(torch.float32)
    packed = torch.where(keep, packed_f, P3_SENTINEL)
    p3 = F.max_pool2d(packed.reshape(-1, 1, h, w), 3, stride=1, padding=1)
    p3 = p3.reshape(score.shape)

    up = _edge_shift(score, 1, -2)
    down = _edge_shift(score, -1, -2)
    left = _edge_shift(score, 1, -1)
    right = _edge_shift(score, -1, -1)
    interior = (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)
    den_y = up - 2.0 * score + down
    dy = torch.where(den_y.abs() > 1e-12, 0.5 * (up - down) / den_y, 0.0)
    den_x = left - 2.0 * score + right
    dx = torch.where(den_x.abs() > 1e-12, 0.5 * (left - right) / den_x, 0.0)
    dy = torch.where(interior, torch.clamp(dy, -0.5, 0.5), 0.0)
    dx = torch.where(interior, torch.clamp(dx, -0.5, 0.5), 0.0)
    return p3, dy, dx


def g2_features_full_plain(
    image: torch.Tensor, xtaps, ytaps, *, threshold: float, nms_radius: int = 2
):
    basis = filter_bank_plain(image, xtaps, ytaps)
    score, ct, st = g2_feature_maps_plain(basis)
    p3, dy, dx = select_maps_plain(score, threshold, nms_radius)
    return p3, dy, dx, ct, st, basis


def g2_features_full(
    image: torch.Tensor, xtaps, ytaps, *, threshold: float, nms_radius: int = 2
) -> Tuple[torch.Tensor, ...]:
    """Whole detector front-end of one pyramid level.

    ``image [..., H, W]`` -> ``(p3, dy, dx, ct, st, basis [..., 7, H, W])``
    with the contract of the reference's _g2_features_full_reference_xla:
    ``p3[..., 1::3, 1::3]`` is the 3x3-cell max table that
    features.keypoints.detect_keypoints_packed selects from. On the card
    the basis comes from kernel A and the maps from kernel C's two
    per-pixel passes."""
    if _on_cpu(image):
        return g2_features_full_plain(
            image, xtaps, ytaps, threshold=threshold, nms_radius=nms_radius
        )
    _require(image, "image", 2)
    if np.asarray(xtaps).shape[0] != 7:
        raise ValueError("g2_features_full: needs the 7-filter G2/H2 bank")
    if not 1 <= nms_radius <= 4:
        raise ValueError(f"g2_features_full: nms_radius {nms_radius} not in [1, 4]")
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    basis = filter_bank(image, xtaps, ytaps)
    maps = [torch.empty_like(image) for _ in range(6)]
    score, ct, st, p3, dy, dx = maps
    if n == 0:
        return p3, dy, dx, ct, st, basis
    lib = kernels.library()
    stream = kernels.stream_handle(image.device)
    kernels.count_launch("g2_features_full")
    err = lib.cvs_g2_maps(
        basis.data_ptr(), score.data_ptr(), ct.data_ptr(), st.data_ptr(),
        n, h, w, stream,
    )
    kernels.check(err, "g2_features_full/maps")
    err = lib.cvs_g2_select(
        score.data_ptr(), p3.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        n, h, w, float(threshold), int(nms_radius), stream,
    )
    kernels.check(err, "g2_features_full/select")
    return p3, dy, dx, ct, st, basis

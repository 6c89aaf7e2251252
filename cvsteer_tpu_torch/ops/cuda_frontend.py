"""Front-end kernels A, B, C, E and F with their plain PyTorch versions.

The port's counterpart of cvsteer_tpu.ops.pallas_frontend:

- :func:`filter_bank` (kernel A, ``kernels/csrc/filter_bank.cu``) — the
  separable bank ``[..., H, W] -> [..., K, H, W]``;
- :func:`pyr_down_levels` / :func:`pyr_down` (kernel B,
  ``kernels/csrc/pyr_down.cu``) — every level of a Gaussian pyramid
  (cv2.pyrDown steps) in one launch, or one step;
- :func:`g2_features_levels` / :func:`g2_features_full` (kernel C,
  ``kernels/csrc/g2_features.cu``) — the detector maps
  ``(p3, dy, dx, ct, st, basis)`` of every level of a pyramid in one launch,
  or of one image;
- :func:`g2_feature_maps` (kernel E′, ``kernels/csrc/g2_feature_maps.cu``,
  the feature tail on kernel E's template) — image -> ``(score, ct, st)``;
- :func:`g2_maps` / :func:`g4_maps` (kernels E and E4,
  ``kernels/csrc/g2_maps.cu`` and ``g4_maps.cu``: one template,
  ``maps.cuh``, one tail per filter order) — image -> the three output maps
  ``(edges, lines_dark, lines_bright)``, the basis never leaving registers;
- :func:`filter_bank_diff` (autograd.Function): forward kernel A, backward
  :func:`filter_bank_adjoint` (kernel F, ``kernels/csrc/filter_bank_adj.cu``).

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises (there is no fallback), and it
adds one to its launch count (cvsteer_tpu_torch.kernels.launch_counts)
where it launches. The plain versions are what the CPU tests exercise and
what the card's kernel checks compare against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain, reflect_indices

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


def _host(a: np.ndarray) -> ctypes.c_void_p:
    """A host array's address for a C entry point (the array must outlive
    the call)."""
    return a.ctypes.data_as(ctypes.c_void_p)


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
        _host(xt), _host(yt),
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


#: Kernel B's ticket counters: one int32 per image, per device and stream.
#: A launch that builds levels past the block's own (cvs_pyr_down_levels)
#: leaves them at 0 for the next one on its stream, so they are zeroed only
#: when a buffer is made or grown.
_PYR_TICKETS = {}


def _pyr_tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _PYR_TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _PYR_TICKETS[key] = torch.zeros(max(n, 16), dtype=torch.int32, device=device)
    return buf


def pyr_down_levels(image: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """The Gaussian pyramid of ``image [..., H, W]``: ``levels`` tensors,
    level 0 being ``image`` itself and level l ``[..., ceil(H / 2^l),
    ceil(W / 2^l)]``; any H, W and levels >= 1.

    On the card all levels past 0 are one launch of kernel B, into one
    buffer (each level a view of it); its plain version composes
    :func:`pyr_down_plain`."""
    if levels < 1:
        raise ValueError(f"pyr_down_levels: levels must be >= 1, got {levels}")
    if _on_cpu(image):
        out = [image]
        for _ in range(levels - 1):
            out.append(pyr_down_plain(out[-1]))
        return tuple(out)
    _require(image, "image", 2)
    if levels == 1:
        return (image,)
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    shapes, (hl, wl) = [], (h, w)
    for _ in range(levels - 1):
        hl, wl = -(-hl // 2), -(-wl // 2)
        shapes.append((hl, wl))
    buf = torch.empty(n * sum(a * b for a, b in shapes), dtype=torch.float32, device=image.device)
    out, off = [image], 0
    for a, b in shapes:
        out.append(buf[off: off + n * a * b].view(tuple(batch) + (a, b)))
        off += n * a * b
    if n == 0:
        return tuple(out)
    if n > 65535:
        raise ValueError(f"pyr_down_levels: {n} images, at most 65535 per launch")
    lib = kernels.library()
    stream = kernels.stream_handle(image.device)
    kernels.count_launch("pyr_down")
    err = lib.cvs_pyr_down_levels(
        image.data_ptr(), buf.data_ptr(), _pyr_tickets(image.device, stream, n).data_ptr(), n, h,
        w, levels, stream,
    )
    kernels.check(err, "pyr_down")
    return tuple(out)


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """``[..., H, W]`` -> ``[..., ceil(H/2), ceil(W/2)]``; any H, W (one step
    of :func:`pyr_down_levels`, one launch of kernel B)."""
    return pyr_down_levels(image, 2)[1]


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


_MAX_LEVELS = 16  # kernels C and D: levels per launch


def g2_features_levels(
    levels: Sequence[torch.Tensor], xtaps, ytaps, *, threshold: float, nms_radius: int = 2
) -> List[Tuple[torch.Tensor, ...]]:
    """The detector front-end of every level of a pyramid.

    ``levels``: images ``[..., H_l, W_l]`` with the same leading axes ->
    one ``(p3, dy, dx, ct, st, basis [..., 7, H_l, W_l])`` per level, each
    with the contract of :func:`g2_features_full`. On the card all levels
    are one launch of kernel C; its plain version is a loop of
    :func:`g2_features_full_plain`."""
    levels = list(levels)
    if all(_on_cpu(lv) for lv in levels):
        return [
            g2_features_full_plain(lv, xtaps, ytaps, threshold=threshold, nms_radius=nms_radius)
            for lv in levels
        ]
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    K, T = xt.shape
    if K != 7 or yt.shape != (K, T) or T > 13 or T < 3 or T % 2 == 0:
        raise ValueError(f"g2_features: needs the 7-filter G2/H2 bank, got {xt.shape}/{yt.shape}")
    if not 1 <= nms_radius <= 4:
        raise ValueError(f"g2_features: nms_radius {nms_radius} not in [1, 4]")
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"g2_features: {len(levels)} levels, at most {_MAX_LEVELS}")
    batch = levels[0].shape[:-2]
    for lv in levels:
        _require(lv, "image", 2)
        if lv.device != levels[0].device or lv.shape[:-2] != batch:
            raise ValueError("g2_features: levels differ in device or leading axes")
    n = int(np.prod(batch)) if batch else 1
    out = []
    for lv in levels:
        maps = [torch.empty_like(lv) for _ in range(5)]
        basis = torch.empty(tuple(batch) + (7,) + tuple(lv.shape[-2:]), dtype=torch.float32,
                            device=lv.device)
        out.append((*maps, basis))
    if n == 0:
        return out
    ptrs = np.array([[lv.data_ptr(), o[5].data_ptr(), *(m.data_ptr() for m in o[:5])]
                     for lv, o in zip(levels, out)], np.int64)
    hw = np.array([lv.shape[-2:] for lv in levels], np.int32)
    lib = kernels.library()
    kernels.count_launch("g2_features_full")
    err = lib.cvs_g2_features(
        _host(ptrs), _host(hw), len(levels), n, T, _host(xt), _host(yt),
        float(threshold), int(nms_radius), kernels.stream_handle(levels[0].device),
    )
    kernels.check(err, "g2_features_full")
    return out


def g2_features_full(
    image: torch.Tensor, xtaps, ytaps, *, threshold: float, nms_radius: int = 2
) -> Tuple[torch.Tensor, ...]:
    """Whole detector front-end of one pyramid level.

    ``image [..., H, W]`` -> ``(p3, dy, dx, ct, st, basis [..., 7, H, W])``
    with the contract of the reference's _g2_features_full_reference_xla:
    ``p3[..., 1::3, 1::3]`` is the 3x3-cell max table that
    features.keypoints.detect_keypoints_packed selects from. On the card it
    is kernel C with one level."""
    return g2_features_levels(
        [image], xtaps, ytaps, threshold=threshold, nms_radius=nms_radius
    )[0]


def g2_feature_maps(image: torch.Tensor, xtaps, ytaps) -> Tuple[torch.Tensor, ...]:
    """Fused detector maps: ``image [..., H, W]`` -> ``(score, ct, st)``
    float32, the corner score c1 - |(c2, c3)| and the half-angle orientation
    (the reference's g2_feature_maps_pallas). On the card: kernel E′, the
    bank in registers and the feature tail of kernel C."""
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    if _on_cpu(image):
        return g2_feature_maps_plain(filter_bank_plain(image, xt, yt))
    _require(image, "image", 2)
    K, T = xt.shape
    if K != 7 or yt.shape != (K, T) or T > _MAPS_MAX_T or T % 2 == 0:
        raise ValueError(f"g2_feature_maps: unsupported taps {xt.shape}/{yt.shape}")
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    maps = tuple(torch.empty_like(image) for _ in range(3))
    if n == 0:
        return maps
    lib = kernels.library()
    kernels.count_launch("g2_feature_maps")
    err = lib.cvs_features_g2(
        image.data_ptr(), *(m.data_ptr() for m in maps), n, h, w, T, _host(xt), _host(yt),
        kernels.stream_handle(image.device),
    )
    kernels.check(err, "g2_feature_maps")
    return maps


# ---------------------------------------------------------------------------
# Kernel E: fused output maps (G2 and G4)
# ---------------------------------------------------------------------------
#
# The sqrt-free steering tails of the reference's _g2_maps_tiled_kernel
# (modes "maps" and "g4maps"). With (u, v) = (cos 2t, sin 2t) = (c2, c3)/rho
# the half-angle powers are polynomials in u and v, so the steered pair
# needs no transcendental; rho == 0 steers to theta = 0 (u = 1, v = 0) as
# arctan2(0, 0) does. The three maps consume only the steered even response
# (with its sign) and the square of the odd one. Every expression below is
# written in the kernel's order with one rounding per operation, and
# 1 / sqrt(x) is a division by a correctly rounded sqrt (as the kernel's
# 1.0f / sqrtf(x)), so kernel and plain version agree to the bit.

_MAPS_MAX_T = 17  # kernel E: taps of radius <= 8, the TPU kernel's limit too


def _maps_out(gv, gsq, hsq, out_dtype):
    mag2 = gsq + hsq
    inv_mag = torch.where(mag2 > 0.0, 1.0 / torch.sqrt(mag2), 0.0)
    edges = hsq * inv_mag
    gsq_over_mag = gsq * inv_mag
    dark = torch.where(gv > 0.0, gsq_over_mag, 0.0)
    bright = torch.where(gv < 0.0, gsq_over_mag, 0.0)
    return tuple(m.to(out_dtype) for m in (edges, dark, bright))


def _unit_harmonic(c2, c3):
    """(u, v) = (cos 2t, sin 2t), with (1, 0) where c2 = c3 = 0."""
    s2 = c2 * c2 + c3 * c3
    pos = s2 > 0.0
    inv_rho = torch.where(pos, 1.0 / torch.sqrt(s2), 0.0)
    return torch.where(pos, c2 * inv_rho, 1.0), c3 * inv_rho


def g2_harmonic_sd(basis: torch.Tensor):
    """The G2 energy's second harmonic (c2, c3) from the basis ``[..., 7, H,
    W]``, with g2a + g2c and g2a - g2c shared (kernel E's form)."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = [basis[..., k, :, :] for k in range(7)]
    s_gd = g2a + g2c
    d_gd = g2a - g2c
    c2 = (
        0.5 * (s_gd * d_gd)
        + 0.46875 * (h2a * h2a - h2d * h2d)
        + 0.28125 * (h2b * h2b - h2c * h2c)
        + 0.1875 * (h2a * h2c - h2b * h2d)
    )
    c3 = (
        -(g2b * s_gd) - 0.9375 * (h2c * h2d + h2a * h2b)
        - 1.6875 * h2b * h2c - 0.1875 * h2a * h2d
    )
    return c2, c3


def g2_steer_maps(basis: torch.Tensor, c2, c3, out_dtype=torch.float32):
    """(edges, dark, bright) by the sqrt-free steering from (c2, c3)."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = [basis[..., k, :, :] for k in range(7)]
    u, v = _unit_harmonic(c2, c3)
    g2v = 0.5 * ((g2a + g2c) + u * (g2a - g2c)) - v * g2b
    P = 0.5 * ((h2a + 3.0 * h2c) + u * (h2a - 3.0 * h2c))
    Q = 0.5 * ((3.0 * h2b + h2d) + u * (3.0 * h2b - h2d))
    PP, QQ = P * P, Q * Q
    h2sq = torch.clamp_min(0.5 * ((PP + QQ) + u * (PP - QQ)) - v * (P * Q), 0.0)
    return _maps_out(g2v, g2v * g2v, h2sq, out_dtype)


def g2_maps_tail(basis: torch.Tensor, out_dtype=torch.float32):
    """(edges, dark, bright) from the G2/H2 basis ``[..., 7, H, W]``."""
    return g2_steer_maps(basis, *g2_harmonic_sd(basis), out_dtype)


@functools.lru_cache(maxsize=None)
def g4_live_terms():
    """The G4 second-harmonic product list that kernel E walks: the 33
    ``(i, j, w2, w3)`` terms of filters.g4.g4_quad_terms in order, each as
    ``(i, j, slot, w)`` — ``c2 += w b_i b_j`` for slot 0, ``c3`` for slot 1
    — with the one weight the reference kernel keeps (``|w| > 1e-7``)."""
    from cvsteer_tpu_torch.filters.g4 import g4_quad_terms

    out = []
    for i, j, w2, w3 in g4_quad_terms():
        live = [(slot, w) for slot, w in enumerate((w2, w3)) if abs(w) > 1e-7]
        if len(live) != 1:
            raise ValueError(f"G4 product ({i}, {j}) has {len(live)} live weights, not 1")
        (slot, w), = live
        out.append((i, j, slot, float(np.float32(w))))
    return tuple(out)


def g4_maps_tail(basis: torch.Tensor, out_dtype=torch.float32):
    """(edges, dark, bright) from the G4/H4 basis ``[..., 11, H, W]``."""
    b = [basis[..., k, :, :] for k in range(11)]
    c = [torch.zeros_like(b[0]), torch.zeros_like(b[0])]
    for i, j, slot, w in g4_live_terms():
        c[slot] = c[slot] + (b[i] * b[j]) * w
    c2, c3 = c
    u, v = _unit_harmonic(c2, c3)
    cc = 0.5 * (1.0 + u)
    ss = 0.5 * (1.0 - u)
    cc2, ss2, cs = cc * cc, ss * ss, cc * ss
    g4v = (
        cc2 * b[0] + 6.0 * cs * b[2] + ss2 * b[4]
        - 2.0 * v * (cc * b[1] + ss * b[3])
    )
    P = cc2 * b[5] + 10.0 * cs * b[7] + 5.0 * ss2 * b[9]
    Q = 5.0 * cc2 * b[6] + 10.0 * cs * b[8] + ss2 * b[10]
    PP, QQ = P * P, Q * Q
    h4sq = torch.clamp_min(0.5 * ((PP + QQ) + u * (PP - QQ)) - v * (P * Q), 0.0)
    return _maps_out(g4v, g4v * g4v, h4sq, out_dtype)


def g2_maps_plain(image: torch.Tensor, xtaps, ytaps, out_dtype=torch.float32):
    return g2_maps_tail(filter_bank_plain(image, xtaps, ytaps), out_dtype)


def g4_maps_plain(image: torch.Tensor, xtaps, ytaps, out_dtype=torch.float32):
    return g4_maps_tail(filter_bank_plain(image, xtaps, ytaps), out_dtype)


def _maps(image, xtaps, ytaps, out_dtype, order: int):
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    plain = g2_maps_plain if order == 2 else g4_maps_plain
    if _on_cpu(image):
        return plain(image, xt, yt, out_dtype)
    _require(image, "image", 2)
    K, T = xt.shape
    if K != (7 if order == 2 else 11) or yt.shape != (K, T) or T > _MAPS_MAX_T or T % 2 == 0:
        raise ValueError(f"g{order}_maps: unsupported taps {xt.shape}/{yt.shape}")
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    maps = tuple(torch.empty_like(image, dtype=out_dtype) for _ in range(3))
    if n == 0:
        return maps
    lib = kernels.library()
    name = f"g{order}_maps"
    args = [image.data_ptr(), *(m.data_ptr() for m in maps), n, h, w, T, _host(xt), _host(yt)]
    if order == 4:
        terms = g4_live_terms()
        idx = np.array([t[:3] for t in terms], np.int32)
        wts = np.array([t[3] for t in terms], np.float32)
        args += [_host(idx), _host(wts), len(terms)]
    kernels.count_launch(name)
    err = getattr(lib, f"cvs_maps_g{order}")(
        *args, int(out_dtype == torch.bfloat16), kernels.stream_handle(image.device)
    )
    kernels.check(err, name)
    return maps


def g2_maps(image: torch.Tensor, xtaps, ytaps, out_dtype=torch.float32):
    """Fused G2/H2 front-end: ``image [..., H, W]`` float32 ->
    ``(edges, lines_dark, lines_bright)`` in ``out_dtype`` (float32 or
    bfloat16). One image read, three map writes (kernel E)."""
    return _maps(image, xtaps, ytaps, out_dtype, order=2)


def g4_maps(image: torch.Tensor, xtaps, ytaps, out_dtype=torch.float32):
    """Fused G4/H4 front-end: the 11-filter bank, then the second-harmonic
    quadratic form (33 products) and the 4th/5th-degree steering tail
    (kernel E4, the G4 instantiation of kernel E's template)."""
    return _maps(image, xtaps, ytaps, out_dtype, order=4)


# ---------------------------------------------------------------------------
# Kernel F: adjoint of the bank (the gradient of filter_bank)
# ---------------------------------------------------------------------------


def _fold_reflect(gp: torch.Tensor, n: int, r: int, dim: int) -> torch.Tensor:
    """Fold a REFLECT_101-padded axis (``n + 2r`` long) back onto ``n``:
    ``out[a] = sum of gp[x + r] over x in [-r, n + r) with reflect(x) = a``,
    x ascending (the kernel's order). Periodic, so it stays right where the
    pad exceeds the dimension."""
    out = torch.zeros_like(gp.narrow(dim, 0, n))
    for j, a in enumerate(reflect_indices(-r, 0, n).tolist()):
        out.select(dim, a).add_(gp.select(dim, j))
    out = out + gp.narrow(dim, r, n)
    for j, a in enumerate(reflect_indices(n, n + r, n).tolist()):
        out.select(dim, a).add_(gp.select(dim, n + r + j))
    return out


def filter_bank_adjoint_plain(grad: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """The explicit adjoint of filter_bank_plain: ``grad [..., K, H, W]`` ->
    ``[..., H, W]``. Transpose row pass (flipped taps over the zero-extended
    gradient), transpose column pass, sum over K in order, then fold the
    padded border back through the REFLECT_101 map."""
    xt = torch.as_tensor(np.asarray(xtaps, np.float32), device=grad.device)
    yt = torch.as_tensor(np.asarray(ytaps, np.float32), device=grad.device)
    K, T = xt.shape
    R = T - 1
    *_, h, w = grad.shape
    hp, wp = h + R, w + R
    xk = xt[:, :, None, None]
    yk = yt[:, :, None, None]
    gz = F.pad(grad.to(torch.float32), (R, R))
    row = gz[..., R : R + wp] * xk[:, 0]
    for u in range(1, T):
        row = row + gz[..., R - u : R - u + wp] * xk[:, u]
    rz = F.pad(row, (0, 0, R, R))
    col = rz[..., R : R + hp, :] * yk[:, 0]
    for v in range(1, T):
        col = col + rz[..., R - v : R - v + hp, :] * yk[:, v]
    gpad = col[..., 0, :, :]
    for k in range(1, K):
        gpad = gpad + col[..., k, :, :]
    r = R // 2
    return _fold_reflect(_fold_reflect(gpad, h, r, -2), w, r, -1)


def filter_bank_adjoint(grad: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """``grad [..., K, H, W]`` -> ``[..., H, W]`` (kernel F: one launch, the
    transposed passes and the reflect fold of each tile in shared memory)."""
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    if _on_cpu(grad):
        return filter_bank_adjoint_plain(grad, xt, yt)
    _require(grad, "grad", 3)
    K, T = xt.shape
    if yt.shape != (K, T) or K > 11 or T > 13 or T % 2 == 0 or grad.shape[-3] != K:
        raise ValueError(
            f"filter_bank_adjoint: grad {tuple(grad.shape)}, taps {xt.shape}/{yt.shape}"
        )
    *batch, _, h, w = grad.shape
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty(tuple(batch) + (h, w), dtype=torch.float32, device=grad.device)
    if n == 0:
        return out
    if n > 65535:
        raise ValueError(f"filter_bank_adjoint: {n} images, at most 65535 per launch")
    lib = kernels.library()
    kernels.count_launch("filter_bank_adj")
    err = lib.cvs_filter_bank_adj(
        grad.data_ptr(), out.data_ptr(), n, h, w, K, T,
        _host(xt), _host(yt),
        kernels.stream_handle(grad.device),
    )
    kernels.check(err, "filter_bank_adj")
    return out


class _FilterBankDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, xt, yt):
        ctx.taps = (xt, yt)
        return filter_bank(image, xt, yt)

    @staticmethod
    def backward(ctx, grad):
        return filter_bank_adjoint(grad.contiguous(), *ctx.taps), None, None


def filter_bank_diff(image: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """Differentiable :func:`filter_bank`: forward kernel A, backward kernel
    F (the reference's filter_bank_pallas_diff, whose VJP was XLA's)."""
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    return _FilterBankDiff.apply(image.to(torch.float32).contiguous(), xt, yt)

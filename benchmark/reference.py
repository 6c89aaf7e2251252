"""The plain reference of the front-end: steerable-filter keypoints and phase
descriptors, written from the published recipe in plain PyTorch.

It computes what ``cvsteer_tpu_torch.features.frontend.extract_features``
promises for an image batch, level by level, with none of the program's
code, kernels or tables:

- a Gaussian pyramid: the 5-tap binomial [1 4 6 4 1] / 16, separable,
  REFLECT_101 borders, then every other row and column (cv2.pyrDown);
- the steerable basis of each level: Freeman & Adelson's separable G2/H2
  (7 filters, 9 taps at spacing 0.67) or G4/H4 (11 filters, 13 taps at
  spacing 0.5) pairs, cross-correlation with REFLECT_101 borders;
- the oriented energy's coefficients (c1, c2, c3) of E(theta) = c1 + c2
  cos 2 theta + c3 sin 2 theta (G2: the published table; G4: the DFT of
  G4(theta)^2 + H4(theta)^2 over 16 angles), the corner score
  c1 - |(c2, c3)| and the orientation theta = atan2(c3, c2) / 2;
- local maxima of the score in a (2 r + 1)^2 window above the threshold,
  at least r + 1 pixels from the edge, the ``keypoints_per_level`` best per
  level, each refined by a 1-D quadratic fit in y and in x (clamped to
  half a pixel);
- a G x G grid of samples (spacing ``descriptor_spacing``) rotated by
  theta, the basis read bilinearly there (coordinates clamped to the
  level), steered to theta, [G-part, H-part] normalised to unit length.

``precision`` "float64" is the reference. "tf32" is the control: every
product of the filter banks and of the energy's quadratic forms takes
operands rounded to TF32 (10 mantissa bits, round to nearest), the rest
in float32, which is what routing the bank through a TF32 convolution
would do to the program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class RefFeatures(NamedTuple):
    """One image's keypoints, level by level: ``yx`` [n, 2] level
    coordinates, ``theta`` [n], ``desc`` [n, D]."""

    yx: List[torch.Tensor]
    theta: List[torch.Tensor]
    desc: List[torch.Tensor]


# -- the taps (Freeman & Adelson, PAMI 1991, the separable tables) ----------

def _g(x):
    return np.exp(-x * x)


_G2 = (  # (x taps, y taps) per filter: g2a, g2b, g2c, h2a, h2b, h2c, h2d
    (lambda x: 0.9213 * (2 * x * x - 1) * _g(x), _g),
    (lambda x: math.sqrt(1.8430) * x * _g(x), lambda x: math.sqrt(1.8430) * x * _g(x)),
    (_g, lambda x: 0.9213 * (2 * x * x - 1) * _g(x)),
    (lambda x: 0.9780 * (-2.254 * x + x**3) * _g(x), _g),
    (lambda x: 0.9780 * (-0.7515 + x * x) * _g(x), lambda x: x * _g(x)),
    (lambda x: x * _g(x), lambda x: 0.9780 * (-0.7515 + x * x) * _g(x)),
    (_g, lambda x: 0.9780 * (-2.254 * x + x**3) * _g(x)),
)


def _g4f(i):
    return (
        lambda x: 1.246 * (0.75 - 3 * x * x + x**4) * _g(x),
        _g,
        lambda x: (-1.5 * x + x**3) * _g(x),
        lambda x: 1.246 * x * _g(x),
        lambda x: math.sqrt(1.246) * (x * x - 0.5) * _g(x),
    )[i]


def _h4f(i):
    return (
        lambda x: 0.3975 * (7.189 * x - 7.501 * x**3 + x**5) * _g(x),
        _g,
        lambda x: 0.3975 * (1.438 - 4.501 * x * x + x**4) * _g(x),
        lambda x: x * _g(x),
        lambda x: 0.3975 * (x**3 - 2.225 * x) * _g(x),
        lambda x: (x * x - 0.6638) * _g(x),
    )[i]


_G4 = (  # g4a..g4e, h4a..h4f: (x tap, y tap) indices into _g4f / _h4f
    (_g4f(0), _g4f(1)), (_g4f(2), _g4f(3)), (_g4f(4), _g4f(4)), (_g4f(3), _g4f(2)),
    (_g4f(1), _g4f(0)),
    (_h4f(0), _h4f(1)), (_h4f(2), _h4f(3)), (_h4f(4), _h4f(5)), (_h4f(5), _h4f(4)),
    (_h4f(3), _h4f(2)), (_h4f(1), _h4f(0)),
)


def bank_taps(order: int):
    """(xtaps [K, T], ytaps [K, T]) float64: each published tap function
    sampled at x = i * spacing, i in [-w, w], rounded to float32 as the
    published library stores them."""
    pairs, w, sp = (_G2, 4, 0.67) if order == 2 else (_G4, 6, 0.5)
    x = np.arange(-w, w + 1, dtype=np.float64) * sp
    xt = np.stack([np.float32(fx(x)) for fx, _ in pairs]).astype(np.float64)
    yt = np.stack([np.float32(fy(x)) for _, fy in pairs]).astype(np.float64)
    return xt, yt


# -- precision ---------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _mul(a, b, precision):
    if precision == "tf32":
        return tf32(a) * tf32(b)
    return a * b


def _dtype(precision):
    return torch.float64 if precision == "float64" else torch.float32


# -- the pyramid and the bank -------------------------------------------------

def _reflect_index(lo: int, hi: int, n: int, device) -> torch.Tensor:
    i = torch.arange(lo, hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    i = torch.remainder(i, p)
    return torch.where(i < n, i, p - i)


def _pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """REFLECT_101 padding of the last two axes by r."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _reflect_index(-r, h + r, h, x.device))
    return x.index_select(-1, _reflect_index(-r, w + r, w, x.device))


def separable(img: torch.Tensor, xt, yt, precision: str) -> torch.Tensor:
    """``img [B, H, W]`` -> ``[B, K, H, W]``: out_k[y, x] = sum_u,v
    img[y + u, x + v] ytaps[k, u] xtaps[k, v] (REFLECT_101)."""
    dt = _dtype(precision)
    xk = torch.as_tensor(np.asarray(xt), dtype=dt, device=img.device)
    yk = torch.as_tensor(np.asarray(yt), dtype=dt, device=img.device)
    K, T = xk.shape
    r = (T - 1) // 2
    p = _pad(img.to(dt), r)[:, None]  # [B, 1, H + 2r, W + 2r]
    H, W = p.shape[-2] - 2 * r, p.shape[-1] - 2 * r
    row = sum(_mul(p[..., :, v:v + W], xk[:, v, None, None], precision) for v in range(T))
    return sum(_mul(row[..., u:u + H, :], yk[:, u, None, None], precision) for u in range(T))


_BINOMIAL = np.array([[1.0, 4.0, 6.0, 4.0, 1.0]]) / 16.0


def pyramid(img: torch.Tensor, levels: int, precision: str) -> List[torch.Tensor]:
    out = [img.to(_dtype(precision))]
    for _ in range(levels - 1):
        out.append(separable(out[-1], _BINOMIAL, _BINOMIAL, precision)[:, 0, ::2, ::2])
    return out


# -- the energy ---------------------------------------------------------------

def _g2_energy(b, precision):
    m = lambda u, v: _mul(u, v, precision)  # noqa: E731
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = b.unbind(1)
    c1 = (0.5 * m(g2b, g2b) + 0.25 * m(g2a, g2c) + 0.375 * (m(g2a, g2a) + m(g2c, g2c))
          + 0.3125 * (m(h2a, h2a) + m(h2d, h2d)) + 0.5625 * (m(h2b, h2b) + m(h2c, h2c))
          + 0.375 * (m(h2a, h2c) + m(h2b, h2d)))
    c2 = (0.5 * (m(g2a, g2a) - m(g2c, g2c)) + 0.46875 * (m(h2a, h2a) - m(h2d, h2d))
          + 0.28125 * (m(h2b, h2b) - m(h2c, h2c)) + 0.1875 * (m(h2a, h2c) - m(h2b, h2d)))
    c3 = (-m(g2a, g2b) - m(g2b, g2c) - 0.9375 * (m(h2c, h2d) + m(h2a, h2b))
          - 1.6875 * m(h2b, h2c) - 0.1875 * m(h2a, h2d))
    return c1, c2, c3


def steering_weights(theta):
    """G4 weights [5] and H4 weights [6] at theta (the binomial expansion of
    cos^4 / cos^5 steering), stacked on the last axis."""
    c, s = torch.cos(theta), torch.sin(theta)
    ga = torch.stack([c**4, -4 * c**3 * s, 6 * c**2 * s**2, -4 * c * s**3, s**4], -1)
    ha = torch.stack([c**5, -5 * c**4 * s, 10 * c**3 * s**2, -10 * c**2 * s**3,
                      5 * c * s**4, -s**5], -1)
    return ga, ha


def _g4_tables():
    """(M1, M2, M3) [11, 11] float64: c_k = b^T M_k b, from E(theta) at 16
    angles in [0, pi) (exact for the harmonics E holds)."""
    th = torch.arange(16, dtype=torch.float64) * (math.pi / 16)
    ga, ha = steering_weights(th)
    U = torch.zeros(16, 11, dtype=torch.float64)
    U[:, :5], U[:, 5:] = ga, ha
    P = U[:, :, None] * U[:, None, :]
    P[:, :5, 5:] = 0.0
    P[:, 5:, :5] = 0.0
    M1 = P.mean(0)
    M2 = (torch.cos(2 * th)[:, None, None] * P).sum(0) * (2 / 16)
    M3 = (torch.sin(2 * th)[:, None, None] * P).sum(0) * (2 / 16)
    return M1, M2, M3


def _g4_energy(b, precision):
    out = []
    for M in _g4_tables():
        Mt = M.to(b.dtype).to(b.device)
        t = sum(_mul(Mt[:, j].reshape(11, 1, 1, 1), b[:, j][None], precision)
                for j in range(11))  # [11, B, H, W]: (M b)_i
        out.append(sum(_mul(b[:, i], t[i], precision) for i in range(11)))
    return tuple(out)


# -- detection and descriptors ------------------------------------------------

def _level_keypoints(score, k, r, thr):
    """(yi, xi, off_y, off_x) of the k best NMS maxima of one image's
    ``score [H, W]``."""
    H, W = score.shape
    mx = F.max_pool2d(score[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    b = r + 1
    rows = torch.arange(H, device=score.device)[:, None]
    cols = torch.arange(W, device=score.device)[None, :]
    keep = (score >= mx) & (score > thr) & (rows >= b) & (rows < H - b) & (cols >= b) & (cols < W - b)
    masked = torch.where(keep, score, torch.tensor(float("-inf"), dtype=score.dtype, device=score.device))
    n = min(k, H * W)
    vals, idx = torch.topk(masked.reshape(-1), n)
    valid = torch.isfinite(vals)
    vals, idx = vals[valid], idx[valid]
    yi, xi = idx // W, idx % W

    def off(m, z, p):
        den = m - 2 * z + p
        o = torch.where(den.abs() > 1e-12, 0.5 * (m - p) / den, torch.zeros_like(den))
        return o.clamp(-0.5, 0.5)

    s0 = score[yi, xi]
    oy = off(score[(yi - 1).clamp_min(0), xi], s0, score[(yi + 1).clamp_max(H - 1), xi])
    ox = off(score[yi, (xi - 1).clamp_min(0)], s0, score[yi, (xi + 1).clamp_max(W - 1)])
    return yi, xi, oy, ox


def _bilinear(basis, ys, xs):
    """``basis [C, H, W]`` at (ys, xs) [n, S] -> [n, S, C]; coordinates
    clamped to the image, the far corners to its last row and column."""
    C, H, W = basis.shape
    ys = ys.clamp(0, H - 1)
    xs = xs.clamp(0, W - 1)
    y0, x0 = ys.floor(), xs.floor()
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
    flat = basis.reshape(C, H * W).T
    v00, v01, v10, v11 = flat[y0 * W + x0], flat[y0 * W + x1], flat[y1 * W + x0], flat[y1 * W + x1]
    return (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy


def _descriptors(basis, yx, theta, grid, spacing, order):
    c0 = (grid - 1) / 2.0
    g = torch.arange(grid, dtype=yx.dtype, device=yx.device)
    oy = ((g[:, None] - c0) * spacing).expand(grid, grid).reshape(-1)
    ox = ((g[None, :] - c0) * spacing).expand(grid, grid).reshape(-1)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    ys = yx[:, 0:1] + oy * c - ox * s
    xs = yx[:, 1:2] + oy * s + ox * c
    smp = _bilinear(basis, ys, xs)  # [n, S, C]
    if order == 2:
        ge = c * c * smp[..., 0] - 2 * c * s * smp[..., 1] + s * s * smp[..., 2]
        ho = (c**3 * smp[..., 3] - 3 * c * c * s * smp[..., 4] + 3 * c * s * s * smp[..., 5]
              - s**3 * smp[..., 6])
    else:
        ga, ha = steering_weights(theta)
        ge = (smp[..., :5] * ga[:, None, :]).sum(-1)
        ho = (smp[..., 5:] * ha[:, None, :]).sum(-1)
    d = torch.cat([ge, ho], -1)
    return d / d.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def features(images: torch.Tensor, fcfg: dict, precision: str = "float64") -> List[RefFeatures]:
    """Reference features of ``images [B, H, W]`` (any dtype, 0..255) for the
    front-end settings ``fcfg`` (the configuration file's ``frontend``)."""
    order = int(fcfg.get("order", 2))
    levels = int(fcfg.get("levels", 5))
    k = int(fcfg.get("keypoints_per_level", 256))
    r = int(fcfg.get("nms_radius", 2))
    thr = float(fcfg.get("threshold", 1.0))
    grid = int(fcfg.get("descriptor_grid", 4))
    spacing = float(fcfg.get("descriptor_spacing", 3.0))
    xt, yt = bank_taps(order)
    pyr = pyramid(images, levels, precision)
    out = [RefFeatures([], [], []) for _ in range(images.shape[0])]
    for lv in pyr:
        basis = separable(lv, xt, yt, precision)  # [B, K, h, w]
        c1, c2, c3 = (_g2_energy if order == 2 else _g4_energy)(basis, precision)
        score = c1 - torch.sqrt(c2 * c2 + c3 * c3)
        theta_map = 0.5 * torch.atan2(c3, c2)
        for b in range(images.shape[0]):
            yi, xi, oy, ox = _level_keypoints(score[b], k, r, thr)
            yx = torch.stack([yi.to(score.dtype) + oy, xi.to(score.dtype) + ox], -1)
            th = theta_map[b][yi, xi]
            out[b].yx.append(yx)
            out[b].theta.append(th)
            out[b].desc.append(_descriptors(basis[b], yx, th, grid, spacing, order))
    return out


def as_frame(ref: RefFeatures) -> dict:
    """One image's reference features in the program's per-frame layout
    (level-0 yx, level, desc, valid): the control, put in the program's
    place, is judged as the program is."""
    dev = ref.desc[0].device
    return dict(
        yx=torch.cat([y * 2.0**lvl for lvl, y in enumerate(ref.yx)]).float(),
        level=torch.cat([torch.full((len(y),), lvl, dtype=torch.int32, device=dev)
                         for lvl, y in enumerate(ref.yx)]),
        desc=torch.cat(ref.desc).float(),
        valid=torch.ones(sum(len(y) for y in ref.yx), dtype=torch.bool, device=dev),
    )

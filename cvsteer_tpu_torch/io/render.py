"""A synthetic image sequence with exact ground truth, rendered with numpy.

For runs on machines without datasets (and without OpenCV or PIL): a
scene of textured planes — a back wall and four panels at different depths
in front of it — seen by a pinhole camera that slides sideways with a
little forward travel, wobble and yaw. Every pixel ray-casts all planes analytically (z-buffered) and reads
the plane's texture bilinearly. Textures are seeded multi-octave noise
with flat rectangles on top: corners and blobs at many scales, distinct
everywhere, so the corner detector and the descriptors have real work.
Frames are float32 grayscale in [0, 255], identical for identical
parameters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


class _Plane(NamedTuple):
    p0: np.ndarray  # [3] texture origin (world)
    ex: np.ndarray  # [3] unit texture-x direction
    ey: np.ndarray  # [3] unit texture-y direction
    n: np.ndarray  # [3] unit normal
    tex: np.ndarray  # [h, w] float32
    px_per_m: float


def _box_blur(a: np.ndarray, r: int) -> np.ndarray:
    """Separable (2r+1) box blur with edge clamping (cumulative sums)."""
    for axis in (0, 1):
        p = np.concatenate(
            [np.repeat(a.take([0], axis), r + 1, axis), a,
             np.repeat(a.take([-1], axis), r, axis)], axis,
        )
        c = np.cumsum(p, axis=axis, dtype=np.float64)
        n = a.shape[axis]
        hi = c.take(np.arange(2 * r + 1, 2 * r + 1 + n), axis)
        lo = c.take(np.arange(0, n), axis)
        a = ((hi - lo) / (2 * r + 1)).astype(np.float32)
    return a


def _upsample(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of a coarse grid to [h, w]."""
    gy = np.linspace(0, a.shape[0] - 1, h)
    gx = np.linspace(0, a.shape[1] - 1, w)
    y0 = np.minimum(gy.astype(np.int64), a.shape[0] - 2)
    x0 = np.minimum(gx.astype(np.int64), a.shape[1] - 2)
    fy, fx = (gy - y0)[:, None], (gx - x0)[None, :]
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x0 + 1] * fx
    bot = a[y0 + 1][:, x0] * (1 - fx) + a[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Seeded feature-rich texture [h, w] in [0, 255]: multi-octave value
    noise (a 1/f-like spectrum: distinct local structure at every scale)
    under a sprinkling of flat random rectangles (sharp corners)."""
    tex = np.zeros((h, w), np.float64)
    for cell, amp in ((64, 60.0), (24, 45.0), (10, 35.0), (4, 20.0)):
        grid = rng.uniform(-1, 1, (h // cell + 2, w // cell + 2))
        tex += amp * _upsample(grid, h, w)
    tex = (tex + 128.0).astype(np.float32)
    for _ in range(h * w // 4000):
        rh, rw = rng.integers(8, 40, 2)
        y, x = rng.integers(0, h), rng.integers(0, w)
        tex[y : y + rh, x : x + rw] = rng.uniform(0, 255)
    return np.clip(_box_blur(tex, 1), 0, 255).astype(np.float32)


class PlanesSequence:
    """``pose(k)`` -> exact world->camera (R, t); ``render(k)`` -> [H, W]."""

    def __init__(
        self,
        n_frames: int = 40,
        image_hw: Tuple[int, int] = (480, 640),
        fx: float = 500.0,
        fy: float = 500.0,
        cx: float = 320.0,
        cy: float = 240.0,
        seed: int = 0,
        step: float = 0.015,
        noise_sigma: float = 1.0,
    ):
        self.n_frames = int(n_frames)
        self.h, self.w = image_hw
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        self.step = float(step)
        self.noise_sigma = float(noise_sigma)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        ppm = 100.0  # texture pixels per meter
        # camera y is down, z forward: a back wall at z = 5 that fills the
        # view, and four panels at depths 2.4 .. 3.6 m in front of it
        specs = [
            # p0, ex, ey, n, (width m, height m)
            ((-5.0, -3.5, 5.0), (1, 0, 0), (0, 1, 0), (0, 0, -1), (10.0, 7.0)),
            ((-2.2, -1.6, 3.0), (1, 0, 0), (0, 1, 0), (0, 0, -1), (1.6, 1.3)),
            ((0.4, -1.2, 2.4), (1, 0, 0), (0, 1, 0), (0, 0, -1), (1.2, 1.0)),
            ((-0.8, 0.3, 3.6), (1, 0, 0), (0, 1, 0), (0, 0, -1), (1.8, 1.2)),
            ((1.2, 0.2, 3.2), (1, 0, 0), (0, 1, 0), (0, 0, -1), (1.4, 1.4)),
        ]
        self.planes: List[_Plane] = []
        for p0, ex, ey, n, (wm, hm) in specs:
            tex = texture(rng, int(hm * ppm), int(wm * ppm))
            self.planes.append(_Plane(
                np.array(p0, np.float64), np.array(ex, np.float64),
                np.array(ey, np.float64), np.array(n, np.float64), tex, ppm,
            ))
        us, vs = np.meshgrid(np.arange(self.w), np.arange(self.h))
        self._rays = np.stack(
            [(us - self.cx) / self.fx, (vs - self.cy) / self.fy, np.ones(us.shape)], -1
        ).reshape(-1, 3)

    def pose(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """World->camera pose of frame k: a sideways sweep centred on x = 0
        with a little forward travel, vertical wobble and yaw."""
        s = (k - 0.5 * (self.n_frames - 1)) * self.step
        c = np.array([s, 0.08 * np.sin(0.2 * k), 0.25 * (s + 0.5 * self.n_frames * self.step)])
        yaw = 0.05 * np.sin(0.1 * k)
        Rwc = np.array(
            [[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0], [-np.sin(yaw), 0.0, np.cos(yaw)]]
        )
        R = Rwc.T
        return R.astype(np.float32), (-R @ c).astype(np.float32)

    def _cast(self, k: int):
        R, t = self.pose(k)
        R64, t64 = R.astype(np.float64), t.astype(np.float64)
        C = -R64.T @ t64
        dirs = self._rays @ R64  # world-frame ray directions (camera z = 1)
        depth = np.full(self.h * self.w, np.inf)
        img = np.full(self.h * self.w, 128.0)
        for pl in self.planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                s = ((pl.p0 - C) @ pl.n) / (dirs @ pl.n)
            ok = np.isfinite(s) & (s > 0.1) & (s < depth)
            s = np.where(ok, s, 1.0)
            P = C + s[:, None] * dirs
            ax = (P - pl.p0) @ pl.ex * pl.px_per_m
            ay = (P - pl.p0) @ pl.ey * pl.px_per_m
            th, tw = pl.tex.shape
            ok &= (ax >= 0) & (ax < tw - 1) & (ay >= 0) & (ay < th - 1)
            x0 = np.clip(np.floor(ax).astype(np.int64), 0, tw - 2)
            y0 = np.clip(np.floor(ay).astype(np.int64), 0, th - 2)
            fx, fy = np.clip(ax - x0, 0, 1), np.clip(ay - y0, 0, 1)
            t00 = pl.tex[y0, x0]
            t01 = pl.tex[y0, x0 + 1]
            t10 = pl.tex[y0 + 1, x0]
            t11 = pl.tex[y0 + 1, x0 + 1]
            val = (t00 * (1 - fx) + t01 * fx) * (1 - fy) + (t10 * (1 - fx) + t11 * fx) * fy
            img = np.where(ok, val, img)
            depth = np.where(ok, s, depth)
        return img, depth

    def render(self, k: int) -> np.ndarray:
        img, _ = self._cast(k)
        if self.noise_sigma > 0:
            rng = np.random.default_rng(self.seed * 1_000_003 + k)
            img = img + rng.normal(0, self.noise_sigma, img.shape)
        return np.clip(img, 0, 255).astype(np.float32).reshape(self.h, self.w)

    def depth(self, k: int) -> np.ndarray:
        """Camera-z depth [H, W] of frame k (ray parameter at camera z = 1)."""
        return self._cast(k)[1].reshape(self.h, self.w)

    def gt_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        Rs, ts = zip(*(self.pose(k) for k in range(self.n_frames)))
        return np.stack(Rs), np.stack(ts)

"""Synthetic city-loop sequence (twin of cvsteer_tpu.io.synth, without
OpenCV).

A closed rounded-square street circuit driven by a forward-facing camera at
rig height, with exact ground-truth poses: the world is textured planes
(building facades along both street sides and the ground), each frame
ray-casts every plane analytically and z-buffers them. Facade textures
are seeded mosaics of random crops of the reference's test photograph
(``io/golden/fish.png``, a lossless copy of OpenCV's grayscale decode of
``tests/assets/fish.jpg``), distinct per wall so signature-based loop
detection can tell street segments apart.

The reference resizes mosaic crops with ``cv2.resize(INTER_AREA)`` and
samples textures with ``cv2.remap(INTER_LINEAR)``. :func:`resize_area` and
:func:`remap_linear_u8` reproduce OpenCV's arithmetic in numpy (the area
table and float32 sums of the first; the float32 lerps of OpenCV 5's remap
for the second, whose 4.x predecessor used 5-bit fixed-point weights), so
the same parameters give the reference's frames on a machine without
OpenCV.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

from cvsteer_tpu_torch.io.imageio import imread_gray_f32

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "fish.png")


class _Plane(NamedTuple):
    p0: np.ndarray  # [3] origin (world)
    ex: np.ndarray  # [3] unit texture-x direction (world)
    ey: np.ndarray  # [3] unit texture-y direction (world)
    n: np.ndarray  # [3] unit normal
    tex: np.ndarray  # [h, w] uint8
    px_per_m: float


def _area_table(ssize: int, dsize: int):
    """OpenCV's downscale area table along one axis (computeResizeAreaTab):
    per output index the source indices and float32 weights in OpenCV's
    order, zero-padded to one width: (si [dsize, k], alpha [dsize, k])."""
    scale = ssize / dsize
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(row)
    k = max(len(r) for r in rows)
    si = np.zeros((dsize, k), np.int64)
    alpha = np.zeros((dsize, k), np.float32)
    for d, row in enumerate(rows):
        for n, (s, a) in enumerate(row):
            si[d, n], alpha[d, n] = s, np.float32(a)
    return si, alpha


def _linear_area_table(ssize: int, dsize: int):
    """OpenCV's upscale INTER_AREA coefficients along one axis (resize's
    linear table in area mode): (s0 [dsize], s1 [dsize], w0, w1 float32);
    at the far border both taps are the last source index."""
    inv = dsize / ssize
    scale = 1.0 / inv
    s0 = np.zeros(dsize, np.int64)
    f = np.zeros(dsize, np.float32)
    for d in range(dsize):
        sx = int(np.floor(d * scale))
        fx = np.float32((d + 1) - (sx + 1) * inv)
        fx = np.float32(0.0) if fx <= 0 else np.float32(fx - np.floor(fx))
        if sx >= ssize - 1:
            fx, sx = np.float32(0.0), ssize - 1
        s0[d], f[d] = sx, fx
    return s0, np.minimum(s0 + 1, ssize - 1), np.float32(1.0) - f, f


def resize_area(src: np.ndarray, dsize: int) -> np.ndarray:
    """``cv2.resize(src, (dsize, dsize), interpolation=cv2.INTER_AREA)`` of a
    square float32 image, in OpenCV's float32 arithmetic: area averaging
    when shrinking, OpenCV's area-mode linear taps when enlarging, a copy
    at equal size."""
    src = np.asarray(src, np.float32)
    ssize = src.shape[0]
    if ssize == dsize:
        return src.copy()
    if ssize > dsize:
        si, alpha = _area_table(ssize, dsize)
        buf = np.zeros((ssize, dsize), np.float32)
        for n in range(si.shape[1]):  # OpenCV's tap order, float32 sums
            buf += src[:, si[:, n]] * alpha[:, n]
        out = np.zeros((dsize, dsize), np.float32)
        for n in range(si.shape[1]):
            out += alpha[:, n, None] * buf[si[:, n]]
        return out
    s0, s1, w0, w1 = _linear_area_table(ssize, dsize)
    rows = src[:, s0] * w0 + src[:, s1] * w1  # horizontal pass
    return rows[s0] * w0[:, None] + rows[s1] * w1[:, None]


def remap_linear_u8(tex: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """``cv2.remap(tex, mapx, mapy, cv2.INTER_LINEAR)`` of a uint8 image with
    float32 maps and OpenCV's default constant border (0 for every tap
    outside the image), in the arithmetic of OpenCV 5's remap kernels:
    float32 fractions, two horizontal lerps and one vertical, rounded to
    nearest even."""
    th, tw = tex.shape
    pad = np.zeros((th + 2, tw + 2), np.float32)  # the constant border
    pad[1:-1, 1:-1] = tex
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    fx, fy = np.floor(mapx), np.floor(mapy)
    al, be = mapx - fx, mapy - fy
    def tap(f, n):  # padded index of a tap; outside -> the zero border at 0
        i = np.clip(f, -2, n + 1).astype(np.int64) + 1
        return np.where((i >= 1) & (i <= n), i, 0)

    x0, x1 = tap(fx, tw), tap(fx + 1, tw)
    y0, y1 = tap(fy, th), tap(fy + 1, th)
    p00, p01 = pad[y0, x0], pad[y0, x1]
    p10, p11 = pad[y1, x0], pad[y1, x1]
    v0 = p00 + al * (p01 - p00)
    v1 = p10 + al * (p11 - p10)
    return np.clip(np.rint(v0 + be * (v1 - v0)), 0, 255).astype(np.uint8)


def _mosaic(rng: np.random.Generator, h_px: int, w_px: int, base: np.ndarray,
            tile: int = 96, gain: float = 1.0) -> np.ndarray:
    """Seeded mosaic of random photo crops (crop size 48..176 resized to the
    tile, rotation, flips, polarity inversion and brightness jitter):
    distinct, feature-rich texture. The reference's draws, in its order."""
    th, tw = base.shape
    out = np.empty((h_px, w_px), np.uint8)
    for y in range(0, h_px, tile):
        for x in range(0, w_px, tile):
            cs = int(rng.integers(48, 177))
            cs = min(cs, th - 1, tw - 1)
            cy = int(rng.integers(0, th - cs)) if th > cs else 0
            cx = int(rng.integers(0, tw - cs)) if tw > cs else 0
            patch = base[cy : cy + cs, cx : cx + cs].astype(np.float32)
            patch = resize_area(patch, tile)
            k_rot = int(rng.integers(0, 4))
            if k_rot:
                patch = np.rot90(patch, k_rot)
            if rng.uniform() < 0.5:
                patch = patch[:, ::-1]
            if rng.uniform() < 0.25:
                patch = 255.0 - patch
            patch = patch * float(rng.uniform(0.6, 1.1)) * gain
            patch += float(rng.uniform(-20, 20))
            ph = min(tile, h_px - y)
            pw = min(tile, w_px - x)
            out[y : y + ph, x : x + pw] = np.clip(patch[:ph, :pw], 0, 255)
    return out


def _rounded_rect_path(L: float, r: float, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Centers [N, 2] (x, z) and unit tangents [N, 2] of a rounded-square
    circuit of side ``L`` (corner radius ``r``) at arc lengths ``s``."""
    a = L - 2 * r  # straight segment length
    quarter = a + np.pi * r / 2
    per = 4 * quarter
    s = np.mod(s, per)
    side = (s // quarter).astype(np.int64)
    u = s - side * quarter
    h = L / 2
    pts = np.empty((len(s), 2))
    tans = np.empty((len(s), 2))
    for k in range(4):
        sel = side == k
        if not sel.any():
            continue
        uu = u[sel]
        straight = uu < a
        p = np.empty((sel.sum(), 2))
        t = np.empty((sel.sum(), 2))
        # canonical side 0: from (-a/2, -h) to (a/2, -h) heading +x, then
        # the corner arc turning left (CCW) toward side 1
        p[straight] = np.stack(
            [uu[straight] - a / 2, np.full(straight.sum(), -h)], 1
        )
        t[straight] = np.array([1.0, 0.0])
        phi = (uu[~straight] - a) / r  # 0..pi/2
        cx, cz = a / 2, -h + r
        p[~straight] = np.stack(
            [cx + r * np.sin(phi), cz - r * np.cos(phi)], 1
        )
        t[~straight] = np.stack([np.cos(phi), np.sin(phi)], 1)
        ang = k * np.pi / 2  # rotate canonical side into place (CCW)
        c, sn = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -sn], [sn, c]])
        pts[sel] = p @ rot.T
        tans[sel] = t @ rot.T
    return pts, tans


class CityLoop:
    """Streaming renderer of the city-block circuit.

    ``pose(k)`` -> exact (R, t) ground truth (world->camera);
    ``render(k)`` -> [H, W] uint8 frame. Identical output for identical
    (seed, geometry) — the sequence is reproducible from its parameters.
    """

    def __init__(
        self,
        n_frames: int = 2400,
        laps: float = 1.75,
        side: float = 120.0,
        street_half_width: float = 4.0,
        wall_height: float = 6.0,
        cam_height: float = 1.5,
        image_hw: Tuple[int, int] = (240, 320),
        fx: float = 300.0,
        fy: float = 300.0,
        seed: int = 7,
        noise_sigma: float = 2.0,
        far: float = 80.0,
    ):
        self.n_frames = int(n_frames)
        self.h, self.w = image_hw
        self.fx, self.fy = float(fx), float(fy)
        self.cx, self.cy = self.w / 2.0, self.h / 2.0
        self.far = float(far)
        self.noise_sigma = float(noise_sigma)
        self.seed = int(seed)

        base = imread_gray_f32(_ASSET)
        if base is None:
            raise FileNotFoundError(_ASSET)
        base = base.astype(np.uint8)
        rng = np.random.default_rng(seed)

        L, hw, H = side, street_half_width, wall_height
        r = 8.0
        a = L - 2 * r
        self._L = L
        self._perimeter = 4 * (a + np.pi * r / 2)
        self._step = laps * self._perimeter / n_frames
        self._cam_h = cam_height

        # 8 facade planes: inner square (side L - 2*hw) and outer square
        # (side L + 2*hw), walls facing the street; ground plane y = 0.
        # World: x-z ground plane, y UP is -y in camera terms... we keep
        # y down-positive = 0 at ground, camera at y = -cam_height.
        ppm_wall = 40.0  # texture px per meter
        self.planes: List[_Plane] = []

        def add_square_walls(half: float, inward: bool):
            # 4 vertical walls of the square |x|,|z| <= half, texture-x
            # along the wall, texture-y downward from the top edge
            for k in range(4):
                ang = k * np.pi / 2
                c, sn = np.cos(ang), np.sin(ang)
                rot = np.array([[c, -sn], [sn, c]])
                # canonical wall: z = -half plane, x from -half..half
                p0_2d = rot @ np.array([-half, -half])
                ex_2d = rot @ np.array([1.0, 0.0])
                n_2d = rot @ np.array([0.0, 1.0 if inward else -1.0])
                w_px = int(2 * half * ppm_wall)
                h_px = int(H * ppm_wall)
                tex = _mosaic(rng, h_px, w_px, base)
                self.planes.append(
                    _Plane(
                        p0=np.array([p0_2d[0], -H, p0_2d[1]]),
                        ex=np.array([ex_2d[0], 0.0, ex_2d[1]]),
                        ey=np.array([0.0, 1.0, 0.0]),
                        n=np.array([n_2d[0], 0.0, n_2d[1]]),
                        tex=tex,
                        px_per_m=ppm_wall,
                    )
                )

        add_square_walls(L / 2 + hw, inward=True)   # outer walls face in
        add_square_walls(L / 2 - hw, inward=False)  # inner walls face out

        # ground: y = 0 plane over the full block
        g_half = L / 2 + hw
        ppm_g = 12.0
        g_px = int(2 * g_half * ppm_g)
        gtex = _mosaic(rng, g_px, g_px, base, tile=128, gain=0.5)
        self.planes.append(
            _Plane(
                p0=np.array([-g_half, 0.0, -g_half]),
                ex=np.array([1.0, 0.0, 0.0]),
                ey=np.array([0.0, 0.0, 1.0]),
                n=np.array([0.0, -1.0, 0.0]),
                tex=gtex,
                px_per_m=ppm_g,
            )
        )

        # precomputed camera-frame ray directions (z = 1)
        us, vs = np.meshgrid(np.arange(self.w), np.arange(self.h))
        self._rays = np.stack(
            [(us - self.cx) / self.fx, (vs - self.cy) / self.fy,
             np.ones_like(us, np.float64)], -1,
        ).reshape(-1, 3)

    @property
    def intrinsics4(self) -> Tuple[float, float, float, float]:
        return self.fx, self.fy, self.cx, self.cy

    def pose(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact world->camera pose of frame k (forward-facing driving).

        Camera convention: x right, y down (world +y is down-positive),
        z forward along the path tangent."""
        s = np.array([k * self._step])
        (pxz,), (txz,) = _rounded_rect_path(self._L, 8.0, s)
        c = np.array([pxz[0], -self._cam_h, pxz[1]])
        z = np.array([txz[0], 0.0, txz[1]])
        z = z / np.linalg.norm(z)
        y = np.array([0.0, 1.0, 0.0])  # camera y = world down
        x = np.cross(y, z)
        R = np.stack([x, y, z], 0)  # rows = camera axes in world
        t = -R @ c
        return R.astype(np.float32), t.astype(np.float32)

    def render(self, k: int) -> np.ndarray:
        R, t = self.pose(k)
        R64, t64 = R.astype(np.float64), t.astype(np.float64)
        C = -R64.T @ t64
        dirs = self._rays @ R64  # world-frame ray dirs (cam z = 1)

        depth = np.full(self.h * self.w, np.inf)
        img = np.full(self.h * self.w, 200.0)  # sky
        for pl in self.planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = dirs @ pl.n
                s = ((pl.p0 - C) @ pl.n) / denom
                ok = (s > 0.3) & (s < self.far) & np.isfinite(s)
                if not ok.any():
                    continue
                s = np.where(ok, s, 1.0)  # keep masked rays finite
                P = C + s[:, None] * dirs
                ax = (P - pl.p0) @ pl.ex * pl.px_per_m
                ay = (P - pl.p0) @ pl.ey * pl.px_per_m
            th, tw = pl.tex.shape
            ok &= (ax >= 0) & (ax < tw - 1) & (ay >= 0) & (ay < th - 1)
            ok &= s < depth
            if not ok.any():
                continue
            mapx = np.where(ok, ax, 0).astype(np.float32).reshape(self.h, self.w)
            mapy = np.where(ok, ay, 0).astype(np.float32).reshape(self.h, self.w)
            vals = remap_linear_u8(pl.tex, mapx, mapy).reshape(-1)
            img = np.where(ok, vals, img)
            depth = np.where(ok, s, depth)

        if self.noise_sigma > 0:
            rng = np.random.default_rng(self.seed * 1_000_003 + k)
            img = img + rng.normal(0, self.noise_sigma, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8).reshape(self.h, self.w)

    def depth(self, k: int) -> np.ndarray:
        """Ground-truth camera-z depth [H, W] for frame k (inf = sky).

        The same plane intersection as render() without the texture pass;
        used by drift/bias diagnostics (scripts/probe_tri_bias.py) to
        compare triangulated landmark depths against analytic truth."""
        R, t = self.pose(k)
        R64, t64 = R.astype(np.float64), t.astype(np.float64)
        C = -R64.T @ t64
        dirs = self._rays @ R64
        depth = np.full(self.h * self.w, np.inf)
        for pl in self.planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = dirs @ pl.n
                s = ((pl.p0 - C) @ pl.n) / denom
                ok = (s > 0.3) & (s < self.far) & np.isfinite(s)
                if not ok.any():
                    continue
                s_safe = np.where(ok, s, 1.0)
                P = C + s_safe[:, None] * dirs
                ax = (P - pl.p0) @ pl.ex * pl.px_per_m
                ay = (P - pl.p0) @ pl.ey * pl.px_per_m
            th, tw = pl.tex.shape
            ok &= (ax >= 0) & (ax < tw - 1) & (ay >= 0) & (ay < th - 1)
            ok &= s_safe < depth
            depth = np.where(ok, s_safe, depth)
        return depth.reshape(self.h, self.w)

    def gt_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        Rs, ts = zip(*(self.pose(k) for k in range(self.n_frames)))
        return np.stack(Rs), np.stack(ts)

"""Seeded scenes with exact ground truth, rendered on the device in plain PyTorch.

A copy, rewritten for the device, of the port's ``io/render.PlanesSequence``
scene: a textured back wall at z = 5 m and four textured panels at 2.4 to
3.6 m in front of it, ray-cast analytically (z-buffered) through a pinhole
camera, each plane's texture read bilinearly. Textures are multi-octave
value noise under flat random rectangles, made on the device from one
``torch.Generator``.

The camera follows a periodic handheld motion (:class:`Motion`): every
translation and rotation component is a sum of sines with a whole number of
cycles in ``period`` frames, so the trajectory and its derivatives are
continuous across the period's wrap and a stream can replay the rendered
period for as long as a run lasts. Amplitudes are scaled so that the mean
translational and rotational speeds equal the traffic's (TUM fr1/xyz:
0.244 m/s and 8.920 deg/s at 30 Hz).

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: the planes of PlanesSequence: texture origin, width and height in metres
#: (texture x along world x, texture y along world y, normal -z)
PLANES = (
    ((-5.0, -3.5, 5.0), (10.0, 7.0)),
    ((-2.2, -1.6, 3.0), (1.6, 1.3)),
    ((0.4, -1.2, 2.4), (1.2, 1.0)),
    ((-0.8, 0.3, 3.6), (1.8, 1.2)),
    ((1.2, 0.2, 3.2), (1.4, 1.4)),
)
PX_PER_M = 100.0
OCTAVES = ((64, 60.0), (24, 45.0), (10, 35.0), (4, 20.0))


def _texture(gen: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """[h, w] float32 in [0, 255]: value noise at four cell sizes, flat
    rectangles (h w / 4000 of them, 8-39 px a side) drawn in order on top,
    a 3x3 box blur with clamped edges."""
    tex = torch.full((h, w), 128.0, dtype=torch.float32, device=device)
    for cell, amp in OCTAVES:
        grid = torch.rand((1, 1, h // cell + 2, w // cell + 2), generator=gen, device=device) * 2 - 1
        tex += amp * F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)[0, 0]
    n = h * w // 4000
    if n:
        size = torch.randint(8, 40, (n, 2), generator=gen, device=device)
        y0 = torch.randint(0, h, (n,), generator=gen, device=device)
        x0 = torch.randint(0, w, (n,), generator=gen, device=device)
        val = torch.rand((n,), generator=gen, device=device) * 255.0
        ys = torch.arange(h, device=device)[None, :, None]
        xs = torch.arange(w, device=device)[None, None, :]
        inside = ((ys >= y0[:, None, None]) & (ys < (y0 + size[:, 0])[:, None, None])
                  & (xs >= x0[:, None, None]) & (xs < (x0 + size[:, 1])[:, None, None]))
        # the last rectangle drawn over a pixel wins
        order = torch.arange(1, n + 1, device=device)[:, None, None]
        top = (inside * order).amax(0)
        tex = torch.where(top > 0, val[(top - 1).clamp_min(0)], tex)
    blurred = F.avg_pool2d(F.pad(tex[None, None], (1, 1, 1, 1), mode="replicate"), 3, stride=1)
    return blurred[0, 0].clamp(0.0, 255.0)


class Scene:
    """One stream's textured planes, seeded by ``seed`` on ``device``."""

    def __init__(self, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2**63))
        self.device = device
        self.planes = []
        for (x0, y0, z0), (wm, hm) in PLANES:
            tex = _texture(gen, int(hm * PX_PER_M), int(wm * PX_PER_M), device)
            self.planes.append(((x0, y0, z0), tex))


class Motion(NamedTuple):
    """A periodic handheld motion around the origin, looking down +z.

    ``cycles`` / ``rot_cycles``: whole cycles per period of each axis (x, y,
    z); ``shape`` / ``rot_shape``: relative amplitudes before the speed
    scaling; ``phases`` [6]: each component's phase (radians)."""

    period: int
    fps: float
    speed_mps: float
    rot_speed_dps: float
    cycles: Sequence[int]
    shape: Sequence[float]
    rot_cycles: Sequence[int]
    rot_shape: Sequence[float]
    phases: Sequence[float]

    def _raw(self, k: np.ndarray):
        w = 2.0 * math.pi * np.asarray(k, np.float64)[:, None] / self.period
        ph = np.asarray(self.phases, np.float64)
        c = np.asarray(self.shape) * np.sin(w * np.asarray(self.cycles) + ph[:3])
        a = np.asarray(self.rot_shape) * np.sin(w * np.asarray(self.rot_cycles) + ph[3:])
        return c, a

    def _scales(self):
        """(translation scale, rotation scale) that give the mean speeds
        (the rotation's by a few fixed-point steps: the mean angular speed
        is not linear in the amplitude)."""
        k = np.arange(self.period, dtype=np.float64)
        c, a = self._raw(k)
        c2, a2 = self._raw(k + 1)
        v = np.linalg.norm(c2 - c, axis=1).mean() * self.fps
        sa = 1e-3
        for _ in range(4):
            ang = np.mean([_angle(_rot(sa * a2[i]) @ _rot(sa * a[i]).T) for i in range(len(k))])
            sa *= math.radians(self.rot_speed_dps) / (ang * self.fps)
        return self.speed_mps / v, sa

    def poses(self, frames: np.ndarray):
        """World->camera (R [F, 3, 3], t [F, 3]) float64 at frame indices."""
        sc, sa = self._scales()
        c, a = self._raw(frames)
        c, a = c * sc, a * sa
        R = np.stack([_rot(ai).T for ai in a])  # camera->world is _rot(a)
        t = -np.einsum("fij,fj->fi", R, c)
        return R, t


def _rot(a) -> np.ndarray:
    """Camera->world rotation from (yaw about y, pitch about x, roll about z)."""
    yaw, pitch, roll = a
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    Rz = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]])
    return Ry @ Rx @ Rz


def _angle(R: np.ndarray) -> float:
    return math.acos(max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0)))


def motion_from(traffic: dict, rng: np.random.Generator) -> Motion:
    """A stream's Motion: the traffic's speeds and shape, phases from ``rng``."""
    m = traffic["motion"]
    return Motion(
        period=int(m["period_frames"]), fps=float(m["fps"]),
        speed_mps=float(m["speed_mps"]), rot_speed_dps=float(m["rot_speed_dps"]),
        cycles=tuple(m["cycles"]), shape=tuple(m["shape"]),
        rot_cycles=tuple(m["rot_cycles"]), rot_shape=tuple(m["rot_shape"]),
        phases=tuple(rng.uniform(0.0, 2.0 * math.pi, 6)),
    )


def render(scene: Scene, R: np.ndarray, t: np.ndarray, hw, intr, noise_seed: int,
           noise_sigma: float = 1.0, chunk: int = 16) -> torch.Tensor:
    """uint8 frames [F, H, W] on the scene's device, seen from world->camera
    poses (R [F, 3, 3], t [F, 3]), with Gaussian pixel noise of
    ``noise_sigma`` drawn from ``noise_seed``, rounded and clipped as a
    camera's 8 bits are."""
    dev = scene.device
    H, W = hw
    fx, fy, cx, cy = intr
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(noise_seed) % (2**63))
    vs, us = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    rays = torch.stack([(us - cx) / fx, (vs - cy) / fy, torch.ones_like(us)], -1).reshape(-1, 3)
    out = torch.empty((len(R), H, W), dtype=torch.uint8, device=dev)
    for lo in range(0, len(R), chunk):
        Rc = torch.as_tensor(R[lo: lo + chunk], dtype=torch.float32, device=dev)
        tc = torch.as_tensor(t[lo: lo + chunk], dtype=torch.float32, device=dev)
        C = -torch.einsum("fji,fj->fi", Rc, tc)  # camera centres
        dirs = torch.einsum("pj,fji->fpi", rays, Rc)  # world ray directions
        n = len(Rc)
        depth = torch.full((n, H * W), float("inf"), device=dev)
        img = torch.full((n, H * W), 128.0, device=dev)
        for (x0, y0, z0), tex in scene.planes:
            th, tw = tex.shape
            s = (z0 - C[:, 2:3]) / dirs[..., 2]  # every plane's normal is -z
            Px = C[:, 0:1] + s * dirs[..., 0]
            Py = C[:, 1:2] + s * dirs[..., 1]
            ax = (Px - x0) * PX_PER_M
            ay = (Py - y0) * PX_PER_M
            ok = (torch.isfinite(s) & (s > 0.1) & (s < depth)
                  & (ax >= 0) & (ax < tw - 1) & (ay >= 0) & (ay < th - 1))
            xi = ax.floor().clamp(0, tw - 2)
            yi = ay.floor().clamp(0, th - 2)
            fxr, fyr = (ax - xi).clamp(0, 1), (ay - yi).clamp(0, 1)
            flat = tex.reshape(-1)
            i00 = (yi.long() * tw + xi.long())
            t00, t01 = flat[i00], flat[i00 + 1]
            t10, t11 = flat[i00 + tw], flat[i00 + tw + 1]
            val = (t00 * (1 - fxr) + t01 * fxr) * (1 - fyr) + (t10 * (1 - fxr) + t11 * fxr) * fyr
            img = torch.where(ok, val, img)
            depth = torch.where(ok, s, depth)
        if noise_sigma > 0:
            img = img + noise_sigma * torch.randn(img.shape, generator=gen, device=dev)
        out[lo: lo + n] = img.round().clamp(0, 255).to(torch.uint8).reshape(n, H, W)
    return out

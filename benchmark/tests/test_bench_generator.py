"""The generator: a continuous periodic motion at the traffic's speeds, and
frames that agree with the port's renderer at a small size."""

import math

import numpy as np
import torch

from benchmark import render
from benchmark.tests.small import load


def _motion(seed=3):
    _, tr = load("tum_vga_fleet", "staggered_xyz")
    return render.motion_from(tr, np.random.default_rng(seed)), tr


def test_bench_motion_is_continuous_across_the_wrap():
    m, _ = _motion()
    P = m.period
    R, t = m.poses(np.arange(-2, P + 3))
    c = -np.einsum("fji,fj->fi", R, t)
    # frames P + j and j coincide; velocity and acceleration at the wrap are
    # those of any other frame (second differences stay small)
    np.testing.assert_allclose(c[P:P + 3], c[0:3], atol=1e-12)
    np.testing.assert_allclose(R[P:P + 3], R[0:3], atol=1e-12)
    d1 = np.linalg.norm(np.diff(c, axis=0), axis=1)
    d2 = np.linalg.norm(np.diff(c, 2, axis=0), axis=1)
    assert d2.max() < 0.1 * d1.max()
    assert abs(d2[P] - d2[P - 1]) < 1e-3


def test_bench_motion_has_the_traffic_speeds():
    m, tr = _motion(5)
    R, t = m.poses(np.arange(m.period + 1))
    c = -np.einsum("fji,fj->fi", R, t)
    v = np.linalg.norm(np.diff(c, axis=0), axis=1).mean() * m.fps
    ang = np.mean([render._angle(R[i + 1] @ R[i].T) for i in range(m.period)]) * m.fps
    assert abs(v - tr["motion"]["speed_mps"]) < 1e-9
    assert abs(math.degrees(ang) - tr["motion"]["rot_speed_dps"]) < 0.01


def test_bench_frames_follow_the_seed():
    m, _ = _motion()
    R, t = m.poses(np.arange(3))
    a = render.render(render.Scene(7, "cpu"), R, t, (48, 64), (50.0, 50.0, 32.0, 24.0), 9)
    b = render.render(render.Scene(7, "cpu"), R, t, (48, 64), (50.0, 50.0, 32.0, 24.0), 9)
    c = render.render(render.Scene(8, "cpu"), R, t, (48, 64), (50.0, 50.0, 32.0, 24.0), 9)
    assert a.dtype == torch.uint8 and torch.equal(a, b) and not torch.equal(a, c)


def test_bench_renderer_agrees_with_the_ports_renderer():
    """The same planes and textures seen from PlanesSequence's poses: the
    copy renders what io/render.PlanesSequence renders (noise off), within
    one gray level on all but a few edge pixels."""
    from cvsteer_tpu_torch.io.render import PlanesSequence

    seq = PlanesSequence(n_frames=8, image_hw=(60, 80), fx=62.5, fy=62.5, cx=40.0, cy=30.0,
                         seed=2, noise_sigma=0.0)
    scene = render.Scene(0, "cpu")
    scene.planes = [((float(p.p0[0]), float(p.p0[1]), float(p.p0[2])), torch.from_numpy(p.tex))
                    for p in seq.planes]
    R, t = seq.gt_arrays()
    mine = render.render(scene, R.astype(np.float64), t.astype(np.float64), (60, 80),
                         (62.5, 62.5, 40.0, 30.0), 0, noise_sigma=0.0).float()
    theirs = torch.from_numpy(np.stack([np.round(seq.render(k)) for k in range(8)]))
    off = (mine - theirs).abs() > 1.0
    assert off.float().mean() < 0.01

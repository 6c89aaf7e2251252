"""The port's CityLoop sequence (cvsteer_tpu_torch.io.synth, numpy only)
against the JAX package's (cvsteer_tpu.io.synth, OpenCV), on CPU.

The texture: the port's committed fish.png equals OpenCV's grayscale
decode of tests/assets/fish.jpg. resize_area and remap_linear_u8 equal
cv2.resize(INTER_AREA) and cv2.remap(INTER_LINEAR) bit for bit on the
crops and maps CityLoop makes (and on maps past the texture's edges).
CityLoop.pose(k) within 1e-6 and render(k) within 1 gray level at >= 99.9 %
of pixels, on the reference's default circuit and on the cut one the
chip smoke run drives.
"""

import os

import cv2
import numpy as np
import pytest

from cvsteer_tpu.io.synth import CityLoop as RefCityLoop
from cvsteer_tpu_torch.io import synth
from cvsteer_tpu_torch.io.imageio import imread_gray_f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_EQUAL = 0.999


def test_torch_synth_texture_resize_and_remap_match_opencv():
    fish = cv2.imread(os.path.join(ROOT, "tests", "assets", "fish.jpg"), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(imread_gray_f32(synth._ASSET), fish.astype(np.float32))
    rng = np.random.default_rng(0)
    for cs in list(range(48, 177, 7)) + [96, 128, 176]:  # down, up and equal sizes
        for tile in (96, 128):
            y, x = rng.integers(0, 185 - cs), rng.integers(0, 256 - cs)
            patch = fish[y:y + cs, x:x + cs].astype(np.float32)
            np.testing.assert_array_equal(
                synth.resize_area(patch, tile),
                cv2.resize(patch, (tile, tile), interpolation=cv2.INTER_AREA))
    tex = rng.integers(0, 256, (240, 500)).astype(np.uint8)
    for lo, hi in (((0, 0), (498.9, 238.9)), ((-50, -50), (600, 300))):
        mx = rng.uniform(lo[0], hi[0], (60, 80)).astype(np.float32)
        my = rng.uniform(lo[1], hi[1], (60, 80)).astype(np.float32)
        np.testing.assert_array_equal(synth.remap_linear_u8(tex, mx, my),
                                      cv2.remap(tex, mx, my, cv2.INTER_LINEAR))


@pytest.mark.parametrize("kw,frames", [
    (dict(), (0, 1333)),  # the reference's default circuit (120 m, 2,400 frames)
    (dict(n_frames=900, laps=1.2, side=40.0), (0, 400, 761)),  # chip_smoke's cut
])
def test_torch_cityloop_matches_jax(kw, frames):
    ref, port = RefCityLoop(**kw), synth.CityLoop(**kw)
    for k in frames:
        for a, b in zip(port.pose(k), ref.pose(k)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        got, want = port.render(k), ref.render(k)
        close = np.abs(got.astype(np.int16) - want) <= 1
        equal = float((got == want).mean())
        print(f"parity CityLoop {kw or 'default'} frame {k}: {100 * equal:.3f} % of pixels equal, "
              f"{int((~close).sum())} more than 1 gray level off (bar {100 * MIN_EQUAL} % within 1)")
        assert close.mean() >= MIN_EQUAL
    np.testing.assert_allclose(port.depth(frames[-1]), ref.depth(frames[-1]))

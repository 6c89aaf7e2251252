"""The port's generic feature path and G4/H4 descriptors against the
reference, on CPU.

- phase_descriptors_g4 / phase_descriptors against the reference with
  fp32_sampling=True (the port samples fp32): within 1e-5.
- extract_features at order 4, score 'strength' and nms_radius 1 (the
  generic path) against the reference's CPU path, 2 levels of 64
  keypoints on a 96x128 image: the bar of tests/test_torch_features.py,
  >= 98 % of keypoints within 0.5 px at the same level and matched
  descriptors within 2e-2 (the reference samples its bf16 class).
- the one-call sampling of every level equals the per-level functions bit
  for bit, and a batch equals its images one at a time.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.features import descriptors as jd
from cvsteer_tpu.features.frontend import FrontendConfig as JConfig
from cvsteer_tpu.features.frontend import extract_features as j_extract
from cvsteer_tpu.features.keypoints import Keypoints as JKeypoints
from cvsteer_tpu_torch.features import descriptors as td
from cvsteer_tpu_torch.features import frontend as tf
from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig, extract_features
from cvsteer_tpu_torch.filters import g2 as tg2
from cvsteer_tpu_torch.filters import g4 as tg4
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)
SMALL = dict(levels=2, keypoints_per_level=64)


def _image(seed, shape=(96, 128)):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.random(shape).astype(np.float32) * 255, (0, 0), 1.5)
    return (img - img.min()) / np.ptp(img) * 255.0


def _keypoints(seed, n, hw):
    rng = np.random.default_rng(seed)
    yx = (rng.random((n, 2)) * (np.array(hw) - 1)).astype(np.float32)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    score = rng.random(n).astype(np.float32)
    return yx, score, theta, valid


@pytest.mark.parametrize("order,pi_invariant", [(4, False), (4, True), (2, False)])
def test_torch_phase_descriptors_match_jax_fp32(order, pi_invariant):
    rng = np.random.default_rng(order)
    basis = rng.standard_normal((11 if order == 4 else 7, 40, 56)).astype(np.float32)
    kp = _keypoints(order + 1, 50, (40, 56))  # clouds also cross the image edge
    kw = dict(grid=4, spacing=3.0, pi_invariant=pi_invariant, fp32_sampling=True)
    jf, tf_ = ((jd.phase_descriptors_g4, td.phase_descriptors_g4) if order == 4
               else (jd.phase_descriptors, td.phase_descriptors))
    jkp = JKeypoints(*(jnp.asarray(a) for a in kp))
    want = np.asarray(jf(jnp.asarray(basis), jkp, **kw))
    got = tf_(torch.from_numpy(basis), convert.keypoints(jkp, device="cpu"), **kw).numpy()
    assert got.shape == want.shape == (50, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[~kp[3]].any()


@pytest.mark.parametrize("kw", [dict(order=4), dict(score="strength"), dict(nms_radius=1)],
                         ids=["order4", "strength", "nms1"])
def test_torch_extract_features_generic_matches_jax(kw):
    img = _image(11)
    jc, tc = JConfig(**SMALL, **kw), FrontendConfig(**SMALL, **kw)
    fj = jax.jit(lambda im: j_extract(im, cfg=jc))(jnp.asarray(img))
    ft = extract_features(torch.from_numpy(img), cfg=tc)
    assert ft.yx.shape == (tc.capacity, 2) == np.asarray(fj.yx).shape
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() > 80
    yj, yt = np.asarray(fj.yx)[vj], ft.yx.numpy()[vt]
    lj, lt = np.asarray(fj.level)[vj], ft.level.numpy()[vt]
    d = np.linalg.norm(yj[:, None] - yt[None], axis=-1) + 1e3 * (lj[:, None] != lt[None])
    near = d.min(1) < 0.5
    assert near.mean() >= 0.98 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
    j = d.argmin(1)[near]
    dj, dt = np.asarray(fj.desc)[vj][near], ft.desc.numpy()[vt][j]
    assert np.abs(dj - dt).max() < 2e-2
    np.testing.assert_allclose(np.linalg.norm(dt, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("order", [2, 4])
def test_torch_generic_path_equals_per_level_functions(order):
    """Every level's descriptors from one sampling call (one kernel D launch
    on the card) equal _level_features level by level, bit for bit; a batch
    equals its images one at a time."""
    cfg = FrontendConfig(order=order, score="strength", upright_desc=order == 2, **SMALL)
    imgs = torch.from_numpy(np.stack([_image(12, (64, 80)), _image(13, (64, 80))]))
    got = extract_features(imgs, cfg=cfg)
    if order == 4:
        basis_fn, bank, fm = tg4.g4_basis, tg4.g4_bank(), tg4
        desc_fn = td.phase_descriptors_g4_batch
    else:
        basis_fn, bank, fm = tg2.g2_basis, tg2.g2_bank(), tg2
        desc_fn = td.phase_descriptors_batch
    parts = [
        tf._level_features(lv, lvl, cfg, basis_fn=lambda im: basis_fn(im, bank),
                           coeff_fn=fm.energy_coefficients, desc_batch_fn=desc_fn)
        for lvl, lv in enumerate(tf.gaussian_pyramid(imgs, cfg.levels))
    ]
    want = Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))
    assert int(got.valid.sum()) > 60
    for name, a, b in zip(Features._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    one = extract_features(imgs[1], cfg=cfg)
    for a, b in zip(got, one):
        assert torch.equal(a[1], b)

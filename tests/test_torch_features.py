"""The port's feature front-end and matcher against the reference, on CPU.

extract_features: the port runs the reference's fused TPU structure
(packed p3 cells, per-level top-k, kernel D sampling in fp32) while the
reference on CPU runs its generic XLA path (full-map NMS + exact top-k,
bf16 pair-table sampling); on the same image at least 98% of keypoints must
agree within 0.5 px at the same level, with matched descriptors within
2e-2 (the bf16 sampling class).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.features.frontend import extract_features as j_extract
from cvsteer_tpu.features.matching import match_descriptors as j_match
from cvsteer_tpu_torch.features.descriptors import phase_descriptors_batch
from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig, extract_features
from cvsteer_tpu_torch.features.keypoints import detect_keypoints_packed
from cvsteer_tpu_torch.filters import g2 as tg2
from cvsteer_tpu_torch.features.matching import gather_matched_points, match_descriptors

torch.set_num_threads(2)


def _image(seed, shape=(96, 128)):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.random(shape).astype(np.float32) * 255, (0, 0), 1.5)
    return (img - img.min()) / np.ptp(img) * 255.0


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_extract_features_matches_jax(seed):
    img = _image(seed)
    fj = jax.jit(j_extract)(jnp.asarray(img))
    ft = extract_features(torch.from_numpy(img))
    cap = FrontendConfig().capacity
    assert ft.yx.shape == (cap, 2) and ft.desc.shape == (cap, 32)
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() > 100
    yj, yt = np.asarray(fj.yx)[vj], ft.yx.numpy()[vt]
    lj, lt = np.asarray(fj.level)[vj], ft.level.numpy()[vt]
    d = np.linalg.norm(yj[:, None] - yt[None], axis=-1) + 1e3 * (lj[:, None] != lt[None])
    near = d.min(1) < 0.5
    assert near.mean() >= 0.98 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
    j = d.argmin(1)[near]
    dj, dt = np.asarray(fj.desc)[vj][near], ft.desc.numpy()[vt][j]
    assert np.abs(dj - dt).max() < 2e-2
    np.testing.assert_allclose(np.linalg.norm(dt, axis=-1), 1.0, atol=1e-5)


def test_torch_extract_features_options_match_jax():
    """upright_desc, desc_pi_invariant and level_capacity_decay, ported."""
    from cvsteer_tpu.features.frontend import FrontendConfig as JConfig

    kw = dict(upright_desc=True, desc_pi_invariant=True, level_capacity_decay=0.625)
    img = _image(4)
    fj = jax.jit(lambda im: j_extract(im, cfg=JConfig(**kw)))(jnp.asarray(img))
    cfg = FrontendConfig(**kw)
    ft = extract_features(torch.from_numpy(img), cfg=cfg)
    assert ft.yx.shape[0] == cfg.capacity == np.asarray(fj.yx).shape[0] < FrontendConfig().capacity
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    yj, yt = np.asarray(fj.yx)[vj], ft.yx.numpy()[vt]
    d = np.linalg.norm(yj[:, None] - yt[None], axis=-1)
    near = d.min(1) < 0.5
    assert near.mean() >= 0.98
    dj, dt = np.asarray(fj.desc)[vj][near], ft.desc.numpy()[vt][d.argmin(1)[near]]
    assert np.abs(dj - dt).max() < 2e-2


def test_torch_extract_features_batched_equals_single():
    imgs = np.stack([_image(2, (64, 80)), _image(3, (64, 80))])
    batch = extract_features(torch.from_numpy(imgs))
    for b in range(2):
        one = extract_features(torch.from_numpy(imgs[b]))
        for a, c in zip(batch, one):
            np.testing.assert_array_equal(a[b].numpy(), c.numpy())


def _per_level_features(imgs: torch.Tensor, cfg: FrontendConfig) -> Features:
    """extract_features as the composition of the public per-level
    functions: one g2_features_full, top-k and descriptor call per level."""
    from cvsteer_tpu_torch.ops.cuda_frontend import g2_features_full
    from cvsteer_tpu_torch.ops.pyramid import gaussian_pyramid

    bank = tg2.g2_bank()
    parts = []
    for lvl, lv in enumerate(gaussian_pyramid(imgs, cfg.levels)):
        p3, dy, dx, ct, st, basis = g2_features_full(
            lv, bank.xtaps, bank.ytaps, threshold=cfg.threshold, nms_radius=cfg.nms_radius)
        kp = detect_keypoints_packed(p3, dy, dx, ct, st, max_keypoints=cfg.level_capacity(lvl))
        kp_d = kp._replace(theta=torch.zeros_like(kp.theta)) if cfg.upright_desc else kp
        desc = phase_descriptors_batch(basis, kp_d, grid=cfg.descriptor_grid,
                                       spacing=cfg.descriptor_spacing,
                                       pi_invariant=cfg.desc_pi_invariant)
        parts.append(Features(kp.yx * float(2**lvl), kp.score, kp.theta,
                              torch.full(kp.score.shape, lvl, dtype=torch.int32), desc, kp.valid))
    return Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))


@pytest.mark.parametrize("cfg", [
    FrontendConfig(),
    FrontendConfig(upright_desc=True, desc_pi_invariant=True, nms_radius=3, threshold=4.0),
])
def test_torch_extract_features_equals_per_level_composition(cfg):
    """All levels through one detector call and one descriptor call give the
    per-level results bit for bit (the steps are elementwise per keypoint)."""
    imgs = torch.from_numpy(np.stack([_image(5, (96, 128)), _image(6, (96, 128))]))
    got = extract_features(imgs, cfg=cfg)
    want = _per_level_features(imgs, cfg)
    assert int(got.valid.sum()) > 100
    for name, a, b in zip(Features._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("ratio,mutual", [(0.8, True), (0.95, True), (1.0, False)])
def test_torch_match_descriptors_identical_indices(ratio, mutual):
    rng = np.random.default_rng(7)
    n, m, dim = 120, 100, 32
    base = rng.normal(size=(m, dim))
    perm = rng.permutation(n) % m
    a = base[perm] + 0.3 * rng.normal(size=(n, dim))
    b = base + 0.3 * rng.normal(size=(m, dim))
    a = (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    b = (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)
    va, vb = rng.random(n) > 0.1, rng.random(m) > 0.1
    jm = j_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
                 ratio=ratio, mutual=mutual)
    tm = match_descriptors(torch.from_numpy(a), torch.from_numpy(va), torch.from_numpy(b),
                           torch.from_numpy(vb), ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(np.asarray(jm.index), tm.index.numpy())
    np.testing.assert_allclose(np.asarray(jm.score), tm.score.numpy(), atol=1e-6)
    assert int(tm.count) == int(jm.count) > 10
    pa, pb, ok = gather_matched_points(torch.zeros(n, 2), torch.arange(2 * m).reshape(m, 2), tm)
    assert pb.shape == (n, 2) and bool((ok == tm.valid).all())

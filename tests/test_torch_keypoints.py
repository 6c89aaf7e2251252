"""The port's generic keypoint detector against the reference, on CPU.

detect_keypoints, detect_keypoints_cs, detect_keypoints_premasked and
refine_selected_cs on seeded score maps (64x96, smooth noise: no exact
ties), the reference with approx=False (exact top-k, its CPU path). Bars:
the same keypoint sets (compared as sets, sorted by position, so the order
of equal scores does not matter), yx within 1e-5 px, theta within 1e-5 rad,
scores equal. The port's ``approx`` with ``pool`` 2 (the cell
pre-reduction before an exact top-k) is held to the reference's full top-k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from cvsteer_tpu.features import keypoints as jk
from cvsteer_tpu_torch.features import keypoints as tk

torch.set_num_threads(2)
TOL = 1e-5


def _maps(seed, shape=(64, 96)):
    """(strength, ct, st) float32: a smooth positive score and a unit
    orientation field."""
    rng = np.random.default_rng(seed)
    s = gaussian_filter(rng.standard_normal(shape), 1.5).astype(np.float32)
    s = (s - s.min()) * 10.0
    th = gaussian_filter(rng.standard_normal(shape), 3.0).astype(np.float32) * 4.0
    return s, np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _same(j, t):
    """Hold a port Keypoints ``t`` to a reference one ``j`` as sets."""
    vj, vt = np.asarray(j.valid), t.valid.numpy()
    assert vj.sum() == vt.sum() > 20
    assert t.yx.shape == np.asarray(j.yx).shape
    yj, yt = np.asarray(j.yx)[vj], t.yx.numpy()[vt]
    oj, ot = np.lexsort(np.round(yj, 3).T), np.lexsort(np.round(yt, 3).T)
    np.testing.assert_allclose(yt[ot], yj[oj], atol=TOL, rtol=0)
    np.testing.assert_allclose(t.theta.numpy()[vt][ot], np.asarray(j.theta)[vj][oj], atol=TOL, rtol=0)
    np.testing.assert_array_equal(t.score.numpy()[vt][ot], np.asarray(j.score)[vj][oj])
    for f in (t.yx, t.score, t.theta):  # invalid slots are zeroed
        assert not f.numpy()[~vt].any()


@pytest.mark.parametrize("nms_radius,border,threshold", [(1, None, 0.0), (3, None, 5.0), (2, 6, 1.0)])
def test_torch_detect_keypoints_matches_jax(nms_radius, border, threshold):
    s, ct, st = _maps(nms_radius)
    theta = np.arctan2(st, ct)
    kw = dict(max_keypoints=96, nms_radius=nms_radius, threshold=threshold, border=border)
    j = jk.detect_keypoints(jnp.asarray(s), jnp.asarray(theta), **kw)
    t = tk.detect_keypoints(torch.from_numpy(s), torch.from_numpy(theta), **kw)
    _same(j, t)


@pytest.mark.parametrize("row_range", [None, (9, 40)])
def test_torch_detect_keypoints_cs_matches_jax(row_range):
    s, ct, st = _maps(4)
    kw = dict(max_keypoints=80, nms_radius=2, threshold=2.0, row_range=row_range)
    j = jk.detect_keypoints_cs(*(jnp.asarray(a) for a in (s, ct, st)), **kw)
    t = tk.detect_keypoints_cs(*(torch.from_numpy(a) for a in (s, ct, st)), **kw)
    _same(j, t)
    if row_range is not None:
        rows = t.yx.numpy()[t.valid.numpy(), 0]
        assert rows.min() >= row_range[0] - 0.5 and rows.max() < row_range[1] + 0.5


@pytest.mark.parametrize("pool", [1, 2])
def test_torch_detect_keypoints_premasked_matches_jax(pool):
    """The port's pool-2 cell pre-reduction (approx) selects what the
    reference's exact full top-k selects (one NMS survivor per cell)."""
    s, ct, st = _maps(5)
    masked = np.where(np.asarray(jk._maxpool_same(jnp.asarray(s), 3)) <= s, s, -np.inf)
    masked[:2], masked[-2:], masked[:, :2], masked[:, -2:] = -np.inf, -np.inf, -np.inf, -np.inf
    masked = masked.astype(np.float32)
    j = jk.detect_keypoints_premasked(*(jnp.asarray(a) for a in (s, masked, ct, st)),
                                      max_keypoints=64, approx=False)
    t = tk.detect_keypoints_premasked(*(torch.from_numpy(a) for a in (s, masked, ct, st)),
                                      max_keypoints=64, approx=pool > 1, pool=pool)
    _same(j, t)


def test_torch_refine_selected_cs_and_capacity_padding_match_jax():
    """Preselected indices (the cross-level batch form), and a level with
    fewer pixels than the capacity (-inf padding, invalid slots)."""
    s, ct, st = _maps(6)
    idx = np.random.default_rng(0).choice(s.size, 40, replace=False)
    scores = np.where(np.arange(40) < 30, s.reshape(-1)[idx], -np.inf).astype(np.float32)
    j = jk.refine_selected_cs(*(jnp.asarray(a) for a in (s, ct, st, scores, idx)))
    t = tk.refine_selected_cs(*(torch.from_numpy(a) for a in (s, ct, st, scores, idx)))
    _same(j, t)
    tiny = [np.random.default_rng(1).random((6, 7)).astype(np.float32), ct[:6, :7].copy(),
            st[:6, :7].copy()]
    j = jk.detect_keypoints_cs(*(jnp.asarray(a) for a in tiny), max_keypoints=64, nms_radius=1)
    t = tk.detect_keypoints_cs(*(torch.from_numpy(a) for a in tiny), max_keypoints=64, nms_radius=1)
    assert t.yx.shape == (64, 2) and np.asarray(j.valid).sum() == t.valid.numpy().sum() > 0
    np.testing.assert_allclose(t.yx.numpy()[t.valid.numpy()], np.asarray(j.yx)[np.asarray(j.valid)],
                               atol=TOL, rtol=0)


def test_torch_detect_keypoints_batched_equals_single():
    """Leading batch axes (the reference vmaps one image at a time)."""
    maps = [_maps(k) for k in (7, 8, 9, 10)]
    batch = [torch.from_numpy(np.stack([m[i] for m in maps]).reshape(2, 2, 64, 96)) for i in range(3)]
    kb = tk.detect_keypoints_cs(*batch, max_keypoints=50, nms_radius=2, threshold=1.0)
    assert kb.yx.shape == (2, 2, 50, 2)
    for n, m in enumerate(maps):
        one = tk.detect_keypoints_cs(*(torch.from_numpy(a) for a in m), max_keypoints=50,
                                     nms_radius=2, threshold=1.0)
        for a, b in zip(kb, one):
            assert torch.equal(a.reshape(4, *a.shape[2:])[n], b)

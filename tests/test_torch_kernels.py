"""The port's kernel modules against the reference package, on CPU.

Every kernel of the port (cvsteer_tpu_torch.ops.cuda_frontend: A filter
bank, B pyramid down, C detector maps of all levels, E′ feature maps;
ops.cuda_desc: D descriptor sampling of all levels) takes its plain
PyTorch version for CPU tensors; these tests
hold those plain versions to the reference package's functions on the same
numpy inputs (the reference runs its XLA/CPU path, as its own suite does),
at the reference tests' bars. The kernels themselves run against their
plain versions on the card in tests/test_torch_cuda.py.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.features import descriptors as jdesc
from cvsteer_tpu.features.keypoints import Keypoints as JKeypoints
from cvsteer_tpu.filters import g2 as jg2
from cvsteer_tpu.features.keypoints import detect_keypoints_packed as j_detect_packed
from cvsteer_tpu.filters import taps as jtaps
from cvsteer_tpu.ops import pyramid as jpyr
from cvsteer_tpu.ops.pallas_frontend import P3_SENTINEL as J_SENTINEL
from cvsteer_tpu.ops.pallas_frontend import _g2_features_full_reference_xla, g2_feature_maps_pallas
from cvsteer_tpu.ops.interp import bilinear_sample_channels_last_pair_bf16 as j_pair_bf16
from cvsteer_tpu.ops.sepconv import filter_bank_xla
from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.features import descriptors as tdesc
from cvsteer_tpu_torch.features.keypoints import Keypoints
from cvsteer_tpu_torch.features.keypoints import detect_keypoints_packed
from cvsteer_tpu_torch.filters import g2 as tg2
from cvsteer_tpu_torch.filters import taps
from cvsteer_tpu_torch.ops import cuda_desc as cd
from cvsteer_tpu_torch.ops import cuda_frontend as cf
from cvsteer_tpu_torch.ops.interp import bilinear_sample_channels_last_pair_bf16
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain, reflect_indices

torch.set_num_threads(2)


def _texture(rng, shape):
    """Smooth random texture in 0..255 (blurred noise: real corners)."""
    img = rng.random(shape).astype(np.float32) * 255
    img = cv2.GaussianBlur(img.reshape(-1, shape[-1]), (0, 0), 1.2).reshape(shape)
    return (img - img.min()) / (np.ptp(img) + 1e-6) * 255.0


@pytest.mark.parametrize("bank_fn", ["g2h2_bank", "g4h4_bank"])
def test_torch_taps_bit_identical(bank_fn):
    ref, port = getattr(jtaps, bank_fn)(), getattr(taps, bank_fn)()
    assert ref.names == port.names
    assert ref.xtaps.dtype == port.xtaps.dtype == np.float32
    np.testing.assert_array_equal(ref.xtaps, port.xtaps)
    np.testing.assert_array_equal(ref.ytaps, port.ytaps)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_torch_reflect_indices_match_numpy_pad(n):
    """REFLECT_101 that keeps reflecting (np/jnp.pad 'reflect'), also where
    the pad exceeds the dimension — F.pad(mode='reflect') raises there."""
    for r in (1, 4, 6, 13):
        ref = np.pad(np.arange(n), r, mode="reflect")
        np.testing.assert_array_equal(reflect_indices(-r, n + r, n).numpy(), ref)


@pytest.mark.parametrize(
    "bank_fn,shape", [("g2h2_bank", (2, 40, 52)), ("g2h2_bank", (3, 5)), ("g4h4_bank", (24, 31))]
)
def test_torch_plain_bank_matches_filter_bank_xla(bank_fn, shape):
    bank = getattr(jtaps, bank_fn)()
    img = _texture(np.random.default_rng(1), shape) if min(shape) > 5 else (
        np.random.default_rng(1).random(shape).astype(np.float32) * 255
    )
    ref = np.asarray(filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps))
    got = filter_bank_plain(torch.from_numpy(img), bank.xtaps, bank.ytaps).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(30, 40), (7, 9), (13, 17), (5, 5), (3, 2), (2, 3), (1, 1)])
def test_torch_pyr_down_matches_jax_and_cv2(shape):
    """Odd sizes and levels smaller than the blur's 2-pixel pad included."""
    img = np.random.default_rng(2).random(shape).astype(np.float32) * 255
    got = cf.pyr_down(torch.from_numpy(img)).numpy()
    tol = 255 * 3e-5 + 1e-3  # tests/test_pallas_frontend.py:209-227
    ref = np.asarray(jpyr.pyr_down(jnp.asarray(img)))
    assert got.shape == ref.shape == (-(-shape[0] // 2), -(-shape[1] // 2))
    assert np.abs(got - ref).max() <= tol
    if min(shape) >= 2:
        assert np.abs(got - cv2.pyrDown(img)).max() <= tol


def test_torch_g2_energy_orientation_corner_match_jax():
    img = _texture(np.random.default_rng(11), (40, 52))
    bank = tg2.g2_bank()
    assert bank.radius == 4 and bank.xtaps.shape == (7, 9)
    jb = filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps)
    tb = torch.tensor(np.asarray(jb))
    jc, tc = jg2.energy_coefficients(jb), tg2.energy_coefficients(tb)
    scale = float(np.abs(np.asarray(jc[0])).max())
    for a, b in zip(jc, tc):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-5 * scale
    cs = tg2.corner_strength(*tc).numpy()
    assert np.abs(cs - np.asarray(jg2.corner_strength(*jc))).max() <= 1e-5 * scale
    (jt, js), (tt, ts) = jg2.dominant_orientation(jc[1], jc[2]), tg2.dominant_orientation(tc[1], tc[2])
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-5 * scale
    firm = np.asarray(js) > 1e-3 * scale  # orientation is undefined where |(c2, c3)| ~ 0
    assert np.abs(tt.numpy() - np.asarray(jt))[firm].max() <= 1e-4


def _feature_maps(shape, seed=3):
    img = _texture(np.random.default_rng(seed), shape)
    bank = jtaps.g2h2_bank()
    ref_fn = jax.jit(lambda im: _g2_features_full_reference_xla(im, bank.xtaps, bank.ytaps, 1.0, 2))
    ref = [np.array(a) for a in ref_fn(jnp.asarray(img))]
    got = [a.numpy() for a in cf.g2_features_full(
        torch.from_numpy(img), bank.xtaps, bank.ytaps, threshold=1.0, nms_radius=2)]
    return img, ref, got


def test_torch_g2_features_full_plain_matches_reference():
    _, ref, got = _feature_maps((2, 48, 64))
    p3r, dyr, dxr, ctr, str_, br = ref
    p3g, dyg, dxg, ctg, stg, bg = got
    assert np.abs(bg - br).max() <= 1e-5 * np.abs(br).max()
    # c3 ~ 0 with c2 < 0 is the half-angle's singular point (theta = +-pi/2):
    # there st's sign is rounding noise in both packages and ct = sqrt(~0)
    # magnifies one ulp of cos(2 theta) to ~1e-4, so it is left out
    c3 = -(br[:, 0] * br[:, 1]) - br[:, 1] * br[:, 2] - 0.9375 * (
        br[:, 5] * br[:, 6] + br[:, 3] * br[:, 4]) - 1.6875 * br[:, 4] * br[:, 5] - 0.1875 * br[:, 3] * br[:, 6]
    firm = np.abs(c3) > 1e-4 * np.abs(c3).max()
    assert np.abs(ctg - ctr)[firm].max() <= 1e-4
    assert np.abs(stg - str_)[firm].max() <= 1e-4
    for g, r in ((dyg, dyr), (dxg, dxr)):
        assert np.abs(g - r).max() <= 1e-4 * 0.5
    keep_r, keep_g = p3r > J_SENTINEL * 0.5, p3g > cf.P3_SENTINEL * 0.5
    assert (keep_r == keep_g).mean() >= 0.999
    both = keep_r & keep_g
    offs = lambda p: p.view(np.int32) & 15  # noqa: E731
    np.testing.assert_array_equal(offs(p3r)[both], offs(p3g)[both])
    assert np.abs(p3g[both] - p3r[both]).max() <= 1e-5 * np.abs(p3r[both]).max()


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 37, 53)])
def test_torch_g2_feature_maps_matches_reference(shape, record_property):
    """E′ (g2_feature_maps) against the reference's g2_feature_maps_pallas,
    run as its own suite runs it on the CPU (interpret mode, its bf16x3
    matrix-unit class): score within 1e-4 of its scale; ct/st within 5e-3
    where the orientation is firm (|c3| > 1e-4 of its max, as in
    test_torch_g2_features_full_plain_matches_reference)."""
    img = _texture(np.random.default_rng(12), shape)
    bank = jtaps.g2h2_bank()
    ref = [np.asarray(a) for a in g2_feature_maps_pallas(jnp.asarray(img), bank.xtaps, bank.ytaps)]
    got = [a.numpy() for a in cf.g2_feature_maps(torch.from_numpy(img), bank.xtaps, bank.ytaps)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape == shape and g.dtype == np.float32
    basis = np.asarray(filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps))
    b = [basis[..., k, :, :] for k in range(7)]
    c3 = -(b[0] * b[1]) - b[1] * b[2] - 0.9375 * (b[5] * b[6] + b[3] * b[4]) \
        - 1.6875 * b[4] * b[5] - 0.1875 * b[3] * b[6]
    firm = np.abs(c3) > 1e-4 * np.abs(c3).max()
    score_rel = np.abs(got[0] - ref[0]).max() / np.abs(ref[0]).max()
    orient = max(np.abs(g - r)[firm].max() for g, r in zip(got[1:], ref[1:]))
    print(f"parity g2_feature_maps {shape}: score {score_rel:.2e} of scale, ct/st {orient:.2e}")
    record_property("score_rel", float(score_rel))
    record_property("orient_abs", float(orient))
    assert score_rel <= 1e-4
    assert orient <= 5e-3


def test_torch_detect_keypoints_packed_same_sets():
    """Same p3/dy/dx/ct/st in, same keypoint SETS out (tie order of
    torch.topk and lax.approx_max_k may differ)."""
    _, ref, _ = _feature_maps((48, 64), seed=4)
    p3, dy, dx, ct, st, _ = ref
    jk = jax.jit(j_detect_packed, static_argnames="max_keypoints")(
        *(jnp.asarray(a) for a in (p3, dy, dx, ct, st)), max_keypoints=64)
    tk = detect_keypoints_packed(*(torch.tensor(a) for a in (p3, dy, dx, ct, st)),
                                 max_keypoints=64)
    jv, tv = np.asarray(jk.valid), tk.valid.numpy()
    assert jv.sum() == tv.sum() > 10

    def rows(yx, s, th, v):
        return sorted(map(tuple, np.round(np.c_[yx[v], s[v], th[v]], 5)))

    assert rows(np.asarray(jk.yx), np.asarray(jk.score), np.asarray(jk.theta), jv) == rows(
        tk.yx.numpy(), tk.score.numpy(), tk.theta.numpy(), tv)


def test_torch_descriptor_sampling_matches_pair_table_path():
    """Kernel D's plain version (fp32 corners) vs the reference's CPU
    sampling path (bf16 pair table): max/scale < 2e-2
    (tests/test_pallas_frontend.py:402-498)."""
    rng = np.random.default_rng(5)
    img = _texture(rng, (2, 40, 56))
    bank = jtaps.g2h2_bank()
    basis = np.array(filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps))
    n = 24
    yx = np.stack([rng.uniform(-2, 42, (2, n)), rng.uniform(-2, 58, (2, n))], -1).astype(np.float32)
    theta = rng.uniform(-1.5, 1.5, (2, n)).astype(np.float32)
    valid = np.ones((2, n), bool)
    zeros = np.zeros((2, n), np.float32)
    jkp = JKeypoints(jnp.asarray(yx), jnp.asarray(zeros), jnp.asarray(theta), jnp.asarray(valid))
    tkp = Keypoints(*(torch.from_numpy(a) for a in (yx, zeros, theta, valid)))
    ref, _, _ = jax.jit(lambda b, k: jdesc._rotated_grid_samples_batch(b, k, 4, 3.0))(
        jnp.asarray(basis), jkp)
    got, _, _ = tdesc._rotated_grid_samples_batch(torch.from_numpy(basis), tkp, 4, 3.0)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, n, 16, 7)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 2e-2
    # the bf16 pair-table sampler itself, same inputs in both packages
    tbl = np.ascontiguousarray(np.moveaxis(basis[0], 0, -1))
    ys, xs = yx[0, :, 0] + 0.3, yx[0, :, 1] - 0.7
    pj = np.asarray(j_pair_bf16(jnp.asarray(tbl), jnp.asarray(ys), jnp.asarray(xs)))
    pt = bilinear_sample_channels_last_pair_bf16(
        torch.from_numpy(tbl), torch.from_numpy(ys), torch.from_numpy(xs)).numpy()
    assert np.abs(pt - pj).max() <= 1e-6 * np.abs(pj).max()
    dref = np.asarray(jax.jit(jdesc.phase_descriptors_batch)(jnp.asarray(basis), jkp))
    dgot = tdesc.phase_descriptors_batch(torch.from_numpy(basis), tkp).numpy()
    assert np.abs(dgot - dref).max() < 2e-2


@pytest.mark.parametrize("wrapper", ["filter_bank", "pyr_down", "g2_features_full", "sample_patches",
                                     "g2_maps", "g4_maps", "filter_bank_adjoint", "g2_feature_maps",
                                     "g2_features_levels", "sample_patches_levels"])
def test_torch_wrappers_refuse_other_devices(wrapper):
    """A wrapper takes its plain version only for CPU tensors; any other
    device that is not CUDA is refused (never silently moved)."""
    x = torch.empty((1, 7, 16, 16), device="meta")
    xt = jtaps.g2h2_bank().xtaps
    call = {
        "filter_bank": lambda: cf.filter_bank(x[0, 0], xt, xt),
        "pyr_down": lambda: cf.pyr_down(x[0, 0]),
        "g2_features_full": lambda: cf.g2_features_full(x[0, 0], xt, xt, threshold=1.0),
        "sample_patches": lambda: cd.sample_patches(x, x[:, 0], x[:, 0]),
        "g2_maps": lambda: cf.g2_maps(x[0, 0], xt, xt),
        "g4_maps": lambda: cf.g4_maps(x[0, 0], jtaps.g4h4_bank().xtaps, jtaps.g4h4_bank().ytaps),
        "filter_bank_adjoint": lambda: cf.filter_bank_adjoint(x[0], xt, xt),
        "g2_feature_maps": lambda: cf.g2_feature_maps(x[0, 0], xt, xt),
        "g2_features_levels": lambda: cf.g2_features_levels([x[0, 0], x[0, 0, ::2]], xt, xt,
                                                            threshold=1.0),
        "sample_patches_levels": lambda: cd.sample_patches_levels([x, x], x[:, 0], x[:, 0], [8, 8]),
    }[wrapper]
    with pytest.raises(ValueError):
        call()


def test_torch_kernel_build_is_lazy_and_keyed_by_sources():
    """Importing the port builds nothing; the library name hashes the
    sources, so an edited kernel rebuilds."""
    assert kernels._lib is None or torch.cuda.is_available()
    path = kernels.library_path()
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    assert sorted(kernels.launch_counts()) == sorted(kernels.KERNELS)

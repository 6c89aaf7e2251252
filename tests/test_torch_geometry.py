"""The port's geometry and bundle adjustment against the reference, on CPU.

RANSAC draws its minimal sets from jax.random in the reference and from a
torch.Generator in the port, which never agree; the test draws the sets
with the reference's own sampler and injects them into the port
(``sets=``), then asks for the same inlier count and the same E up to sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.geometry import epipolar as jep
from cvsteer_tpu.geometry import pose as jpose
from cvsteer_tpu.slam import ba as jba
from cvsteer_tpu.slam import se3 as jse3
from cvsteer_tpu_torch.geometry import epipolar as tep
from cvsteer_tpu_torch.geometry import pose as tpose
from cvsteer_tpu_torch.geometry.camera import (
    Intrinsics,
    normalize_pixels,
    pixels_from_normalized,
    undistort_normalized_np,
)
from cvsteer_tpu_torch.slam import ba as tba
from cvsteer_tpu_torch.slam import se3 as tse3
from cvsteer_tpu_torch.utils.precision import precise

torch.set_num_threads(2)


def _two_view(seed=0, n=160, outliers=0.2, noise=1e-4):
    """The scene of tests/test_geometry.py::_synthetic_scene, plus invalid
    slots."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    axis = np.array([0.2, 1.0, 0.1])
    w = 0.15 * axis / np.linalg.norm(axis)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w, jnp.float32)), np.float64)
    t = np.array([0.5, 0.05, 0.02])
    t = t / np.linalg.norm(t)
    x1 = X[:, :2] / X[:, 2:]
    p2 = X @ R.T + t
    x2 = p2[:, :2] / p2[:, 2:]
    x1 = x1 + rng.normal(0, noise, x1.shape)
    x2 = x2 + rng.normal(0, noise, x2.shape)
    bad = rng.random(n) < outliers
    x2[bad] += rng.uniform(0.05, 0.3, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    valid = rng.random(n) > 0.05
    return x1.astype(np.float32), x2.astype(np.float32), valid, R, t


def _sign_normalized(E):
    E = np.asarray(E, np.float64)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_ransac_with_injected_sets_matches_jax(seed):
    x1, x2, valid, _, _ = _two_view(seed)
    key = jax.random.key(seed)
    sets = np.asarray(jep._sample_minimal_sets(key, jnp.asarray(valid), 128, 8))
    jr = jax.jit(jep.ransac_essential, static_argnames="num_hypotheses")(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key, num_hypotheses=128)
    tr = tep.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                              torch.from_numpy(valid), sets=torch.tensor(sets))
    assert int(tr.num_inliers) == int(jr.num_inliers) > 80
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    np.testing.assert_allclose(
        _sign_normalized(tr.E.numpy()), _sign_normalized(jr.E), atol=1e-4
    )


def test_torch_ransac_draws_with_a_generator():
    x1, x2, valid, _, _ = _two_view(3)
    args = (torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid))
    runs = [
        tep.ransac_essential(*args, torch.Generator().manual_seed(5), num_hypotheses=64)
        for _ in range(2)
    ]
    assert torch.equal(runs[0].inliers, runs[1].inliers)  # seeded: reproducible
    assert int(runs[0].num_inliers) > 80


def test_torch_recover_pose_and_triangulate_match_jax():
    x1, x2, valid, R_true, t_true = _two_view(4, outliers=0.0)
    E = np.asarray(jep.eight_point_essential_svd(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid, jnp.float32)))
    jp = jax.jit(jpose.recover_pose)(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(valid))
    tp = tpose.recover_pose(torch.tensor(E), torch.from_numpy(x1), torch.from_numpy(x2),
                            torch.from_numpy(valid))
    np.testing.assert_allclose(tp.R.numpy(), np.asarray(jp.R), atol=1e-4)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-4)
    assert int(tp.num_good) == int(jp.num_good) > 100
    np.testing.assert_array_equal(tp.cheirality.numpy(), np.asarray(jp.cheirality))
    good = tp.cheirality.numpy()
    jpts, tpts = np.asarray(jp.points)[good], tp.points.numpy()[good]
    assert np.abs(tpts - jpts).max() <= 1e-4 * np.abs(jpts).max()
    np.testing.assert_allclose(tp.R.numpy(), R_true, atol=2e-2)
    P1 = np.eye(3, 4, dtype=np.float32)
    P2 = np.concatenate([R_true, t_true[:, None]], 1).astype(np.float32)
    jX = np.asarray(jpose.triangulate(*(jnp.asarray(a) for a in (P1, P2, x1, x2))))
    tX = tpose.triangulate(*(torch.from_numpy(a) for a in (P1, P2, x1, x2))).numpy()
    assert np.abs(tX - jX).max() <= 1e-4 * np.abs(jX).max()


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.3, 3.1])
def test_torch_se3_matches_jax(scale):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * scale
    xi = np.concatenate([w, rng.normal(size=(6, 3)).astype(np.float32)], 1)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(tse3.exp_so3(torch.from_numpy(w)).numpy(), R, atol=1e-4)
    np.testing.assert_allclose(tse3.log_so3(torch.tensor(R)).numpy(),
                               np.asarray(jse3.log_so3(jnp.asarray(R))), atol=1e-4)
    for a, b in zip(tse3.exp_se3(torch.from_numpy(xi)), jse3.exp_se3(jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    t = torch.from_numpy(xi[:, 3:])
    Rt = torch.tensor(R)
    jR, jt = jnp.asarray(R), jnp.asarray(xi[:, 3:])
    for a, b in zip(tse3.compose(Rt, t, Rt, t), jse3.compose(jR, jt, jR, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for a, b in zip(tse3.invert(Rt, t), jse3.invert(jR, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(tse3.transform(Rt, t, t).numpy(),
                               np.asarray(jse3.transform(jR, jt, jt)), atol=1e-4)
    geo = tse3.rotation_geodesic(Rt, torch.eye(3).expand(6, 3, 3)).numpy()
    np.testing.assert_allclose(geo, np.asarray(jse3.rotation_geodesic(jnp.asarray(R), jnp.eye(3))),
                               atol=1e-3)


def _ba_problem(seed=9, C=4, L=80):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (L, 3)).astype(np.float32)
    R = np.stack([np.asarray(jse3.exp_so3(jnp.asarray([0.0, 0.03 * c, 0.0], jnp.float32)))
                  for c in range(C)]).astype(np.float32)
    t = np.stack([[-0.3 * c, 0.02 * c, 0.0] for c in range(C)]).astype(np.float32)
    p = np.einsum("cij,lj->cli", R, X) + t[:, None]
    uv = (p[..., :2] / p[..., 2:] + rng.normal(0, 2e-3, (C, L, 2))).astype(np.float32)
    mask = rng.random((C, L)) > 0.15
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    t0 = (t + rng.normal(0, 0.02, t.shape) * ~fixed[:, None]).astype(np.float32)
    return R, t0, X0, uv, mask, fixed


def test_torch_bundle_adjust_matches_jax():
    R, t0, X0, uv, mask, fixed = _ba_problem()
    jst, jstats = jax.jit(jba.bundle_adjust, static_argnames="iterations")(
        jba.BAState(*(jnp.asarray(a) for a in (R, t0, X0))),
        jba.BAProblem(jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(fixed), 4e-3),
        iterations=8,
    )
    tst, tstats = tba.bundle_adjust(
        tba.BAState(*(torch.from_numpy(a) for a in (R, t0, X0))),
        tba.BAProblem(torch.from_numpy(uv), torch.from_numpy(mask), torch.from_numpy(fixed), 4e-3),
        iterations=8,
    )
    c0, cj, ct = float(jstats.initial_cost), float(jstats.cost), float(tstats.cost)
    assert abs(float(tstats.initial_cost) - c0) <= 1e-5 * c0
    assert ct < 0.1 * c0
    assert abs(ct - cj) <= 1e-3 * cj
    np.testing.assert_allclose(tst.t.numpy(), np.asarray(jst.t), atol=1e-3)


def test_torch_refine_pose_matches_jax():
    R, t0, X0, uv, mask, _ = _ba_problem(seed=10, C=2, L=120)
    args = (X0, uv[1], mask[1], R[0], t0[0])
    jR, jt, jin = jax.jit(jba.refine_pose, static_argnames=("iterations", "huber_delta"))(
        *(jnp.asarray(a) for a in args), iterations=10, huber_delta=4e-3)
    tR, tt, tin = tba.refine_pose(*(torch.from_numpy(a) for a in args), iterations=10,
                                  huber_delta=4e-3)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert abs(int(tin.sum()) - int(jin.sum())) <= 1


def test_torch_pnp_dual_refine_matches_jax():
    """The dual-initialization select of vo_core (the host engine runs it
    with dual_init off; the reference's motion model turns it on)."""
    from cvsteer_tpu.slam import vo_core as jcore
    from cvsteer_tpu_torch.slam import vo_core as tcore

    R, t0, X0, uv, mask, _ = _ba_problem(seed=12, C=2, L=120)
    far_R = np.asarray(jse3.exp_so3(jnp.asarray([0.0, 1.2, 0.0], jnp.float32)))
    args = (X0, uv[1], mask[1], far_R, t0[0] + 3.0, R[0], t0[0])
    kw = dict(iterations=8, huber_delta=4e-3, min_track=500, dual_init=True)
    jR, jt, jn = jax.jit(jcore.pnp_dual_refine, static_argnames=tuple(kw))(
        *(jnp.asarray(a) for a in args), **kw)
    tR, tt, tn = tcore.pnp_dual_refine(*(torch.tensor(a) for a in args), **kw)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert abs(int(tn) - int(jn)) <= 1 and int(tn) > 60


def test_torch_camera_distortion_round_trip():
    K = Intrinsics(500.0, 500.0, 320.0, 240.0, dist=(0.1, -0.05, 0.001, -0.002, 0.01))
    yx = torch.tensor([[100.0, 200.0], [240.0, 320.0], [400.0, 600.0]])
    xy = normalize_pixels(yx, K)
    np.testing.assert_allclose(pixels_from_normalized(xy, K).numpy(), yx.numpy(), atol=1e-3)
    d = np.array([[0.1, -0.2], [0.3, 0.25]], np.float32)
    from cvsteer_tpu_torch.geometry.camera import undistort_normalized

    np.testing.assert_allclose(undistort_normalized_np(d, K.dist),
                               undistort_normalized(torch.from_numpy(d), K.dist).numpy(), atol=1e-6)


def test_torch_precise_turns_tf32_off_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with precise():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            with precise():
                pass
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before

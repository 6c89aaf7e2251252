"""The VO options the port's two engines now share, against the JAX device
engine, and ``cli_vo --engine device`` on real imagery, on CPU.

1. Flow-driven keyframing (``kf_min_flow_px``) on the 30-frame synthetic
   stream of tests/test_vo.py: the port's DeviceVO and its host engine each
   within ATE 0.01 m of the JAX DeviceVO, with the same keyframes.
2. The constant-velocity motion model. Its prediction (``_predict_pose``,
   shared by both engines) equals the reference's on the same carried
   states, the rotation and shift gates and the fallbacks included. Then
   the reference's own stream for the option
   (tests/test_vo_device.py::test_device_vo_motion_model_and_distortion: a
   Brown-Conrady lens, so the in-step undistortion runs too): both port
   engines take the JAX engine's keyframe decisions, and hold its poses
   (rotation 1e-5, translation 5e-4) on every frame before the first
   promotion after initialization; the port's two engines agree within ATE
   0.01 m over the whole stream. From that promotion on, a trajectory bar
   against the JAX engine does not hold under this option: the window BA
   of that promotion turns the packages' float32 differences of ~1e-4 m
   into ~0.2 m, and the motion model carries them on (the reference's own
   test measures its two engines' rounding growing ~2.5x per frame here
   and holds them only to an ATE envelope of 0.08 m). The test prints the
   figures. The dual-init pick itself is held on a carried map in
   tests/test_torch_vo_device.py::test_torch_vo_device_track_phase_matches_jax.
3. ``cli_vo --engine device --device cpu`` on the committed TUM fixture,
   within the derived ATE bound of tests/test_torch_vo.py.
"""

import pathlib
from types import SimpleNamespace

import numpy as np
import torch

import jax.numpy as jnp
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.features.frontend import Features as JFeatures
from cvsteer_tpu.geometry.camera import Intrinsics as JIntrinsics
from cvsteer_tpu.geometry.camera import pixels_from_normalized
from cvsteer_tpu.slam import vo_device as jvd
from cvsteer_tpu.slam import vo_core as jvo_core
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu.slam.vo import _predict_pose as jax_predict_pose
from cvsteer_tpu_torch.slam import vo as tvo
from cvsteer_tpu_torch.slam import vo_core as tvo_core
from cvsteer_tpu_torch.slam import vo_device as tvd
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import finalize, init_vo, process_frame
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "assets" / "tum_fixture"


def _three_engines(jcfg, frames):
    """(JAX DeviceVO, port DeviceVO, port host) final states on ``frames``."""
    jvo = jvd.DeviceVO(jcfg)
    for f in frames:
        jvo.process_frame(f)
    cfg = convert.vo_config(jcfg)
    dvo = tvd.DeviceVO(cfg, device="cpu")
    host = init_vo(cfg, device="cpu")
    for f in frames:
        dvo.process_frame(convert.features(f, device="cpu"))
        host = process_frame(host, convert.features(f, device="cpu"))
    return jvo.finalize(), dvo.finalize(), finalize(host)


def _kf(state):
    return [kf.index for kf in state.keyframes]


def test_torch_vo_flow_keyframing_matches_jax_engine():
    X, desc = ref._make_world()
    rng = np.random.default_rng(42)
    frames = [ref._render_features(X, desc, *ref._gt_pose(k, 30), rng) for k in range(30)]
    jcfg = JVOConfig(intrinsics=ref.K, kf_max_gap=5, window=8, track_min_landmarks=30,
                     kf_min_flow_px=20.0)
    jst, dst, hst = _three_engines(jcfg, frames)
    assert len(_kf(jst)) > 8  # the flow rule promotes more often than the gap of 5
    jR, jt = jst.poses()
    for name, st in (("device", dst), ("host", hst)):
        assert _kf(st) == _kf(jst), name
        ate = ate_rmse(*st.poses(), jR, jt)
        print(f"parity flow keyframing, port {name} vs JAX device: ATE {ate:.3e} m")
        assert ate < 0.01, f"{name}: {ate:.4f} m"


def _lens_frames(Kd, n_frames=24):
    """The stream of test_device_vo_motion_model_and_distortion."""
    X, desc = ref._make_world(seed=3)
    rng = np.random.default_rng(5)
    frames = []
    for k in range(n_frames):
        R, t = ref._gt_pose(k, n_frames)
        p = X @ R.T + t
        pix = np.asarray(pixels_from_normalized(jnp.asarray(p[:, :2] / p[:, 2:3]), Kd), np.float32)
        vis = ((p[:, 2] > 0.5) & (pix[:, 0] > 5) & (pix[:, 0] < 475)
               & (pix[:, 1] > 5) & (pix[:, 1] < 635))
        ids = np.nonzero(vis)[0][:ref.N_CAP]
        n = len(ids)
        yx = np.zeros((ref.N_CAP, 2), np.float32)
        dsc = np.zeros((ref.N_CAP, ref.DESC_DIM), np.float32)
        valid = np.zeros(ref.N_CAP, bool)
        yx[:n] = pix[ids] + rng.normal(0, 0.2, (n, 2))
        d = desc[ids] + rng.normal(0, 0.05, (n, ref.DESC_DIM))
        dsc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        valid[:n] = True
        frames.append(JFeatures(
            yx=jnp.asarray(yx), score=jnp.asarray(valid, jnp.float32),
            theta=jnp.zeros(ref.N_CAP), level=jnp.zeros(ref.N_CAP, jnp.int32),
            desc=jnp.asarray(dsc), valid=jnp.asarray(valid),
        ))
    return frames


def _rot(axis, deg):
    a = np.radians(deg)
    K = np.cross(np.eye(3), np.asarray(axis, np.float64) / np.linalg.norm(axis))
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def test_torch_vo_predict_pose_matches_jax():
    assert tvo_core.MAX_PRED_ROT_DEG == jvo_core.MAX_PRED_ROT_DEG
    assert tvo_core.MAX_PRED_SHIFT == jvo_core.MAX_PRED_SHIFT
    rng = np.random.default_rng(7)
    kf_R, kf_t = _rot(rng.normal(size=3), 20.0), rng.normal(size=3).astype(np.float32)
    R0, t0 = _rot(rng.normal(size=3), 40.0), rng.normal(size=3).astype(np.float32)

    def then(R_rel, t_rel):  # the pose after (R0, t0) under a per-frame motion
        return (R_rel @ R0).astype(np.float32), (R_rel @ t0 + t_rel).astype(np.float32)

    small = then(_rot([0.1, 1, 0.2], 2.0), np.float32([0.05, -0.01, 0.1]))
    cases = {  # name: (trajectory, whether the prediction is the keyframe pose)
        "one pose": ([(0, R0, t0)], True),
        "constant velocity": ([(0, R0, t0), (1, *small)], False),
        "non-finite": ([(0, R0, t0), (1, small[0], np.float32([np.nan, 0, 0]))], True),
        "rotation gate": ([(0, R0, t0), (1, *then(_rot([0, 1, 0], 31.0), np.zeros(3, np.float32)))],
                          True),
        "shift gate": ([(0, R0, t0), (1, *then(np.eye(3, dtype=np.float32),
                                               np.float32([10.5, 0, 0])))], True),
        "under both gates": ([(0, R0, t0), (1, *then(_rot([0, 1, 0], 29.0),
                                                     np.float32([9.5, 0, 0])))], False),
    }
    for name, (traj, is_kf) in cases.items():
        st = SimpleNamespace(keyframes=[SimpleNamespace(R=kf_R, t=kf_t)], trajectory=traj)
        jR, jt = jax_predict_pose(st)
        tR, tt = tvo._predict_pose(st)
        np.testing.assert_array_equal(tR, jR, err_msg=name)
        np.testing.assert_array_equal(tt, jt, err_msg=name)
        assert np.array_equal(tR, kf_R) == is_kf, name


def test_torch_vo_motion_model_matches_jax_engine():
    K = ref.K
    Kd = JIntrinsics(K.fx, K.fy, K.cx, K.cy, dist=(-0.28, 0.07, 0.0002, -0.0003, 0.02))
    jcfg = JVOConfig(intrinsics=Kd, kf_max_gap=5, window=8, track_min_landmarks=30,
                     motion_model=True, min_parallax=0.015)
    jst, dst, hst = _three_engines(jcfg, _lens_frames(Kd))
    assert dst.initialized and len(dst.trajectory) == 24
    assert _kf(dst) == _kf(jst)
    assert _kf(hst) == _kf(jst)
    # every frame before the first promotion after initialization (frames
    # 0 .. promo - 1) on the JAX engine's poses
    promo = _kf(jst)[2]
    assert promo >= 4  # the motion model predicts on at least two tracked frames
    for name, st in (("device", dst), ("host", hst)):
        dR = [np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()
              for a, b in zip(st.trajectory, jst.trajectory)]
        dt = [np.abs(np.asarray(a[2]) - np.asarray(b[2])).max()
              for a, b in zip(st.trajectory, jst.trajectory)]
        print(f"parity motion model, port {name} vs JAX device: frames 0-{promo - 1} "
              f"R {max(dR[:promo]):.1e}, t {max(dt[:promo]):.1e} m; at the promotion of "
              f"frame {promo} t {dt[promo]:.1e} m; ATE over the stream "
              f"{ate_rmse(*st.poses(), *jst.poses()):.3e} m (not held)")
        assert max(dR[:promo]) < 1e-5, name
        assert max(dt[:promo]) < 5e-4, name
    twin = ate_rmse(*dst.poses(), *hst.poses())
    print(f"parity motion model: port device vs port host ATE {twin:.3e} m")
    assert twin < 0.01, f"{twin:.4f} m"


def test_torch_cli_vo_device_engine_on_real_image_fixture(tmp_path):
    from cvsteer_tpu_torch.cli_vo import main
    from cvsteer_tpu_torch.io.datasets import open_sequence
    from cvsteer_tpu_torch.slam.evaluate import camera_centers

    out = tmp_path / "traj.txt"
    rc = main([
        "--input", str(FIXTURE),
        "--set", "camera.fx=300", "camera.fy=300", "camera.cx=160",
        "camera.cy=120", "slam.min_parallax=0.005", "slam.kf_max_gap=2",
        "slam.window=6",
        "--output", str(out), "--engine", "device", "--device", "cpu",
    ])
    assert rc == 0
    vals = np.array([[float(x) for x in l.split()] for l in out.read_text().splitlines() if l.strip()])
    assert vals.shape == (32, 8) and np.isfinite(vals).all()  # one TUM pose per frame

    seq = open_sequence(str(FIXTURE))
    est_R, est_t = [], []
    for row in vals:
        x, y, z, w = row[4:8]
        Rwc = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        est_R.append(Rwc.T)
        est_t.append(-Rwc.T @ row[1:4])
    ate = ate_rmse(np.stack(est_R), np.stack(est_t), seq.gt_R, seq.gt_t)
    # the derived bound of tests/test_torch_vo.py (and tests/test_cli_vo.py)
    sigma_px, f_px, Z, N_lm, kf_gap = 1.0, 300.0, 4.0, 100.0, 2
    centers = camera_centers(seq.gt_R, seq.gt_t)
    B_kf = float(np.median(np.linalg.norm(np.diff(centers, axis=0), axis=1)) * kf_gap)
    hops = (len(vals) - 1) / kf_gap
    bound = 3.0 * np.sqrt(hops) * sigma_px / f_px * Z**2 / (B_kf * np.sqrt(N_lm))
    print(f"parity cli_vo --engine device: ATE {ate:.4f} m, bound {bound:.4f} m")
    assert ate < bound, f"ATE {ate:.3f} m exceeds the derived bound {bound:.3f} m"

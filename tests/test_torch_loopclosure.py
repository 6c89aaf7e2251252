"""The port's loop closure, two-view geometry, closure and ground rules and
the scale priors (cvsteer_tpu_torch.slam.{twoview, vo_core, loopclosure,
vo, vo_device}) against the JAX package's, on CPU.

1. two_view_pose_from_features on tests/test_twoview.py's images (the same
   features, the reference's RANSAC draws injected): the same inlier set
   within 2 %, R and the t direction within 1e-3 rad.
2. vo_core's ground_height_obs, signature_device and closure_candidates
   (candidates as sets: topk orders ties otherwise); the ground controller
   against the reference's; apply_speed_prior and apply_ground_prior and
   the ground-law helpers on carried states: the same decisions, values
   within 1e-5; the ground prior through both host engines on
   tests/test_vo.py's synthetic stream.
3. find_loop_closures, close_loops and close_loops_sim3 on
   tests/test_loopclosure.py's loop_world states carried across by
   utils/convert.vo_state: the same pairs and the same number of accepted
   closures, keyframe poses within 1e-3 m.
4. Both port engines on the stream of
   tests/test_loopclosure.py::test_device_vo_sim3_closure_end_to_end_scale_drift:
   the reference test's assertions (>= 1 closure, the keyframe ATE halves,
   Sim(3) beats SE(3)); the JAX host engine's ATE on the same drifted
   state is printed beside them. Then cli_vo on the TUM fixture with the
   four options, both engines, on the CPU.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_loopclosure as rlc  # the reference tests' loop world
import test_twoview as rtv
import test_vo as rvo
from cvsteer_tpu.features.frontend import Features as JFeatures
from cvsteer_tpu.features.matching import match_descriptors as jmatch
from cvsteer_tpu.geometry import epipolar as jep
from cvsteer_tpu.slam import loopclosure as jlc
from cvsteer_tpu.slam import vo as jvo
from cvsteer_tpu.slam import vo_core as jcore
from cvsteer_tpu.slam.twoview import two_view_pose_from_features as jtwo_view
from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features
from cvsteer_tpu_torch.slam import loopclosure as tlc
from cvsteer_tpu_torch.slam import se3
from cvsteer_tpu_torch.slam import vo as tvo
from cvsteer_tpu_torch.slam import vo_core as tcore
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.twoview import two_view_pose as ttwo_view_pose
from cvsteer_tpu_torch.slam.twoview import two_view_pose_from_features as ttwo_view
from cvsteer_tpu_torch.slam.vo_device import DeviceVO
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

TOL = 1e-5
TOL_POSE = 1e-3  # m
TOL_ROT = 1e-3  # rad


def _jfeatures(f):
    """The port's Features as the reference's (numpy -> jnp)."""
    return JFeatures(*(jnp.asarray(a.numpy()) for a in f))


def test_torch_two_view_pose_matches_jax():
    rng = np.random.default_rng(5)
    n_pts = 120
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n_pts, 3)).astype(np.float32)
    attrs = np.stack([rng.uniform(0.5, 1.0, n_pts), rng.uniform(0, np.pi, n_pts),
                      rng.uniform(2.0, 3.2, n_pts), rng.uniform(0.8, 1.2, n_pts)], 1)
    Rb_wc = se3.exp_so3(torch.tensor([0.0, 0.06, 0.0])).numpy()
    cb = np.array([0.8, 0.05, 0.1], np.float32)
    Rb = Rb_wc.T.astype(np.float32)
    tb = (-Rb @ cb).astype(np.float32)
    cfg = FrontendConfig(levels=2, keypoints_per_level=192, threshold=0.5)
    fa, fb = (extract_features(torch.from_numpy(rtv._render(X, attrs, R, t)), cfg=cfg)
              for R, t in ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), (Rb, tb)))
    K = convert.intrinsics(rtv.K)
    key = jax.random.key(0)
    jfa, jfb = _jfeatures(fa), _jfeatures(fb)
    ref = jtwo_view(jfa, jfb, rtv.K, key=key)
    m = jmatch(jfa.desc, jfa.valid, jfb.desc, jfb.valid, ratio=0.85)
    sets = np.asarray(jep._sample_minimal_sets(key, m.valid, 512, 8))
    got = ttwo_view(fa, fb, K, sets=torch.from_numpy(sets))
    whole = ttwo_view_pose(*(torch.from_numpy(rtv._render(X, attrs, R, t)) for R, t in
                             ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), (Rb, tb))),
                           K, cfg=cfg, sets=torch.from_numpy(sets))
    assert torch.equal(whole.R, got.R) and torch.equal(whole.point_valid, got.point_valid)
    inl_r, inl_t = np.asarray(ref.point_valid), got.point_valid.numpy()
    differ = int((inl_r != inl_t).sum())
    rot = float(np.abs(got.R.numpy() - np.asarray(ref.R)).max())  # ~ the angle apart
    tdir = float(np.arccos(np.clip(abs(np.dot(got.t.numpy(), np.asarray(ref.t))), -1, 1)))
    print(f"parity two_view_pose_from_features: inliers {int(got.num_inliers)} / jax "
          f"{int(ref.num_inliers)}, {differ} differ (bar 2 %); R {rot:.2e} rad, t direction "
          f"{tdir:.2e} rad apart (bar {TOL_ROT})")
    assert int(ref.num_inliers) >= 15
    assert differ <= 0.02 * max(inl_r.sum(), 1)
    assert rot < TOL_ROT and tdir < TOL_ROT
    # and the pose is the scene's (tests/test_twoview.py's bars)
    assert float(se3.rotation_geodesic(got.R, torch.from_numpy(Rb))) < 0.02
    assert abs(float(np.dot(got.t.numpy(), tb / np.linalg.norm(tb)))) > 0.99


def test_torch_closure_and_ground_rules_match_jax():
    """ground_height_obs on tests/test_vo.py's ground + wall cloud (and a
    wall-only one), signature_device, closure_candidates as sets, and the
    tensor ground controller against the reference's over a sweep."""
    rng = np.random.default_rng(3)
    n_g, n_w = 50, 90
    ground = np.stack([rng.uniform(-3, 3, n_g), 1.5 + rng.normal(0, 0.03, n_g),
                       rng.uniform(4, 16, n_g)], 1)
    walls = np.stack([rng.uniform(-4, 4, n_w), rng.uniform(0.1, 1.2, n_w),
                      rng.uniform(2, 10, n_w)], 1)
    R = torch.eye(3)
    for pts in (np.concatenate([ground, walls]), walls[:12]):
        X = pts.astype(np.float32)
        v = (120.0 + 300.0 * X[:, 1] / X[:, 2]).astype(np.float32)
        use = rng.random(len(X)) > 0.1
        t = np.array([0.1, -0.05, 0.2], np.float32)
        ref = float(jcore.ground_height_obs(jnp.asarray(X), jnp.asarray(use), jnp.asarray(v),
                                            jnp.eye(3), jnp.asarray(t), 120.0))
        got = float(tcore.ground_height_obs(torch.from_numpy(X), torch.from_numpy(use),
                                            torch.from_numpy(v), R, torch.from_numpy(t), 120.0))
        assert got == pytest.approx(ref, abs=TOL)
    desc = rng.normal(size=(64, 32)).astype(np.float32)
    valid = rng.random(64) > 0.3
    sig_r = np.asarray(jcore.signature_device(jnp.asarray(desc), jnp.asarray(valid)))
    sig_t = tcore.signature_device(torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(sig_t, sig_r, atol=TOL)
    sigs = rng.normal(size=(40, 32)).astype(np.float32)
    sigs[7] = sigs[3]  # a tie
    for j, top in ((30, 3), (12, 5), (5, 3)):
        ri, rs = jcore.closure_candidates(jnp.asarray(sigs), jnp.asarray(sig_r), j, min_gap=6, top=top)
        ti, ts = tcore.closure_candidates(torch.from_numpy(sigs), torch.from_numpy(sig_t), j,
                                          min_gap=6, top=top)
        fin = np.isfinite(np.asarray(rs))
        assert set(np.asarray(ri)[fin]) == set(ti.numpy()[np.isfinite(ts.numpy())])
        np.testing.assert_allclose(np.sort(ts.numpy()), np.sort(np.asarray(rs)), atol=TOL)
    hist, jhist = torch.zeros(3), jnp.zeros(3)
    for h in [0.0, 1.2, 1.3, 1.9, 0.0, 1.6, 1.52, 1.49, 3.0, 1.0]:
        hist, r = tcore.ground_controller(torch.tensor(h), torch.tensor(h > 0), hist, target=1.5)
        jhist, jr = jcore.ground_controller(jnp.float32(h), jnp.asarray(h > 0), jhist, target=1.5)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), atol=TOL)
        assert float(r) == pytest.approx(float(jr), abs=TOL)


def _host_pair(make):
    """A reference state from ``make`` and its port twin."""
    ref = make()
    return ref, convert.vo_state(ref, "cpu")


@pytest.mark.parametrize("b,fresh", [(0.3, False), (0.9, True), (0.05, True)])
def test_torch_apply_speed_prior_matches_jax(b, fresh):
    """tests/test_vo.py's speed-prior states: in band, runaway, collapse."""
    ref, port = _host_pair(lambda: rvo._two_kf_state(b=b, gap=3))
    for st in (ref, port):
        st.landmarks[5] = np.array([2.0, 0.0, 5.0], np.float32)
        st.landmark_valid[5] = True
    fid = np.array([5], np.int64) if fresh else None
    assert tvo.apply_speed_prior(port, fresh_ids=fid) == jvo.apply_speed_prior(ref, fresh_ids=fid)
    np.testing.assert_allclose(port.keyframes[-1].t, ref.keyframes[-1].t, atol=TOL)
    np.testing.assert_allclose(port.landmarks[5], ref.landmarks[5], atol=TOL)
    assert port.kf_baselines[-1] == pytest.approx(ref.kf_baselines[-1], abs=TOL)


def _ground_state(mod):
    """tests/test_vo.py::test_ground_prior_rescales_window_not_history's
    five keyframes on a line, window 3, one live landmark."""
    cfg = mod.VOConfig(intrinsics=rvo.K, window=3, ground_height_m=1.5)
    st = mod.init_vo(cfg)
    Re = np.eye(3, dtype=np.float32)
    for i, x in enumerate([0.0, 1.0, 2.0, 3.0, 4.0]):
        c = np.array([x, 0.0, 0.0], np.float32)
        st.keyframes.append(mod.Keyframe(i, None, Re.copy(), (-Re @ c).astype(np.float32),
                                         np.full(4, -1, np.int64)))
    st.frame_count = 5
    st.trajectory.append((4, Re.copy(), st.keyframes[-1].t.copy()))
    st.landmarks[0] = np.array([5.0, 1.0, 10.0], np.float32)
    st.landmark_valid[0] = True
    return st


def test_torch_apply_ground_prior_matches_jax():
    ref, port = _host_pair(lambda: _ground_state(jvo))
    for h in [1.65, 1.5, 1.1, 2.6, 0.0, 1.51, 1.3]:
        assert tvo.ground_violation(port.config, h) == jvo.ground_violation(ref.config, h)
        assert tvo.apply_ground_prior(port, h) == jvo.apply_ground_prior(ref, h)
        for kt, kr in zip(port.keyframes, ref.keyframes):
            np.testing.assert_allclose(kt.t, kr.t, atol=TOL)
        np.testing.assert_allclose(port.landmarks[0], ref.landmarks[0], atol=TOL)
    assert port.ground_hist == pytest.approx(ref.ground_hist)


def test_torch_host_engine_ground_prior_matches_jax():
    """The ground prior through both host engines on tests/test_vo.py's
    30-frame synthetic stream: the bootstrap's ground gauge, the in-step
    height observation and the corrections (the same frames, ratios within
    1e-4), and every pose within 1e-3 m."""
    X, desc = rvo._make_world()
    rng = np.random.default_rng(42)
    frames = [rvo._render_features(X, desc, *rvo._gt_pose(k, 30), rng) for k in range(30)]
    jcfg = jvo.VOConfig(intrinsics=rvo.K, kf_max_gap=5, window=8, track_min_landmarks=30,
                        ground_height_m=1.5)
    js, ts = jvo.init_vo(jcfg), tvo.init_vo(convert.vo_config(jcfg), device="cpu")
    js.diag, ts.diag = [], []
    for f in frames:
        jvo.process_frame(js, f)
        tvo.process_frame(ts, convert.features(f, "cpu"))

    def events(st, ev, key):
        return [(e["f"], e[key]) for e in st.diag if e["ev"] == ev]

    (jf, jscale), = events(js, "init", "scale")
    (tf, tscale), = events(ts, "init", "scale")
    jg, tg = events(js, "ground", "r"), events(ts, "ground", "r")
    centers = [np.abs(-R.T @ t + Rj.T @ tj).max()
               for (_, R, t), (_, Rj, tj) in zip(ts.trajectory, js.trajectory)]
    print(f"parity ground prior, host engines: init scale {tscale:.6f} / jax {jscale:.6f}; "
          f"{len(tg)} corrections / jax {len(jg)}; poses within {max(centers):.2e} m (bar 1e-3)")
    assert tf == jf and tscale == pytest.approx(jscale, rel=1e-4) and jscale != 1.0
    assert [f for f, _ in tg] == [f for f, _ in jg] and jg
    np.testing.assert_allclose([r for _, r in tg], [r for _, r in jg], atol=1e-4)
    assert max(centers) < 1e-3


# ---------------------------------------------------------------------------
# loop closure on tests/test_loopclosure.py's loop world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(9)  # test_loopclosure.loop_world
    X = rng.uniform([-2, -1.5, -2], [2, 1.5, 2], (300, 3)).astype(np.float32)
    desc = rng.normal(size=(300, rvo.DESC_DIM)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return X, desc


def _drifted_revisit(world):
    """test_close_loops_corrects_drift's 13-keyframe revisit with SE(3)
    drift, as a reference state."""
    X, desc = world
    rng = np.random.default_rng(3)
    poses = rlc._circle_poses(12)
    poses.append(poses[0])
    drifted = []
    for n, (R, t) in enumerate(poses):
        s = n / len(poses)
        xi = np.concatenate([0.06 * s * np.ones(3) * [1, -1, 0.5], 0.4 * s * np.array([1, 0.3, -0.5])])
        dR, dt = rlc.se3.exp_se3(jnp.asarray(xi, jnp.float32))
        Rn, tn = rlc.se3.compose(dR, dt, jnp.asarray(R), jnp.asarray(t))
        drifted.append((np.asarray(Rn), np.asarray(tn)))
    return rlc._state_with_keyframes(poses, X, desc, rng, drift=drifted)


def _kf_pose_gap(a, b):
    return max(float(np.abs((-ka.R.T @ ka.t) - (-kb.R.T @ kb.t)).max())
               for ka, kb in zip(a.keyframes, b.keyframes))


def test_torch_find_and_close_loops_match_jax(world):
    ref, port = _host_pair(lambda: _drifted_revisit(world))
    pairs_r = {(c.i, c.j) for c in jlc.find_loop_closures(ref, min_gap=6, min_inliers=20)}
    pairs_t = {(c.i, c.j) for c in tlc.find_loop_closures(port, min_gap=6, min_inliers=20)}
    assert pairs_r and pairs_t == pairs_r
    ref.loop_streak, port.loop_streak = (-1, 0), (-1, 0)
    n_r = jlc.close_loops(ref, min_gap=6, min_inliers=20)
    n_t = tlc.close_loops(port, min_gap=6, min_inliers=20)
    gap = _kf_pose_gap(port, ref)
    print(f"parity close_loops: accepted {n_t} / jax {n_r}; keyframe centers {gap:.2e} m apart "
          f"(bar {TOL_POSE}); pairs {sorted(pairs_t)}")
    assert n_t == n_r >= 1
    assert gap < TOL_POSE


def _landmark_revisit(world, rate=0.06):
    """A 13-keyframe revisit whose keyframes carry landmark links (each
    feature's world point: the map), with injected scale drift
    (test_loopclosure._inject_scale_drift), as a reference state."""
    X, desc = world
    rng = np.random.default_rng(21)
    poses = rlc._circle_poses(12)
    poses.append(poses[0])
    st = rlc._state_with_keyframes(poses, X, desc, rng)
    for kf, (R, t) in zip(st.keyframes, poses):
        # the feature rows' world points: the nearest projection of a point
        p = X @ R.T + t
        uv = p[:, :2] / p[:, 2:3]
        pix = np.stack([uv[:, 1] * 500 + 240, uv[:, 0] * 500 + 320], -1)
        yx = np.asarray(kf.features.yx)
        d = np.linalg.norm(yx[:, None] - pix[None], axis=-1)
        ids = np.where(np.asarray(kf.features.valid) & (d.min(1) < 1.0), d.argmin(1), -1)
        kf.landmark_ids = ids.astype(np.int64)
    st.landmarks[: len(X)] = X
    st.landmark_valid[: len(X)] = True
    st.num_landmarks = len(X)
    rlc._inject_scale_drift(st, rate)
    return st


def test_torch_close_loops_sim3_matches_jax(world):
    ref, port = _host_pair(lambda: _landmark_revisit(world))
    n_r = jlc.close_loops_sim3(ref, min_gap=6, min_inliers=20)
    n_t = tlc.close_loops_sim3(port, min_gap=6, min_inliers=20)
    gap = _kf_pose_gap(port, ref)
    lm = float(np.abs(port.landmarks[:300] - ref.landmarks[:300]).max())
    print(f"parity close_loops_sim3: accepted {n_t} / jax {n_r}; keyframe centers {gap:.2e} m, "
          f"landmarks {lm:.2e} m apart (bar {TOL_POSE})")
    assert n_t == n_r >= 1
    assert gap < TOL_POSE


# ---------------------------------------------------------------------------
# both port engines on the reference's end-to-end scale-drift stream
# ---------------------------------------------------------------------------


def _kf_ate(st, gt):
    kfs = st.keyframes
    n = len(gt)
    return ate_rmse(np.stack([kf.R for kf in kfs]), np.stack([kf.t for kf in kfs]),
                    np.stack([gt[min(kf.index, n - 1)][0] for kf in kfs]),
                    np.stack([gt[min(kf.index, n - 1)][1] for kf in kfs]))


def _to_jax_state(st):
    """The port's VOState as the reference's (features as jnp arrays), for
    the reference engine to continue from the same drifted state."""
    ref = jvo.init_vo(jvo.VOConfig(**{**st.config._asdict(), "intrinsics": rvo.K,
                                      "frontend": jvo.FrontendConfig()}))
    for f in ("landmarks", "landmark_valid", "num_landmarks", "trajectory", "traj_ref",
              "initialized", "frame_count", "track_version", "lost_streak", "kf_baselines"):
        setattr(ref, f, copy.deepcopy(getattr(st, f)))
    ref.keyframes = [jvo.Keyframe(kf.index, _jfeatures(kf.features), kf.R.copy(), kf.t.copy(),
                                  kf.landmark_ids.copy(), fresh_ids=kf.fresh_ids)
                     for kf in st.keyframes]
    return ref


@pytest.mark.parametrize("engine", ["device", "host"])
def test_torch_engines_sim3_closure_end_to_end_scale_drift(world, engine):
    X, desc = world
    rng = np.random.default_rng(11)
    n_frames = 48
    gt = []
    for k in range(n_frames):
        a = 2 * np.pi * (k / (n_frames - 1))
        gt.append(rlc._lookat_pose(np.array([7.0 * np.sin(a), 0.0, -7.0 * np.cos(a)])))
    frames = [convert.features(rvo._render_features(X, desc, R, t, rng, pix_noise=0.1), "cpu")
              for R, t in gt]
    cfg = tvo.VOConfig(intrinsics=convert.intrinsics(rvo.K), kf_max_gap=4, window=6,
                       track_min_landmarks=40, min_parallax=0.01)
    if engine == "device":
        vo = DeviceVO(cfg, device="cpu")
        for k in range(40):
            vo.process_frame(frames[k])
        st = vo.sync_host()
    else:
        st = tvo.init_vo(cfg, device="cpu")
        for k in range(40):
            tvo.process_frame(st, frames[k])
    assert st.initialized and len(st.keyframes) >= 10
    assert rlc._inject_scale_drift(st, rate=0.07) > 1.8
    before = _kf_ate(st, gt)
    st_se3 = copy.deepcopy(st)
    cfg2 = cfg._replace(loop_closure=True, loop_closure_sim3=True, loop_min_gap=6,
                        loop_min_inliers=20)
    st.config = cfg2
    st.diag = []
    jst = _to_jax_state(st)
    if engine == "device":
        vo2 = DeviceVO(cfg2, device="cpu")
        vo2.adopt(st)
        for k in range(40, n_frames):
            vo2.process_frame(frames[k])
        final = vo2.sync_host()
    else:
        final = st
        for k in range(40, n_frames):
            tvo.process_frame(final, frames[k])
    accepted = sum(e["accepted"] for e in final.diag if e["ev"] == "closure")
    ate_sim3 = _kf_ate(final, gt)
    n_se3 = tlc.close_loops(st_se3, min_gap=6, min_inliers=20)
    ate_se3 = _kf_ate(st_se3, gt) if n_se3 else before
    line = (f"parity {engine} engine, Sim(3) closure on scale drift: {accepted} accepted, "
            f"keyframe ATE {before:.4f} -> {ate_sim3:.4f} m; SE(3) {ate_se3:.4f} m")
    for k in range(40, n_frames):  # the JAX host engine from the same drifted state
        jvo.process_frame(jst, _jfeatures(frames[k]))
    line += f"; the JAX host engine from the same state {_kf_ate(jst, gt):.4f} m"
    print(line)
    assert accepted >= 1
    assert ate_sim3 < 0.5 * before
    assert ate_sim3 < ate_se3
    if engine == "device":  # it goes on tracking after the upload
        vo2.process_frame(frames[-1])
        assert np.isfinite(vo2.finalize().poses()[1]).all()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_torch_cli_vo_with_loop_closure_and_priors(tmp_path, engine):
    """cli_vo with the campaign's closure and prior options on the TUM
    fixture, on the CPU: a pose per frame and a finite trajectory."""
    from cvsteer_tpu_torch.cli_vo import main

    out = tmp_path / "traj.txt"
    rc = main([
        "--input", str(rvo.__file__).replace("test_vo.py", "assets/tum_fixture"),
        "--engine", engine, "--device", "cpu", "--max-frames", "12", "--output", str(out),
        "--set", "camera.fx=300", "camera.fy=300", "camera.cx=160", "camera.cy=120",
        "slam.loop_closure=true", "slam.loop_closure_sim3=true", "slam.loop_min_gap=2",
        "slam.ground_height_m=1.5", "slam.speed_prior_lo=0.5", "slam.speed_prior_hi=2.0",
    ])
    assert rc == 0
    rows = [r for r in out.read_text().splitlines() if r and not r.startswith("#")]
    assert len(rows) == 12
    assert np.isfinite(np.array([[float(v) for v in r.split()] for r in rows])).all()

"""The port's device-resident VO engine (cvsteer_tpu_torch.slam.vo_device)
against the JAX package's (cvsteer_tpu.slam.vo_device), on CPU.

1. Its functions on a small map (W = 4, N = 48, Lmax = 128, made with
   np.random.default_rng and carried into both packages by
   utils.convert.device_map): ``_free_slots`` exactly; ``_track_phase`` in
   the classic and the ``local_map`` modes, and under the motion model
   (dual-init PnP) from the reference's constant-velocity prediction and
   from a prediction bad enough that the keyframe start must win (idx,
   obs_pre and promote equal, R and t within 1e-4, the inlier count within
   1); ``_window_ba`` and
   ``_promote`` (lm_valid, kf_obs and lm_gen equal except for columns
   within 1e-4 of the cull bar, which are left out and counted; X, kf_R and
   kf_t within 1e-3, the bar of test_torch_bundle_adjust_matches_jax).
2. The slice: the 30-frame synthetic stream of tests/test_vo.py through the
   port's DeviceVO, eagerly on the CPU: the bars of tests/test_vo_device.py
   (initialized, >= 3 keyframes, > 100 landmarks, 30 poses, ATE < 0.05,
   synced landmarks inside the scene), ATE < 0.01 against the JAX engine and
   against the port's host twin, the keyframe count within 1 of the JAX
   engine's, and the blackout recovery case.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.features.frontend import Features as JFeatures
from cvsteer_tpu.geometry.camera import Intrinsics as JIntrinsics
from cvsteer_tpu.slam import vo_device as jvd
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu.slam.vo import _predict_pose as jax_predict_pose
from cvsteer_tpu_torch.slam import vo_core
from cvsteer_tpu_torch.slam import vo_device as tvd
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import VOConfig, finalize, init_vo, process_frame
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

W, N, LMAX, D = 4, 48, 128, 16
FX, CX, CY = 500.0, 320.0, 240.0
TRACK = dict(ratio=0.85, track_iters=10, huber_delta=4e-3, min_track=30, dual_init=False,
             rescue_radius=12.0 / FX, rescue_min_cos=0.6, kf_min_flow=0.02)
BA = dict(iterations=12, huber_delta=4e-3)
CULL_BAR = vo_core.cull_bar(BA["huber_delta"])


def _pose(k):
    """world->camera pose of view k: sideways + forward with a slow yaw."""
    a = 0.03 * k
    Rwc = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    c = np.array([0.35 * k, 0.02 * k, 0.1 * k], np.float32)
    return Rwc.T, (-Rwc.T @ c).astype(np.float32)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _small_map(seed=0):
    """(reference DeviceMap as numpy, the new frame's features, the world).

    Ring slot 0 is padding; views 1-3 are live keyframes at _pose(1..3),
    each observing all 34 landmarks (in its own feature order); the frame
    to track sits at _pose(4). The landmarks live in random store slots
    beside 90 valid slots no keyframe observes, so a promotion that wants
    more than the 3 free slots evicts, and one landmark whose two
    observations disagree (the culled one). The newest keyframe also has 8
    features with no landmark that the new frame sees too (triangulation
    candidates)."""
    rng = np.random.default_rng(seed)
    n_lm, n_junk = 34, 90
    Xw = rng.uniform([-2.0, -1.5, 4.0], [3.0, 1.5, 8.0], (n_lm + 12, 3)).astype(np.float32)
    dsc = _unit(rng.normal(size=(n_lm + 12, D)))
    slots = rng.permutation(LMAX)
    lm_slot, junk, bogus = slots[:n_lm], slots[n_lm:n_lm + n_junk], int(slots[n_lm + n_junk])

    def project(k, pts):
        R, t = _pose(k)
        p = pts @ R.T + t
        return p[:, :2] / p[:, 2:3]

    X = np.zeros((LMAX, 3), np.float32)
    X[lm_slot] = Xw[:n_lm] + rng.normal(0, 0.03, (n_lm, 3))
    X[junk] = rng.uniform(-5, 5, (n_junk, 3))
    X[bogus] = [0.0, 0.0, 6.0]
    lm_valid = np.zeros(LMAX, bool)
    lm_valid[np.r_[lm_slot, junk, bogus]] = True
    lm_desc = _unit(rng.normal(size=(LMAX, D)))
    lm_desc[lm_slot] = dsc[:n_lm]
    kf_uv = np.zeros((W, N, 2), np.float32)
    kf_fvalid = np.zeros((W, N), bool)
    kf_obs = np.full((W, N), -1, np.int32)
    kf_R = np.broadcast_to(np.eye(3, dtype=np.float32), (W, 3, 3)).copy()
    kf_t = np.zeros((W, 3), np.float32)
    kf_live = np.array([False, True, True, True])
    for w in (1, 2, 3):
        kf_R[w], kf_t[w] = _pose(w)
        seen = rng.permutation(n_lm)
        kf_uv[w, :n_lm] = project(w, Xw[seen]) + rng.normal(0, 0.2 / FX, (n_lm, 2))
        kf_obs[w, :n_lm] = lm_slot[seen]
        kf_fvalid[w, :46] = True
        kf_uv[w, n_lm:] = rng.uniform(-0.5, 0.5, (N - n_lm, 2))
        kf_uv[w, 36] = [0.3 - 0.5 * (w - 2), -0.2 + 0.4 * (w - 2)]
        kf_obs[w, 36] = bogus if w >= 2 else -1
    # the newest keyframe's unmapped candidates, seen again by the new frame
    kf_uv[3, 38:46] = project(3, Xw[n_lm:n_lm + 8])
    kf_desc = _unit(rng.normal(size=(N, D)))
    inv = {int(s): i for i, s in enumerate(lm_slot)}
    kf_desc[:n_lm] = dsc[[inv[int(s)] for s in kf_obs[3, :n_lm]]]
    kf_desc[38:46] = dsc[n_lm:n_lm + 8]
    m = jvd.DeviceMap(
        X=X, lm_valid=lm_valid, lm_gen=rng.integers(0, 3, LMAX).astype(np.int32),
        kf_uv=kf_uv, kf_fvalid=kf_fvalid, kf_obs=kf_obs, kf_R=kf_R, kf_t=kf_t,
        kf_live=kf_live, kf_desc=kf_desc, lm_desc=lm_desc, since_kf=np.int32(1),
    )

    # the new frame: the landmarks and the candidates in a shuffled order,
    # plus unseen points
    ids = rng.permutation(n_lm + 12)
    uv = project(4, Xw[ids])
    yx = np.zeros((N, 2), np.float32)
    yx[:ids.size] = np.stack([uv[:, 1] * FX + CY, uv[:, 0] * FX + CX], -1) + rng.normal(0, 0.2, (ids.size, 2))
    desc = np.zeros((N, D), np.float32)
    desc[:ids.size] = _unit(dsc[ids] + rng.normal(0, 0.05, (ids.size, D)))
    valid = np.zeros(N, bool)
    valid[:ids.size] = True
    return m, (yx, desc, valid), _pose(3)


def _jax_map(m):
    return jvd.DeviceMap(**{f: None if getattr(m, f) is None else jnp.asarray(getattr(m, f))
                            for f in jvd.DeviceMap._fields})


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def test_torch_vo_device_free_slots_exact():
    rng = np.random.default_rng(4)
    for lm_valid in ([True, False, True, False, False, True, False, True], rng.random(LMAX) < 0.6,
                     np.ones(LMAX, bool), np.zeros(LMAX, bool)):
        lm_valid = np.asarray(lm_valid)
        jf, jn = jvd._free_slots(jnp.asarray(lm_valid))
        tf, tn = tvd._free_slots(torch.from_numpy(lm_valid))
        np.testing.assert_array_equal(_np(tf), np.asarray(jf))
        assert int(tn) == int(jn)


def _yaw(R, deg):
    a = np.radians(deg)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    return (Ry @ R).astype(np.float32)


def _mode(mode):
    """(Rp, tp, keyword arguments) of a tracking mode on the small map: the
    classic and local_map modes start PnP at the keyframe's pose (view 3);
    the motion model starts from the reference's constant-velocity
    prediction from views 2 and 3 ("motion_model"), or from a prediction
    turned 90 degrees ("bad_prediction"), where the keyframe start must win
    the dual-init pick ("bad_prediction_alone": the same without the
    second start)."""
    R3, t3 = _pose(3)
    if mode in ("classic", "local_map"):
        return R3, t3, dict(TRACK, local_map=mode == "local_map")
    if mode == "motion_model":
        st = SimpleNamespace(keyframes=[SimpleNamespace(R=R3, t=t3)],
                             trajectory=[(2, *_pose(2)), (3, R3, t3)])
        Rp, tp = jax_predict_pose(st)
        assert not np.array_equal(Rp, R3)  # a real prediction, not the keyframe pose
    else:
        Rp, tp = _yaw(R3, 90.0), t3
    return Rp, tp, dict(TRACK, dual_init=mode == "bad_prediction")


@functools.lru_cache(maxsize=None)
def _jax_track(mode):
    m, (yx, desc, valid), _ = _small_map()
    Rp, tp, kw = _mode(mode)
    K = JIntrinsics(FX, FX, CX, CY)
    step = jax.jit(lambda *a: jvd._track_phase(*a, K=K, **kw))
    return step(
        _jax_map(m), jnp.asarray(yx), jnp.asarray(desc), jnp.asarray(valid),
        jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(False),
    )


def _track_both(mode):
    m, (yx, desc, valid), _ = _small_map()
    Rp, tp, kw = _mode(mode)
    tt = tvd._track_phase(
        convert.device_map(m, device="cpu"), torch.from_numpy(yx), torch.from_numpy(desc),
        torch.from_numpy(valid), torch.from_numpy(Rp), torch.from_numpy(tp), torch.tensor(False),
        K=convert.intrinsics(JIntrinsics(FX, FX, CX, CY)), **kw,
    )
    return _jax_track(mode), tt


@pytest.mark.parametrize("mode", ["classic", "local_map", "motion_model", "bad_prediction"])
def test_torch_vo_device_track_phase_matches_jax(mode):
    jt, tt = _track_both(mode)
    assert int(jt.n) >= 20  # the small map does track
    np.testing.assert_array_equal(_np(tt.idx), np.asarray(jt.idx))
    np.testing.assert_array_equal(_np(tt.obs_pre), np.asarray(jt.obs_pre))
    assert bool(tt.promote) == bool(jt.promote)
    assert bool(tt.lost) == bool(jt.lost)
    assert int(tt.n_valid) == int(jt.n_valid)
    assert abs(int(tt.n) - int(jt.n)) <= 1
    np.testing.assert_allclose(_np(tt.R), np.asarray(jt.R), atol=1e-4)
    np.testing.assert_allclose(_np(tt.t), np.asarray(jt.t), atol=1e-4)
    np.testing.assert_allclose(_np(tt.uv_new), np.asarray(jt.uv_new), atol=1e-6)
    if mode == "bad_prediction":  # the prediction alone loses track; both fall back
        assert int(_jax_track("bad_prediction_alone").n) < TRACK["min_track"]
        classic = _jax_track("classic")
        np.testing.assert_allclose(np.asarray(jt.R), np.asarray(classic.R), atol=1e-6)
        np.testing.assert_allclose(np.asarray(jt.t), np.asarray(classic.t), atol=1e-6)


def _borderline_slots(seen):
    """Slots whose column's mean reprojection error in the port's window BA
    lies within 1e-4 of the cull bar (``seen``: the map _window_ba got and
    the per-column errors it computed)."""
    m = seen["map"]
    ok = m.kf_live[:, None] & m.kf_fvalid & (m.kf_obs >= 0)
    cols = np.unique(_np(m.kf_obs)[_np(ok)])
    err = _np(seen["err"])[: cols.size]
    return set(cols[np.abs(err - CULL_BAR) < 1e-4].tolist())


def _watch_window_ba(monkeypatch):
    seen = {}
    window_ba, mean_reproj = tvd._window_ba, vo_core.masked_mean_reproj

    def watched_window_ba(m, **kw):
        seen["map"] = m
        return window_ba(m, **kw)

    def watched_err(final, problem):
        seen["err"] = mean_reproj(final, problem)
        return seen["err"]

    monkeypatch.setattr(tvd, "_window_ba", watched_window_ba)
    monkeypatch.setattr(vo_core, "masked_mean_reproj", watched_err)
    return seen


def _compare_maps(jm, tm, border, obs_before):
    """The parity bars of the map after a window BA; returns the number of
    left-out borderline columns (printed)."""
    keep = np.ones(LMAX, bool)
    keep[list(border)] = False
    np.testing.assert_array_equal(_np(tm.lm_valid)[keep], np.asarray(jm.lm_valid)[keep])
    np.testing.assert_array_equal(_np(tm.lm_gen)[keep], np.asarray(jm.lm_gen)[keep])
    obs_keep = ~np.isin(obs_before, list(border))
    np.testing.assert_array_equal(_np(tm.kf_obs)[obs_keep], np.asarray(jm.kf_obs)[obs_keep])
    live = np.asarray(jm.lm_valid) & keep
    np.testing.assert_allclose(_np(tm.X)[live], np.asarray(jm.X)[live], atol=1e-3)
    np.testing.assert_allclose(_np(tm.kf_R), np.asarray(jm.kf_R), atol=1e-3)
    np.testing.assert_allclose(_np(tm.kf_t), np.asarray(jm.kf_t), atol=1e-3)
    print(f"parity window BA: {len(border)} borderline cull columns left out")
    return len(border)


def test_torch_vo_device_window_ba_matches_jax(monkeypatch):
    seen = _watch_window_ba(monkeypatch)
    m, _, _ = _small_map()
    jm = jax.jit(lambda mm: jvd._window_ba(mm, **BA))(_jax_map(m))
    tm = tvd._window_ba(convert.device_map(m, device="cpu"), **BA)
    bogus = int(m.kf_obs[3, 36])
    assert not bool(jm.lm_valid[bogus]) and not bool(tm.lm_valid[bogus])  # culled in both
    assert _compare_maps(jm, tm, _borderline_slots(seen), m.kf_obs) <= 2


def test_torch_vo_device_promote_matches_jax(monkeypatch):
    m, (yx, desc, valid), _ = _small_map()
    jt = _jax_track("classic")
    seen = _watch_window_ba(monkeypatch)
    args = (jt.uv_new, jnp.asarray(desc), jnp.asarray(valid), jt.idx, jt.obs_pre, jt.R, jt.t)
    jm = jax.jit(lambda *a: jvd._promote(*a, tri_angle=0.35, **BA))(_jax_map(m), *args)
    tm = tvd._promote(
        convert.device_map(m, device="cpu"),
        *(torch.from_numpy(np.array(a)) for a in args), tri_angle=0.35, **BA,
    )
    # fresh landmarks were triangulated into free slots, and the ring shifted
    assert (np.asarray(jm.kf_obs[-1]) >= 0).sum() > (np.asarray(jt.obs_pre) >= 0).sum()
    np.testing.assert_array_equal(_np(tm.kf_live), np.asarray(jm.kf_live))
    np.testing.assert_array_equal(_np(tm.kf_fvalid), np.asarray(jm.kf_fvalid))
    np.testing.assert_allclose(_np(tm.kf_uv), np.asarray(jm.kf_uv), atol=1e-6)
    np.testing.assert_array_equal(_np(tm.kf_desc), np.asarray(jm.kf_desc))
    np.testing.assert_allclose(_np(tm.lm_desc), np.asarray(jm.lm_desc), atol=1e-6)
    _compare_maps(jm, tm, _borderline_slots(seen), _np(seen["map"].kf_obs))


# ---------------------------------------------------------------------------
# the slice: the synthetic stream of tests/test_vo.py through DeviceVO
# ---------------------------------------------------------------------------

CFG = dict(kf_max_gap=5, window=8, track_min_landmarks=30)


def _stream(n_frames=30, seed=42, blackout=()):
    X, desc = ref._make_world()
    rng = np.random.default_rng(seed)
    frames, gt = [], []
    for k in range(n_frames):
        R, t = ref._gt_pose(k, n_frames)
        gt.append((R, t))
        if k in blackout:
            z = jnp.zeros(ref.N_CAP)
            frames.append(JFeatures(
                yx=jnp.zeros((ref.N_CAP, 2)), score=z, theta=z,
                level=jnp.zeros(ref.N_CAP, jnp.int32),
                desc=jnp.zeros((ref.N_CAP, ref.DESC_DIM)), valid=jnp.zeros(ref.N_CAP, bool),
            ))
        else:
            frames.append(ref._render_features(X, desc, R, t, rng))
    return frames, np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt])


def _port_device(frames, **cfg):
    vo = tvd.DeviceVO(VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG, **cfg), device="cpu")
    for f in frames:
        vo.process_frame(convert.features(f, device="cpu"))
    return vo, vo.finalize()


@pytest.fixture(scope="module")
def runs():
    """The stream through the port's DeviceVO, the port's host engine and
    the JAX DeviceVO."""
    frames, gR, gt = _stream()
    vo, dstate = _port_device(frames)
    hstate = init_vo(VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG), device="cpu")
    for f in frames:
        hstate = process_frame(hstate, convert.features(f, device="cpu"))
    hstate = finalize(hstate)
    jvo = jvd.DeviceVO(JVOConfig(intrinsics=ref.K, **CFG))
    for f in frames:
        jvo.process_frame(f)
    return dict(vo=vo, device=dstate, host=hstate, jax=jvo.finalize(), gR=gR, gt=gt)


def test_torch_vo_device_stream_meets_reference_bars(runs):
    from cvsteer_tpu_torch.slam.evaluate import camera_centers, umeyama

    vo, st = runs["vo"], runs["device"]
    assert st.initialized
    assert vo.map is not None  # the device path engaged
    assert vo.captures == 0  # no graphs on the CPU: the halves run eagerly
    assert len(st.keyframes) >= 3
    assert st.num_landmarks > 100
    assert len(st.trajectory) == 30
    Rs, ts = st.poses()
    ate = ate_rmse(Rs, ts, runs["gR"], runs["gt"])
    assert ate < 0.05, f"ATE {ate:.4f} m"
    X = st.landmarks[st.landmark_valid]
    assert X.shape[0] > 100 and np.isfinite(X).all()
    s, R, t = umeyama(camera_centers(Rs, ts), camera_centers(runs["gR"], runs["gt"]))
    X_aligned = s * X @ R.T + t
    inside = ((X_aligned > [-5, -4, 3]) & (X_aligned < [5, 4, 13])).all(1).mean()
    assert inside > 0.9, f"only {inside:.2f} of landmarks in volume"


def test_torch_vo_device_matches_jax_engine_and_host_twin(runs):
    dR, dt = runs["device"].poses()
    for other in ("jax", "host"):
        oR, ot = runs[other].poses()
        ate = ate_rmse(dR, dt, oR, ot)
        print(f"parity VO device vs {other}: ATE {ate:.3e} m")
        assert ate < 0.01, f"{other}: {ate:.4f} m"
    assert abs(len(runs["device"].keyframes) - len(runs["jax"].keyframes)) <= 1


def test_torch_vo_device_recovers_after_blackout():
    frames, gR, gt = _stream(blackout={15, 16})
    _, st = _port_device(frames)
    assert len(st.trajectory) == 30
    Rs, ts = st.poses()
    tail = slice(20, 30)
    ate = ate_rmse(Rs[tail], ts[tail], gR[tail], gt[tail])
    assert ate < 0.15, f"post-blackout ATE {ate:.4f} m"

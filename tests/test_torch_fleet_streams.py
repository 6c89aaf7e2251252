"""The reference's own fleet tests (tests/test_vo_device.py:202, 232,
265, 754, 912) on the port's stacked fleet, on CPU, each fleet from its own
bootstrap: a 1-stream fleet against the port's DeviceVO (rtol 2e-4, atol
1e-4, the reference's bar for its vmapped fleet against its engine),
streams joining at staggered ticks (ATE < 0.08 each), blackout recovery
in the classic and the pipelined tick (the healthy stream's ATE < 0.08;
the blacked-out stream's frames stay aligned, and it keeps tracking after,
ATE < 0.15 over frames 20-29), and step_batched against the per-stream
pipelined step at pipeline depths 1 and 3 (equal keyframes, poses within
1e-5); and the signature store and a Sim(3) closure event through the
fleet, both ticks (the reference's closure bars). tests/test_torch_fleet.py
holds the fleet against the JAX package's. vmap's fallback to a
per-stream loop is an error here too.
"""

import numpy as np
import pytest
import torch

import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu_torch.slam import vo_device as tvd
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.utils import convert
from test_torch_fleet import N_FRAMES, _ate, _cfg, _port, _port_fleet, _ticks

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")


def test_torch_fleet_single_stream_matches_device_vo():
    X, desc = ref._make_world()
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    seq = tvd.DeviceVO(_cfg(), device="cpu")
    flt = tvd.DeviceVOFleet(_cfg(), n_streams=1, device="cpu")
    for k in range(N_FRAMES):
        R, t = ref._gt_pose(k, N_FRAMES)
        fa, fb = (convert.features(ref._render_features(X, desc, R, t, r), device="cpu")
                  for r in rngs)
        seq.process_frame(fa)
        flt.step([fb])
    sa, sb = seq.state, flt.engines[0].state
    assert len(sa.trajectory) == len(sb.trajectory) == N_FRAMES
    assert [kf.index for kf in sa.keyframes] == [kf.index for kf in sb.keyframes]
    for (fa_, Ra, ta), (fb_, Rb, tb) in zip(sa.trajectory, sb.trajectory):
        assert fa_ == fb_
        np.testing.assert_allclose(Ra, Rb, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(ta, tb, rtol=2e-4, atol=1e-4)


def test_torch_fleet_parallel_streams_join_staggered():
    ticks, gR, gt = _ticks(10, 20, 4, N_FRAMES, join=True)
    _, states = _port_fleet(ticks)
    for s, st in enumerate(states):
        assert st.initialized
        ate = _ate(st, gR, gt, offset=s)
        assert ate < 0.08, f"stream {s}: ATE {ate:.4f} m"


@pytest.mark.parametrize("pipeline", [False, True], ids=["classic", "pipelined"])
def test_torch_fleet_recovers_after_blackout(pipeline):
    n = 30
    ticks, gR, gt = _ticks(30, 40, 2, n, blackout=(15, 16))
    _, (s0, s1) = _port_fleet(ticks, pipeline=pipeline)
    assert _ate(s1, gR, gt) < 0.08  # the healthy stream is unaffected
    assert s0.frame_count == n  # frames stay aligned (a dropped frame still counts)
    tail = [(f, R, t) for f, R, t in s0.trajectory if f >= 20]
    assert len(tail) >= 8  # recovered and kept tracking
    ids = [p[0] for p in tail]
    ate = ate_rmse(np.stack([p[1] for p in tail]), np.stack([p[2] for p in tail]), gR[ids], gt[ids])
    assert ate < 0.15, f"post-blackout ATE {ate:.4f} m"


BOOT = 8


@pytest.fixture(scope="module")
def world():
    """The 2-stream stream of tests/test_vo_device.py's pipelined test."""
    return _ticks(50, 60, 2, N_FRAMES)


@pytest.fixture(scope="module")
def per_stream(world):
    """The port's pipelined fleet (promote_cap 1) stepped per stream on
    ``world``, from its own bootstrap."""
    return _port_fleet(world[0], pipeline=True, promote_cap=1)[1]


@pytest.mark.parametrize("depth", [1, 3])
def test_torch_fleet_step_batched_matches_per_stream(world, per_stream, depth):
    """step_batched (batched features, up to ``depth`` ticks in flight, the
    promoted rows riding the tick's fetch) tracks as the per-stream
    pipelined step() does on the same frames."""
    ticks, _, _ = world
    flt = tvd.DeviceVOFleet(_cfg(), n_streams=2, pipeline=True, promote_cap=1,
                            pipeline_depth=depth, device="cpu")
    for k, tick in enumerate(ticks):
        feats = _port(tick)
        if k >= BOOT and flt.active.all():
            flt.step_batched(*(torch.stack([getattr(f, a) for f in feats])
                               for a in ("yx", "desc", "valid")))
        else:
            flt.step(feats)
    got = [flt.finalize(s) for s in range(2)]
    for s, (a, b) in enumerate(zip(got, per_stream)):
        assert len(a.trajectory) == len(b.trajectory) == len(ticks)
        assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes], (depth, s)
        (Ra, ta), (Rb, tb) = a.poses(), b.poses()
        np.testing.assert_allclose(ta, tb, atol=1e-5)
        np.testing.assert_allclose(Ra, Rb, atol=1e-5)


@pytest.mark.parametrize("pipeline", [False, True], ids=["classic", "pipelined"])
def test_torch_fleet_sim3_closure_event(pipeline):
    """The signature store in the fleet's graphs and a closure through its
    event path: the drifted state of
    tests/test_torch_loopclosure.py::test_torch_engines_sim3_closure_end_to_end_scale_drift,
    adopted by both engines of a 2-stream fleet with Sim(3) closure on;
    each stream accepts a closure and its keyframe ATE at least halves (the
    reference test's bars)."""
    import copy

    import test_loopclosure as rlc
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from test_torch_loopclosure import _kf_ate

    rng_w = np.random.default_rng(9)  # test_loopclosure.loop_world
    X = rng_w.uniform([-2, -1.5, -2], [2, 1.5, 2], (300, 3)).astype(np.float32)
    desc = rng_w.normal(size=(300, ref.DESC_DIM)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    rng = np.random.default_rng(11)
    n_frames = 48
    gt = [rlc._lookat_pose(np.array([7.0 * np.sin(a), 0.0, -7.0 * np.cos(a)]))
          for a in 2 * np.pi * np.arange(n_frames) / (n_frames - 1)]
    frames = [convert.features(ref._render_features(X, desc, R, t, rng, pix_noise=0.1), "cpu")
              for R, t in gt]
    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), kf_max_gap=4, window=6,
                   track_min_landmarks=40, min_parallax=0.01)
    vo = tvd.DeviceVO(cfg, device="cpu")
    for k in range(40):
        vo.process_frame(frames[k])
    st = vo.sync_host()
    assert rlc._inject_scale_drift(st, rate=0.07) > 1.8
    before = _kf_ate(st, gt)
    st.config = cfg._replace(loop_closure=True, loop_closure_sim3=True, loop_min_gap=6,
                             loop_min_inliers=20)
    flt = tvd.DeviceVOFleet(st.config, n_streams=2, pipeline=pipeline, device="cpu")
    for eng in flt.engines:
        eng.adopt(copy.deepcopy(st))
    for k in range(40, n_frames):
        flt.step([frames[k], frames[k]])
    assert flt.stack.sig is not None  # the store rides the stack
    for eng, final in zip(flt.engines, (flt.finalize(i) for i in range(2))):
        assert eng.closures_accepted >= 1
        assert _kf_ate(final, gt) < 0.5 * before


"""Chunked stepping of the port's DeviceVO (issue_chunk / complete_chunk,
graph C on a card, run eagerly here on the CPU).

1. The reference's test_device_vo_chunked_matches_sequential
   (tests/test_vo_device.py) on the port: 32 frames of tests/test_vo.py's
   world in chunks of 4 give the sequential engine's keyframes and
   trajectory (R within 1e-5, t within 1e-4, the reference's bars). The
   JAX DeviceVO's issue_chunk / complete_chunk on the same features, in
   chunks of 4, gives the same keyframes; its poses are held at the bar of
   the two sequential engines (tests/test_torch_vo_device.py: ATE under
   0.01 m; here also R within 1e-3, t within 1e-2 pose by pose): the
   two-view bootstrap already parts the sequential engines by 2.3e-3 m at
   frame 2 and 8.2e-3 m at frame 31 on these frames.
2. A chunk in which a closure is found: the 48-frame circle of
   tests/test_loopclosure.py with loop closure on, in chunks of 4. Every
   closure event runs at a chunk's end (none inside), and at least one was
   found inside a chunk. (tests/test_torch_vo_chunk_parity.py holds this
   run against the JAX package's chunked run.)
3. A lost frame inside a chunk: the chunk leaves the map as it was from
   that frame on, complete_chunk stops there, and stepping the rest one at
   a time gives the sequential engine's trajectory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_loopclosure as rlc  # the reference tests' loop world
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu.slam.vo_device import DeviceVO as JDeviceVO
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.slam.vo_device import DeviceVO
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)


def _stack(frames):
    return [torch.stack([getattr(f, k) for f in frames]) for k in ("yx", "desc", "valid")]


def _run_chunked(vo, frames, chunk, on_chunk=None):
    """frames through ``vo`` in chunks (bootstrap and the rows a chunk did
    not consume one at a time); returns the chunk boundaries."""
    k, bounds = 0, []
    while k < len(frames):
        if vo.map is None:
            vo.process_frame(frames[k])
            k += 1
            continue
        span = min(chunk, len(frames) - k)
        rows = vo.issue_chunk(*_stack(frames[k:k + span]))
        assert len(rows) == span
        done = vo.complete_chunk(frames[k:k + span], rows)
        if on_chunk is not None:
            on_chunk(k, span, done)
        for j in range(done, span):
            vo.process_frame(frames[k + j])
        k += span
        bounds.append(k)
    return bounds


def _run_jax_chunked(vo, frames, chunk):
    """The reference test's loop: the JAX DeviceVO in chunks of ``chunk``."""
    k = 0
    while k < len(frames):
        if vo.map is None:
            vo.process_frame(frames[k])
            k += 1
            continue
        span = min(chunk, len(frames) - k)
        fb = jax.tree.map(lambda *xs: jnp.stack(xs), *frames[k:k + span])
        out = jax.device_get(vo.issue_chunk(fb.yx, fb.desc, fb.valid))
        done = vo.complete_chunk(frames[k:k + span], out)
        for j in range(done, span):
            vo.process_frame(frames[k + j])
        k += span
    return vo.finalize()


def _max_pose_diff(a, b):
    """Largest |R - R'| and |t - t'| over the two trajectories' frames."""
    assert [f for f, _, _ in a.trajectory] == [f for f, _, _ in b.trajectory]
    dR = max(np.abs(Ra - np.asarray(Rb)).max() for (_, Ra, _), (_, Rb, _) in zip(a.trajectory, b.trajectory))
    dt = max(np.abs(ta - np.asarray(tb)).max() for (_, _, ta), (_, _, tb) in zip(a.trajectory, b.trajectory))
    return float(dR), float(dt)


def _assert_same(a, b):
    assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes]
    assert len(a.trajectory) == len(b.trajectory)
    for (fa, Ra, ta), (fb, Rb, tb) in zip(a.trajectory, b.trajectory):
        assert fa == fb
        np.testing.assert_allclose(Ra, Rb, atol=1e-5)
        np.testing.assert_allclose(ta, tb, atol=1e-4)


def _world_frames(n_frames=32, seed=42, blackout=(), reference=False):
    """The world's features as the port's Features (and, with
    ``reference``, also the JAX Features they were converted from)."""
    X, desc = ref._make_world()
    rng = np.random.default_rng(seed)
    out, ref_out = [], []
    for k in range(n_frames):
        rf = ref._render_features(X, desc, *ref._gt_pose(k, n_frames), rng)
        f = convert.features(rf, device="cpu")
        if k in blackout:
            f = f._replace(valid=torch.zeros_like(f.valid))
        out.append(f)
        ref_out.append(rf)
    return (out, ref_out) if reference else out


def test_torch_device_vo_chunked_matches_sequential():
    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), kf_max_gap=5, window=8,
                   track_min_landmarks=30)
    frames, ref_frames = _world_frames(reference=True)
    seq = DeviceVO(cfg, device="cpu")
    for f in frames:
        seq.process_frame(f)
    chunked = DeviceVO(cfg, device="cpu")
    _run_chunked(chunked, frames, 4)
    assert len(chunked.state.keyframes) >= 5
    state = chunked.finalize()
    _assert_same(state, seq.finalize())

    jstate = _run_jax_chunked(
        JDeviceVO(JVOConfig(intrinsics=ref.K, kf_max_gap=5, window=8, track_min_landmarks=30)),
        ref_frames, 4)
    assert [kf.index for kf in state.keyframes] == [kf.index for kf in jstate.keyframes]
    dR, dt = _max_pose_diff(state, jstate)
    Rs, ts = state.poses()
    jR, jt = jstate.poses()
    ate = ate_rmse(Rs, ts, np.asarray(jR), np.asarray(jt))
    print(f"parity chunks port vs JAX: max |dR| {dR:.3e}, max |dt| {dt:.3e} m, ATE {ate:.3e} m")
    assert dR < 1e-3 and dt < 1e-2 and ate < 0.01
    with pytest.raises(ValueError, match="motion_model"):
        DeviceVO(cfg._replace(motion_model=True), device="cpu").issue_chunk(*_stack(frames[:2]))


# the closure test's configuration, the same in both packages
LOOP_CFG = dict(kf_max_gap=4, window=6, track_min_landmarks=40, min_parallax=0.01,
                loop_closure=True, loop_min_gap=6, loop_min_inliers=20)


def _loop_frames(n_frames=48):
    """A circle of radius 7 m around the loop world that revisits its
    start: the port's Features and the JAX Features they came from."""
    X, desc = _loop_world()
    rng = np.random.default_rng(11)
    frames, ref_frames = [], []
    for k in range(n_frames):
        a = 2 * np.pi * (k / (n_frames - 1))
        R, t = rlc._lookat_pose(np.array([7.0 * np.sin(a), 0.0, -7.0 * np.cos(a)]))
        ref_frames.append(ref._render_features(X, desc, R, t, rng, pix_noise=0.1))
        frames.append(convert.features(ref_frames[-1], device="cpu"))
    return frames, ref_frames


def test_torch_device_vo_chunk_defers_closure_to_its_end():
    frames, _ = _loop_frames()
    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), **LOOP_CFG)

    def recorded(vo):
        calls = []
        closure = vo._closure

        def spy(cand=None):
            calls.append((vo.state.frame_count, vo._defer_closure))
            closure(cand)
        vo._closure = spy
        return calls

    chunked = DeviceVO(cfg, device="cpu")
    calls = recorded(chunked)
    found_inside = []

    def on_chunk(k, span, done):
        if calls and calls[-1][0] == chunked.state.frame_count and k not in found_inside:
            found_inside.append(k)

    bounds = _run_chunked(chunked, frames, 4, on_chunk)
    assert calls, "no closure event on the loop"
    assert all(not deferred for _, deferred in calls)
    assert {f for f, _ in calls} <= set(bounds)  # every event at a chunk's end
    assert found_inside


def _loop_world():
    """tests/test_loopclosure.py's loop_world fixture, seed 9."""
    rng = np.random.default_rng(9)
    X = rng.uniform([-2, -1.5, -2], [2, 1.5, 2], (300, 3)).astype(np.float32)
    desc = rng.normal(size=(300, ref.DESC_DIM)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return X, desc


def test_torch_device_vo_chunk_stops_at_a_lost_frame():
    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), kf_max_gap=5, window=8,
                   track_min_landmarks=30)
    frames = _world_frames(n_frames=24, blackout=(14,))
    seq = DeviceVO(cfg, device="cpu")
    for f in frames:
        seq.process_frame(f)
    chunked = DeviceVO(cfg, device="cpu")
    stops = []
    _run_chunked(chunked, frames, 4, lambda k, span, done: stops.append((k, done)))
    assert any(k + done == 14 and done < 4 for k, done in stops)  # it stopped at frame 14
    _assert_same(chunked.finalize(), seq.finalize())

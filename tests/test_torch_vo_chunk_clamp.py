"""Chunked stepping of the port's DeviceVO with the speed clamp on (run
eagerly here on the CPU): tests/test_vo.py's world with its speed stepped
up 3.3x at frame 28 and VOConfig.speed_prior_band (0.5, 2.0), in chunks
of 8 (two promotions a chunk). The clamp fires in the sequential engine
after the step; the
chunked run clamps on the same frames and gives the sequential engine's
keyframes and trajectory (R within 1e-5, t within 1e-4). A promotion that
the clamp rewrote must not be read by the rest of its chunk, so the chunk
leaves the map as it was after its first promotion and complete_chunk
stops there.
"""

import numpy as np
import torch

import test_torch_vo_chunk as chunks  # the chunk loop and its bars
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu_torch.slam import vo as hostvo
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.slam.vo_device import DeviceVO
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)


def _speed_step_frames(seed=42):
    """tests/test_vo.py's world along its path at 0.6 of a frame's step for
    28 frames, then at 2.0 for 12."""
    times = list(0.6 * np.arange(28)) + list(0.6 * 27 + 2.0 * np.arange(1, 13))
    span = times[-1] + 1
    X, desc = ref._make_world()
    rng = np.random.default_rng(seed)
    return [convert.features(ref._render_features(X, desc, *ref._gt_pose(t, span), rng), device="cpu")
            for t in times]


def test_torch_device_vo_chunk_with_speed_clamp_matches_sequential(monkeypatch):
    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), kf_max_gap=3, window=8,
                   track_min_landmarks=30, speed_prior_band=(0.5, 2.0))
    clamped = []
    apply = hostvo.apply_speed_prior

    def spy(state, fresh_ids=None):
        fired = apply(state, fresh_ids=fresh_ids)
        if fired:
            clamped.append(state.frame_count)
        return fired
    monkeypatch.setattr(hostvo, "apply_speed_prior", spy)
    frames = _speed_step_frames()
    seq = DeviceVO(cfg, device="cpu")
    for f in frames:
        seq.process_frame(f)
    seq_clamped, clamped[:] = list(clamped), []
    assert seq_clamped and min(seq_clamped) > 28  # after the step, at least once
    chunked = DeviceVO(cfg, device="cpu")
    chunks._run_chunked(chunked, frames, 8)
    assert clamped == seq_clamped
    chunks._assert_same(chunked.finalize(), seq.finalize())

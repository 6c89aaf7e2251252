"""Checkpoint / resume (cvsteer_tpu_torch.utils.checkpoint) and cli_vo's
--checkpoint-dir, on CPU.

- a round trip of a host-engine and a device-engine state (the synthetic
  stream of tests/test_vo.py): every saved field equal, the restored
  engine keeps tracking, the host engine's continuation equal to the
  uninterrupted run's;
- the tree has the reference's keys and layouts: the port's
  _state_to_tree of a reference state (built by the reference's own
  _tree_to_state, carried by utils.convert.vo_state) equals the
  reference's _state_to_tree of it, key for key and bit for bit;
- the config guard, emergency_save taken when newer, max_to_keep.

cli_vo --checkpoint-dir: tests/test_torch_checkpoint_cli.py.
"""

import os

import numpy as np
import pytest
import torch

import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu.slam.vo import init_vo as j_init_vo
from cvsteer_tpu.utils import checkpoint as jck
from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_frame
from cvsteer_tpu_torch.slam.vo_device import DeviceVO
from cvsteer_tpu_torch.utils import checkpoint as tck
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)
CFG = dict(kf_max_gap=4, window=6, track_min_landmarks=30)


def _cfg():
    return VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG)


def _frames(n, seed=11):
    X, desc = ref._make_world()
    rng = np.random.default_rng(seed)
    return [convert.features(ref._render_features(X, desc, *ref._gt_pose(k, 30), rng), device="cpu")
            for k in range(n)]


def _assert_same_tree(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{path}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("engine", ["host", "device"])
def test_torch_checkpoint_roundtrip(tmp_path, engine):
    frames = _frames(16)
    if engine == "device":
        eng = DeviceVO(_cfg(), device="cpu")
        for f in frames[:12]:
            eng.process_frame(f)
        state = eng.sync_host()
    else:
        state = init_vo(_cfg(), device="cpu")
        for f in frames[:12]:
            state = process_frame(state, f)
    assert state.initialized and len(state.kf_baselines) > 0

    ck = tck.SlamCheckpointer(str(tmp_path / "ck"))
    ck.save(len(state.keyframes), state)
    assert ck.latest_step() == len(state.keyframes)
    restored = ck.restore(init_vo(_cfg(), device="cpu"))
    _assert_same_tree(tck._state_to_tree(restored), tck._state_to_tree(state))
    assert restored.kf_baselines == state.kf_baselines
    assert restored.keyframes[0].features.yx.device.type == "cpu"

    if engine == "device":
        eng2 = DeviceVO(_cfg(), device="cpu")
        eng2.adopt(restored)
        for f in frames[12:]:
            eng2.process_frame(f)
        assert eng2.state.frame_count == 16 and len(eng2.state.trajectory) == 16
        assert all(np.isfinite(t).all() for _, _, t in eng2.state.trajectory)
    else:
        for f in frames[12:]:
            restored = process_frame(restored, f)
            state = process_frame(state, f)
        assert restored.frame_count == 16
        for (fa, Ra, ta), (fb, Rb, tb) in zip(restored.trajectory, state.trajectory):
            assert fa == fb
            np.testing.assert_array_equal(Ra, Rb)
            np.testing.assert_array_equal(ta, tb)
    ck.close()


def test_torch_checkpoint_tree_matches_reference():
    """The port's tree of a reference state equals the reference's tree of
    it (the reference state is rebuilt from a port run's tree by the
    reference's _tree_to_state: the tree crosses both ways)."""
    state = init_vo(_cfg(), device="cpu")
    for f in _frames(10):
        state = process_frame(state, f)
    state.ground_hist = [1.4, 1.6]
    tree = convert.checkpoint_tree(tck._state_to_tree(state))
    jstate = jck._tree_to_state(tree, j_init_vo(JVOConfig(intrinsics=ref.K, **CFG)))
    want = jck._state_to_tree(jstate)
    got = tck._state_to_tree(convert.vo_state(jstate, device="cpu"))
    _assert_same_tree(got, want)
    _assert_same_tree(got, tree)


def test_torch_checkpoint_config_guard_emergency_and_retention(tmp_path):
    state = init_vo(_cfg(), device="cpu")
    for f in _frames(8):
        state = process_frame(state, f)
    ck = tck.SlamCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, state)
    assert sorted(os.listdir(tmp_path)) == ["config.json", "step_2.pt", "step_3.pt"]

    other = VOConfig(intrinsics=convert.intrinsics(ref.K), **dict(CFG, window=7))
    with pytest.raises(ValueError, match="config differs"):
        ck.restore(init_vo(other, device="cpu"))
    assert ck.restore(init_vo(other, device="cpu"), allow_config_mismatch=True).frame_count == 8

    state.frame_count = 99  # marks the emergency copy
    ck.emergency_save(5, state)
    assert ck.latest_step() == 5
    assert ck.restore(init_vo(_cfg(), device="cpu")).frame_count == 99
    assert ck.restore(init_vo(_cfg(), device="cpu"), step=3).frame_count == 8
    state.frame_count = 8
    ck.save(6, state)
    assert ck.latest_step() == 6
    assert ck.restore(init_vo(_cfg(), device="cpu")).frame_count == 8
    ck.close()

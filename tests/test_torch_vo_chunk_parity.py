"""Chunked stepping of the port's DeviceVO against the JAX package's (run
eagerly here on the CPU): the closure run of tests/test_torch_vo_chunk.py (the 48-frame circle
   with loop closure on, chunks of 4) through both packages' issue_chunk /
   complete_chunk on the same features: the same keyframes, the same
   number of accepted closures (at least one), poses within R 1e-4 and
   t 1e-3. They agree to 5.5e-6 and 5.4e-5 m here; the bar is an order
   wider because float32 rounding through the window BA parts the two
   packages' sequential engines by up to 8.2e-3 m on the world stream of
   tests/test_torch_vo_chunk.py.
"""

import torch

import test_torch_vo_chunk as chunks  # the chunk loops, worlds and bars
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu.slam.vo_device import DeviceVO as JDeviceVO
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.slam.vo_device import DeviceVO
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)


def test_torch_device_vo_chunk_closures_match_jax_chunks():
    frames, ref_frames = chunks._loop_frames()
    port = DeviceVO(VOConfig(intrinsics=convert.intrinsics(ref.K), **chunks.LOOP_CFG), device="cpu")
    chunks._run_chunked(port, frames, 4)
    state = port.finalize()
    jvo = JDeviceVO(JVOConfig(intrinsics=ref.K, **chunks.LOOP_CFG))
    jstate = chunks._run_jax_chunked(jvo, ref_frames, 4)
    assert [kf.index for kf in state.keyframes] == [kf.index for kf in jstate.keyframes]
    assert port.closures_accepted == jvo.closures_accepted > 0
    dR, dt = chunks._max_pose_diff(state, jstate)
    print(f"parity chunk closures port vs JAX: accepted {port.closures_accepted}, "
          f"max |dR| {dR:.3e}, max |dt| {dt:.3e} m")
    assert dR < 1e-4 and dt < 1e-3

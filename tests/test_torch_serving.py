"""Batched VO serving in the port (cvsteer_tpu_torch.slam.vo_server,
slam.vo_device.DeviceVOServer, cli_vo with several inputs), on CPU.

The reference's serving tests (tests/test_vo.py:248, 277;
tests/test_vo_device.py:145, 173; tests/test_cli_vo.py:317) on the port:

1. The host VOServer: one stream equals ``vo.process_frame`` bit for bit
   (tests/test_vo.py's synthetic world, 20 frames); 4 streams in 4 worlds
   each track (ATE < 0.15).
2. DeviceVOServer: one stream equals the port's DeviceVO (1e-6, the
   reference's bar); 4 streams each track (ATE < 0.08).
3. ``cli_vo --device cpu`` with two copies of tests/assets/tum_fixture
   with ``--engine host``, ``--engine device`` and ``--engine device
   --pipeline``: one trajectory file per stream, 32 poses each, the two
   equal, an ATE line per stream and the aggregate frames/s line. These
   run in a child process with ``MKL_CBWR=COMPATIBLE``: MKL's float32 GEMM
   otherwise rounds by the operands' memory alignment, so two identical
   streams whose buffers sit differently could part at 1e-7 on the CPU and
   the window BA would carry it on. The refusal: no GPU without ``--device
   cpu``. (Serving with ``--checkpoint-dir``: tests/test_torch_checkpoint.py.)
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_frame
from cvsteer_tpu_torch.slam.vo_device import DeviceVO, DeviceVOServer
from cvsteer_tpu_torch.slam.vo_server import VOServer
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "assets" / "tum_fixture"
CFG = dict(kf_max_gap=5, window=8, track_min_landmarks=30)


def _cfg():
    return VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG)


def _frames(world_seed, rng_seed, n_frames):
    X, desc = ref._make_world(seed=world_seed)
    rng = np.random.default_rng(rng_seed)
    return [convert.features(ref._render_features(X, desc, *ref._gt_pose(k, n_frames), rng),
                             device="cpu") for k in range(n_frames)]


def _gt(n_frames):
    gt = [ref._gt_pose(k, n_frames) for k in range(n_frames)]
    return np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt])


def test_torch_vo_server_single_stream_matches_sequential():
    frames = _frames(3, 7, 20)
    seq = init_vo(_cfg(), device="cpu")
    for f in frames:
        seq = process_frame(seq, f)
    srv = VOServer(_cfg(), n_streams=1, device="cpu")
    for f in frames:
        srv.step([f])
    st = srv.states[0]
    assert len(seq.keyframes) >= 3  # promotions ran through the server's second wait
    assert [kf.index for kf in st.keyframes] == [kf.index for kf in seq.keyframes]
    assert len(st.trajectory) == len(seq.trajectory) == 20
    for (fa, Ra, ta), (fb, Rb, tb) in zip(st.trajectory, seq.trajectory):
        assert fa == fb
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(st.landmarks, seq.landmarks)


def test_torch_vo_server_parallel_streams_track():
    S, n = 4, 20
    streams = [_frames(10 + s, 100 + s, n) for s in range(S)]
    srv = VOServer(_cfg(), n_streams=S, device="cpu")
    for k in range(n):
        srv.step([streams[s][k] for s in range(S)])
    gR, gt = _gt(n)
    for s in range(S):
        st = srv.finalize(s)
        assert st.initialized, f"stream {s} failed to initialize"
        Rs, ts = st.poses()
        ate = ate_rmse(Rs, ts, gR[: len(ts)], gt[: len(ts)])
        assert ate < 0.15, f"stream {s}: ATE {ate:.4f} m"


def test_torch_device_vo_server_single_stream_matches_engine():
    fa, fb = _frames(0, 5, 25), _frames(0, 5, 25)
    seq = DeviceVO(_cfg(), device="cpu")
    srv = DeviceVOServer(_cfg(), n_streams=1, device="cpu")
    for a, b in zip(fa, fb):
        seq.process_frame(a)
        srv.step([b])
    sa, sb = seq.state, srv.engines[0].state
    assert seq.map is not None and srv.engines[0].map is not None  # the device path ran
    assert len(sa.trajectory) == len(sb.trajectory) == 25
    for (fa_, Ra, ta), (fb_, Rb, tb) in zip(sa.trajectory, sb.trajectory):
        assert fa_ == fb_
        np.testing.assert_allclose(Ra, Rb, atol=1e-6)
        np.testing.assert_allclose(ta, tb, atol=1e-6)


def test_torch_device_vo_server_parallel_streams():
    S, n = 4, 25
    streams = [_frames(10 + s, 20 + s, n) for s in range(S)]
    srv = DeviceVOServer(_cfg(), n_streams=S, device="cpu")
    for k in range(n):
        srv.step([streams[s][k] for s in range(S)])
    gR, gt = _gt(n)
    for s in range(S):
        st = srv.finalize(s)
        assert st.initialized
        Rs, ts = st.poses()
        ate = ate_rmse(Rs, ts, gR, gt)
        assert ate < 0.08, f"stream {s}: ATE {ate:.4f} m"


CLI_SET = ["--set", "camera.fx=300", "camera.fy=300", "camera.cx=160", "camera.cy=120",
           "slam.min_parallax=0.005", "slam.kf_max_gap=2", "slam.window=6"]
ENGINES = {"host": ["--engine", "host"], "device": ["--engine", "device"],
           "pipelined": ["--engine", "device", "--pipeline"]}


def test_torch_cli_vo_serving_mode(tmp_path):
    argvs = []
    for name, flags in ENGINES.items():
        (tmp_path / name).mkdir()
        argvs.append(["--input", f"{FIXTURE},{FIXTURE}", *CLI_SET, *flags, "--device", "cpu",
                      "--output", str(tmp_path / name / "traj.txt")])
    code = ("from cvsteer_tpu_torch.cli_vo import main\n"
            f"for argv in {argvs!r}:\n    assert main(argv) == 0\n")
    env = dict(os.environ, MKL_CBWR="COMPATIBLE", OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("ATE RMSE") == 2 * len(ENGINES), run.stdout
    assert run.stderr.count("frames/s aggregate") == len(ENGINES), run.stderr[-3000:]
    for name in ENGINES:
        t0 = (tmp_path / name / "traj.0.txt").read_text()
        t1 = (tmp_path / name / "traj.1.txt").read_text()
        assert len([ln for ln in t0.splitlines() if ln.strip()]) == 32, name
        assert t0 == t1, f"{name}: identical streams, different trajectories"


def test_torch_cli_vo_serving_refusals(tmp_path):
    from cvsteer_tpu_torch.cli_vo import main

    two = ["--input", f"{FIXTURE},{FIXTURE}", *CLI_SET]
    if not torch.cuda.is_available():
        assert main(two + ["--engine", "device"]) == 2  # no card: --device cpu must be asked for

"""Slice tests of the port's VO engine (cvsteer_tpu_torch.slam.vo) on CPU.

1. The synthetic feature stream of tests/test_vo.py (the same world, poses,
   renders and noise, made from the same seeds) driven through the port's
   process_frame must meet that file's bars: initialized, >= 3 keyframes,
   > 100 landmarks, 30 poses, ATE < 0.05.
2. The port's cli_vo.main on the committed real-imagery TUM fixture with
   the flags of tests/test_cli_vo.py and its derived ATE bound.
"""

import pathlib

import numpy as np
import torch

import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import VOConfig, finalize, init_vo, process_frame
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "assets" / "tum_fixture"


def test_torch_vo_synthetic_stream_meets_reference_bars():
    X, desc = ref._make_world()
    rng = np.random.default_rng(42)
    n_frames = 30
    cfg = VOConfig(
        intrinsics=convert.intrinsics(ref.K), kf_max_gap=5, window=8,
        track_min_landmarks=30,
    )
    state = init_vo(cfg, device="cpu")
    gt = []
    for k in range(n_frames):
        R, t = ref._gt_pose(k, n_frames)
        gt.append((R, t))
        state = process_frame(state, convert.features(ref._render_features(X, desc, R, t, rng), device="cpu"))
    state = finalize(state)

    assert state.initialized
    assert len(state.keyframes) >= 3
    assert state.num_landmarks > 100
    assert len(state.trajectory) == n_frames
    Rs, ts = state.poses()
    ate = ate_rmse(Rs, ts, np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt]))
    assert ate < 0.05, f"ATE {ate:.4f} m"


def test_torch_convert_carries_reference_parameters():
    from cvsteer_tpu.filters import g2 as jg2
    from cvsteer_tpu.filters import taps as jtaps
    from cvsteer_tpu.slam import vo as jvo
    from cvsteer_tpu_torch.filters import g2 as tg2
    from cvsteer_tpu_torch.filters import taps as ttaps

    assert convert.vo_config(jvo.VOConfig()) == VOConfig()
    got = convert.g2_bank(jg2.g2_bank())
    want = tg2.g2_bank()
    np.testing.assert_array_equal(got.xtaps, want.xtaps)
    assert (got.width, got.spacing) == (want.width, want.spacing)
    sb = convert.separable_bank(jtaps.g4h4_bank())
    np.testing.assert_array_equal(sb.ytaps, ttaps.g4h4_bank().ytaps)
    assert sb.names == ttaps.g4h4_bank().names


def test_torch_cli_vo_on_real_image_fixture(tmp_path):
    from cvsteer_tpu_torch.cli_vo import main
    from cvsteer_tpu_torch.io.datasets import open_sequence

    out = tmp_path / "traj.txt"
    rc = main([
        "--input", str(FIXTURE),
        "--set", "camera.fx=300", "camera.fy=300", "camera.cx=160",
        "camera.cy=120", "slam.min_parallax=0.005", "slam.kf_max_gap=2",
        "slam.window=6",
        "--output", str(out), "--device", "cpu",
    ])
    assert rc == 0
    lines = [l for l in out.read_text().splitlines() if l.strip()]
    assert len(lines) == 32  # one TUM-format pose per frame
    vals = np.array([[float(x) for x in l.split()] for l in lines])
    assert np.isfinite(vals).all()

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

    # The derived bound of tests/test_cli_vo.py: per keyframe hop the
    # monocular depth-direction error is sigma_px / f * Z^2 / (B_kf *
    # sqrt(N_lm)); drift random-walks over the hops, gated at 3 sigma.
    sigma_px, f_px, Z, N_lm = 1.0, 300.0, 4.0, 100.0
    centers = np.einsum("kij,kj->ki", seq.gt_R.transpose(0, 2, 1), -seq.gt_t)
    kf_gap = 2
    B_kf = float(np.median(np.linalg.norm(np.diff(centers, axis=0), axis=1)) * kf_gap)
    hops = (len(lines) - 1) / kf_gap
    bound = 3.0 * np.sqrt(hops) * sigma_px / f_px * Z**2 / (B_kf * np.sqrt(N_lm))
    assert ate < bound, f"ATE {ate:.3f} m exceeds the derived bound {bound:.3f} m"

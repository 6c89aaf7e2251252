"""The plain reference against the program's front-end at a small size, and
the control: the same reference one precision step down, which the
comparison's limits must refuse."""

import numpy as np
import pytest
import torch

from benchmark import harness, judge, reference, render
from benchmark.tests.small import load

GAP = load("tum_vga_fleet", "staggered_xyz")[1]["pose_gap_frames"]


def _frames(n=3, hw=(96, 128), seed=4):
    m = render.motion_from(load("tum_vga_fleet", "staggered_xyz")[1], np.random.default_rng(seed))
    R, t = m.poses(np.arange(0, 12 * n, 12))
    f = 500.0 * hw[1] / 640
    return render.render(render.Scene(seed, "cpu"), R, t, hw, (f, f, hw[1] / 2, hw[0] / 2), seed)


@pytest.mark.parametrize("cfg_name", ["tum_vga_fleet", "tum_vga_g4_features"])
def test_bench_reference_agrees_with_the_program_and_refuses_the_control(cfg_name):
    from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features

    cfg, _ = load(cfg_name, "pool_b32")
    fc = dict(cfg["frontend"], keypoints_per_level=64, levels=4)
    imgs = _frames()
    feats = extract_features(imgs, cfg=FrontendConfig(**fc))
    ref = reference.features(imgs, fc, "float64")
    prog = judge.frontend_numbers(harness._rows(feats), ref, fc["levels"])
    ctrl = judge.frontend_numbers([reference.as_frame(c) for c in reference.features(imgs, fc, "tf32")],
                                  ref, fc["levels"])
    lim = judge.LIMITS
    assert prog["kp_miss_pct"] <= lim["kp_miss_pct"] and prog["desc_err"] <= lim["desc_err"], prog
    assert ctrl["desc_err"] > lim["desc_err"] or ctrl["kp_miss_pct"] > lim["kp_miss_pct"], ctrl
    assert ctrl["desc_err"] > 10 * prog["desc_err"]


def test_bench_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-20])
    y = reference.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10 and y[3] == -3.0
    # 1 + 2^-11 is a tie: rounds away in magnitude (to 1 + 2^-10)
    assert y[1] in (1.0, 1.0 + 2**-10)


def test_bench_pose_check_sees_a_stuck_stream():
    m = render.motion_from(load("tum_vga_fleet", "staggered_xyz")[1], np.random.default_rng(2))
    gR, gt = m.poses(np.arange(90))
    good = dict(R=list(gR), t=list(gt + 1e-4), gt_R=gR, gt_t=gt)
    stuck = dict(R=[gR[0]] * 90, t=[gt[0]] * 90, gt_R=gR, gt_t=gt)
    missing = dict(R=list(gR[:80]), t=list(gt[:80]), gt_R=gR, gt_t=gt)
    assert judge.pose_numbers([good], GAP)["rot_axis_err"] < 1e-9
    # one stuck stream among sound ones is enough
    out = judge.pose_numbers([good] * 15 + [stuck], GAP)
    assert out["rot_axis_err"] == pytest.approx(1.0) and out["_rot_err_median"] < 1e-6
    assert out["_rot_err_worst"] == pytest.approx(1.0)
    out = judge.pose_numbers([missing], GAP)
    assert out["_poses_failed"] == 10 and out["rot_axis_err"] == float("inf")
    # the world frame does not matter: the same poses seen from a turned world
    W = render._rot((0.3, -0.2, 0.1))
    turned = dict(R=list(gR @ W.T), t=list(gt), gt_R=gR, gt_t=gt)
    assert judge.pose_numbers([turned], GAP)["rot_axis_err"] < 1e-9


def _scaled(R, f):
    """R's rotation about the same axis by f times the angle (Rodrigues)."""
    v = f * judge._rotvec(R[None])[0]
    a = np.linalg.norm(v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / max(a, 1e-300)
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def test_bench_pose_check_sees_a_wrong_angle_only_in_the_magnitude():
    """A stream whose turns are 30 % too large keeps its axes: the judged
    number stays near 0, the printed magnitude error reads 0.3."""
    m = render.motion_from(load("tum_vga_fleet", "staggered_xyz")[1], np.random.default_rng(3))
    gR, gt = m.poses(np.arange(90))
    big = np.stack([_scaled(R, 1.3) for R in gR])
    out = judge.pose_numbers([dict(R=list(big), t=list(gt), gt_R=gR, gt_t=gt)], GAP)
    assert out["rot_axis_err"] < 0.05 and 0.15 < out["_rot_err_worst"] < 0.45


def test_bench_pose_check_sees_another_cameras_motion():
    """A stream that returns the poses of another camera (as when its
    frames were replaced by another stream's) reads far above sound."""
    tr = load("tum_vga_fleet", "staggered_xyz")[1]
    mine = render.motion_from(tr, np.random.default_rng(4)).poses(np.arange(120))[0]
    other = render.motion_from(tr, np.random.default_rng(5)).poses(np.arange(120))
    out = judge.pose_numbers([dict(R=list(other[0]), t=list(other[1]), gt_R=mine, gt_t=other[1])], GAP)
    assert out["rot_axis_err"] > 0.5

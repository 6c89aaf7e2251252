#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 40] [--seed 0]

Phases (any failure exits non-zero and prints no result line):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the four hand-written kernels from the sources in
             cvsteer_tpu_torch/kernels/csrc (nvcc, sm_90a).
3. kernels — run each kernel's wrapper and its plain PyTorch version on the
             same inputs at the main path's shapes (a rendered 480x640
             frame, its 5-level pyramid, 256 keypoints per level); check
             the error against the stated tolerance; time both with CUDA
             events (median of 25 runs after warm-up).
4. VO      — render a textured multi-plane scene with known poses
             (numpy only, fx = fy = 500, cx = 320, cy = 240) and run the
             port's default-configuration VO on it through init_vo ->
             process_image -> finalize on the card, the loop of
             cvsteer_tpu_torch.cli_vo.main; check initialization, one pose
             per frame, the ATE against a bound derived from the scene's
             geometry, and that every kernel launched during the run.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

TOL_REL = 1e-5  # fp32 kernels vs their plain versions, relative to scale
TOL_PYR = 255 * 3e-5 + 1e-3  # cv2.pyrDown parity bar of the reference tests
TOL_ORIENT = 1e-4  # ct/st/dy/dx (unit scale)
MIN_KEEP_AGREE = 0.999  # p3 keep-mask agreement


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_kernels(frame):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns (records, ok)."""
    import torch

    from cvsteer_tpu_torch.features.descriptors import _rotated_grid_coords
    from cvsteer_tpu_torch.features.keypoints import detect_keypoints_packed
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.ops import cuda_desc as cd
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    bank = g2_bank()
    xt, yt = bank.xtaps, bank.ytaps
    img = torch.from_numpy(frame).cuda()[None].contiguous()  # [1, 480, 640]
    levels = [img]
    for _ in range(4):
        levels.append(cf.pyr_down_plain(levels[-1]).contiguous())
    shapes = [tuple(l.shape[-2:]) for l in levels]
    records, ok = [], True

    def record(name, src, replaces, err, tol, ms, plain_ms, **extra):
        nonlocal ok
        good = err <= tol and all(v for k, v in extra.items() if k.endswith("_ok"))
        ok &= good
        print(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per frame "
              f"{'' if good else 'FAILED'} {extra if extra else ''}")
        records.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
            **{k: v for k, v in extra.items() if not k.endswith("_ok")},
        ))

    # A: the G2/H2 bank (K=7, T=9) on every level
    err, scale = 0.0, 0.0
    for lv in levels:
        k = cf.filter_bank(lv, xt, yt)
        p = cf.filter_bank_plain(lv, xt, yt)
        err = max(err, (k - p).abs().max().item())
        scale = max(scale, p.abs().max().item())
    record(
        "filter_bank", "cvsteer_tpu_torch/kernels/csrc/filter_bank.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:142 filter_bank_pallas (+ :1311 bank_tiled_pallas)",
        err, TOL_REL * scale,
        sum(cuda_ms(lambda lv=lv: cf.filter_bank(lv, xt, yt)) for lv in levels),
        sum(cuda_ms(lambda lv=lv: cf.filter_bank_plain(lv, xt, yt)) for lv in levels),
        shapes=shapes,
    )

    # B: pyramid down, the 4 steps of the 5-level pyramid
    err = max(
        (cf.pyr_down(lv) - cf.pyr_down_plain(lv)).abs().max().item() for lv in levels[:-1]
    )
    record(
        "pyr_down", "cvsteer_tpu_torch/kernels/csrc/pyr_down.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:1461 pyr_down_pallas",
        err, TOL_PYR,
        sum(cuda_ms(lambda lv=lv: cf.pyr_down(lv)) for lv in levels[:-1]),
        sum(cuda_ms(lambda lv=lv: cf.pyr_down_plain(lv)) for lv in levels[:-1]),
    )

    # C: the per-level detector maps on all 5 levels
    err, basis_rel, agree, off_ok = 0.0, 0.0, 1.0, True
    per_level_out = []
    for lv in levels:
        ko = cf.g2_features_full(lv, xt, yt, threshold=1.0, nms_radius=2)
        po = cf.g2_features_full_plain(lv, xt, yt, threshold=1.0, nms_radius=2)
        per_level_out.append(ko)
        for km, pm in zip(ko[1:5], po[1:5]):  # dy, dx, ct, st
            err = max(err, (km - pm).abs().max().item())
        basis_rel = max(
            basis_rel, (ko[5] - po[5]).abs().max().item() / max(po[5].abs().max().item(), 1e-30)
        )
        sent = cf.P3_SENTINEL * 0.5
        kk, pk = ko[0] > sent, po[0] > sent
        agree = min(agree, (kk == pk).float().mean().item())
        both = kk & pk
        off_ok &= bool(
            ((ko[0].view(torch.int32) & 15)[both] == (po[0].view(torch.int32) & 15)[both]).all()
        )
    record(
        "g2_features_full", "cvsteer_tpu_torch/kernels/csrc/g2_features.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:1122 g2_features_full_pallas",
        err, TOL_ORIENT,
        sum(cuda_ms(lambda lv=lv: cf.g2_features_full(lv, xt, yt, threshold=1.0)) for lv in levels),
        sum(cuda_ms(lambda lv=lv: cf.g2_features_full_plain(lv, xt, yt, threshold=1.0))
            for lv in levels),
        basis_rel_err=basis_rel, basis_ok=basis_rel <= TOL_REL,
        p3_keep_agreement=agree, keep_ok=agree >= MIN_KEEP_AGREE, offsets_ok=off_ok,
    )

    # D: descriptor sampling at each level's 256 detected keypoints
    err, scale, calls = 0.0, 0.0, []
    for p3, dy, dx, ct, st, basis in per_level_out:
        kp = detect_keypoints_packed(p3, dy, dx, ct, st, max_keypoints=256)
        ys, xs, _, _ = _rotated_grid_coords(kp, 4, 3.0)
        ys, xs = ys.contiguous(), xs.contiguous()
        k = cd.sample_patches(basis, ys, xs)
        p = cd.sample_patches_plain(basis, ys, xs)
        err = max(err, (k - p).abs().max().item())
        scale = max(scale, p.abs().max().item())
        calls.append((basis, ys, xs))
    record(
        "desc_sample", "cvsteer_tpu_torch/kernels/csrc/desc_sample.cu",
        "cvsteer_tpu/ops/pallas_desc.py:211 bilinear_sample_patch_dma (kernel :148 sample_patches_pallas)",
        err, TOL_REL * scale,
        sum(cuda_ms(lambda c=c: cd.sample_patches(*c)) for c in calls),
        sum(cuda_ms(lambda c=c: cd.sample_patches_plain(*c)) for c in calls),
        keypoints=[256] * len(calls),
    )
    return records, ok


def ate_bound(seq, state, cfg) -> dict:
    """The ATE gate, derived as in tests/test_cli_vo.py (not a reported
    number): per keyframe hop the monocular depth-direction error is
    sigma_px / f * Z^2 / (B_kf * sqrt(N_lm)), with sigma_px = 1 px corner
    localization, Z the scene's median depth, B_kf the ground-truth
    baseline of one keyframe gap (kf_max_gap frames) and N_lm ~ 100
    landmarks per solve; drift random-walks over the (frames - 1) /
    kf_max_gap hops and is gated at 3 sigma. Every input comes from the
    scene and the configuration, none from the run. Frames before the
    two-view initialization hold the first pose by design, so their
    ground-truth offset from it adds in quadrature to the RMS."""
    import numpy as np

    from cvsteer_tpu_torch.slam.evaluate import camera_centers

    sigma_px, N_lm = 1.0, 100.0
    gR, gt = seq.gt_arrays()
    centers = camera_centers(gR, gt)
    depth = seq.depth(0)
    Z = float(np.median(depth[np.isfinite(depth)]))
    step = float(np.median(np.linalg.norm(np.diff(centers, axis=0), axis=1)))
    B_kf = step * cfg.kf_max_gap
    hops = (len(centers) - 1) / cfg.kf_max_gap
    per_hop = sigma_px / cfg.intrinsics.fx * Z**2 / (B_kf * math.sqrt(N_lm))
    track = 3.0 * math.sqrt(hops) * per_hop
    kf_idx = sorted({kf.index for kf in state.keyframes})
    init_frame = min((i for i in kf_idx if i > 0), default=len(centers))
    hold = np.linalg.norm(centers[:init_frame] - centers[0], axis=1)
    bound = math.sqrt(track**2 + float((hold**2).sum()) / len(centers))
    return dict(bound=bound, Z=Z, B_kf=B_kf, N_lm=N_lm, hops=hops, init_frame=init_frame)


def run_vo(n_frames: int, seed: int):
    """Phase 4: the port's default VO on the rendered scene, on the card."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse
    from cvsteer_tpu_torch.slam.vo import VOConfig, finalize, init_vo, process_image
    from cvsteer_tpu_torch.utils.metrics import StepTimer

    cfg = VOConfig()  # default: 500/500/320/240, 5 levels x 256, window 8
    K = cfg.intrinsics
    seq = PlanesSequence(n_frames=n_frames, image_hw=(480, 640), fx=K.fx, fy=K.fy,
                         cx=K.cx, cy=K.cy, seed=seed)
    state = init_vo(cfg, device="cuda")
    timer = StepTimer(sync=torch.cuda.synchronize)
    state.timer = timer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(n_frames):  # the loop of cli_vo.main
        with timer.span("decode"):
            img = seq.render(k)
        with timer.span("vo"):
            state = process_image(state, img)
    state = finalize(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    Rs, ts = state.poses()
    gR, gt = seq.gt_arrays()
    frames = [fi for fi, _, _ in state.trajectory]
    ate = ate_rmse(Rs, ts, gR[frames], gt[frames]) if len(frames) == n_frames else float("nan")
    gate = ate_bound(seq, state, cfg)
    return dict(
        state=state, launches=launches, ate=ate, gate=gate, wall_s=wall,
        vo_s=timer.total_s["vo"], means_ms=timer.means_ms(), frames=frames,
        finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import numpy as np  # noqa: F401
        import torch
    except ImportError as e:
        return _fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    try:
        from cvsteer_tpu_torch import kernels
    except ImportError as e:
        return _fail(f"run from the repository root: {e}")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        return _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")

    # 3. kernel checks (their launches are not the main path's)
    from cvsteer_tpu_torch.io.render import PlanesSequence

    frame = PlanesSequence(n_frames=1, seed=args.seed).render(0)
    records, ok = check_kernels(frame)
    if not ok:
        return _fail("a kernel disagrees with its plain version")

    # 4. main path
    res = run_vo(args.frames, args.seed)
    st, gate = res["state"], res["gate"]
    n = args.frames
    print(
        f"VO: {n} frames 480x640 in {res['vo_s']:.2f} s of VO time "
        f"({n / res['vo_s']:.2f} frames/s; {res['wall_s']:.2f} s wall incl. rendering); "
        f"keyframes {len(st.keyframes)}, landmarks {st.num_landmarks}"
    )
    print("phase ms (mean per call): " + json.dumps(
        {k: round(v, 3) for k, v in res["means_ms"].items()}
    ))
    print(f"ATE {res['ate']:.4f} m, bound {gate['bound']:.4f} m "
          f"(Z {gate['Z']:.2f} m, B_kf {gate['B_kf']:.3f} m, N_lm {gate['N_lm']:.0f}, "
          f"hops {gate['hops']:.1f}, init frame {gate['init_frame']})")
    print(f"launches in the VO run: {res['launches']}")
    checks = {
        "initialized": st.initialized,
        "one pose per frame": res["frames"] == list(range(n)),
        "finite poses": res["finite"],
        "ATE within bound": res["ate"] < gate["bound"],
        "every kernel launched": all(res["launches"][k] > 0 for k in kernels.KERNELS),
    }
    for what, good in checks.items():
        print(f"check {what}: {'ok' if good else 'FAILED'}")
    if not all(checks.values()):
        return _fail("VO run checks failed")

    for r in records:
        r["launches"] = res["launches"][r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

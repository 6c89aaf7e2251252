"""cvsteer-vo on PyTorch: monocular visual odometry over image sequences.

The port of cvsteer_tpu.cli_vo: run the steerable-front-end VO (keyframing
+ windowed Schur BA) over a TUM-RGBD sequence, a KITTI odometry sequence or
a plain image directory; report ATE RMSE when ground truth is present;
write the trajectory in TUM format; checkpoint and resume mid-sequence
with ``--checkpoint-dir`` (every ``checkpoint_every`` keyframes and at the
end; a second run on the same directory resumes at the saved frame).
``--engine host`` (the default) runs slam.vo; ``--engine device`` runs
slam.vo_device, the device-resident engine (two captured CUDA graphs per
frame on a card, the same steps eagerly with ``--device cpu``).

  python -m cvsteer_tpu_torch.cli_vo --input <seq_dir> --set slam.window=10 \
      --output traj.txt --engine device --device cuda

Serving: a comma-separated ``--input`` runs every sequence at once. Each
tick decodes the streams' images on a thread pool, extracts their features
in one batched call per image shape, and steps the server once:
slam.vo_server.VOServer with ``--engine host``, slam.vo_device.DeviceVOFleet
(two CUDA graphs over the stacked maps of all streams) with ``--engine
device``, pipelined one tick deep with ``--pipeline``. One trajectory file
(``traj.<i>.txt`` for ``--output traj.txt``) and one ATE line per stream,
then the aggregate frames/s. With ``--checkpoint-dir`` each stream keeps
its checkpoints in ``stream<i>/`` there, and a resumed stream skips the
ticks before its saved frame.

  python -m cvsteer_tpu_torch.cli_vo --input seqA,seqB,seqC --engine device \
      --pipeline --output traj.txt

``--verbose`` reports host times from the program's spans
(utils/profiling.py), without synchronizing the device: one stream, every
``log_every`` frames and at the end, each span name's mean ms (``cli.decode``,
``cli.vo``, ``cli.checkpoint`` and the spans inside them); serving, at the
end, each span name's self ms a tick and the ``fleet.step`` counts a tick.
Both also split ``fleet.wait`` by fetch, ``fleet.event`` by stream,
``features.level`` by level and ``features.extract`` by path.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cvsteer-vo-torch", description=__doc__)
    ap.add_argument("--input", required=True, help="sequence dir (TUM/KITTI/images)")
    ap.add_argument("--config", default="", help="EngineConfig JSON")
    ap.add_argument(
        "--camera-preset", default="",
        help="published calibration: tum_fr1 | tum_fr2 | tum_fr3 | kitti_gray",
    )
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--output", default="", help="trajectory output (TUM format)")
    ap.add_argument("--engine", choices=("host", "device"), default="host")
    ap.add_argument(
        "--pipeline", action="store_true",
        help="serving with --engine device: fetch one tick late (the pose "
        "prediction on the device); host mirrors update a tick late",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device for the VO steps (default: cuda; cpu runs the "
        "kernels' plain versions and must be asked for)",
    )
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    roots = [p for p in args.input.split(",") if p]
    if not roots:
        print("no input sequences given", file=sys.stderr)
        return 1
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    from cvsteer_tpu_torch.io.datasets import open_sequence
    from cvsteer_tpu_torch.io.imageio import imread_gray_f32
    from cvsteer_tpu_torch.slam.vo import finalize, init_vo, process_image
    from cvsteer_tpu_torch.utils.config import (
        EngineConfig,
        apply_camera_preset,
        apply_overrides,
        load_config,
    )
    from cvsteer_tpu_torch.utils.metrics import Metrics
    from cvsteer_tpu_torch.utils.profiling import annotate

    cfg = load_config(args.config) if args.config else EngineConfig()
    if args.camera_preset:
        cfg = apply_camera_preset(cfg, args.camera_preset)
    if args.set:
        cfg = apply_overrides(cfg, tuple(args.set))
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    if len(roots) > 1:
        return _run_server(args, cfg, roots)

    seq = open_sequence(roots[0], max_frames=args.max_frames or None)
    if not seq.image_paths:
        print("no images found", file=sys.stderr)
        return 1

    engine = None
    if args.engine == "device":
        from cvsteer_tpu_torch.slam.vo_device import DeviceVO

        engine = DeviceVO(vo_config(cfg), device=args.device)
        state = engine.state
    else:
        state = init_vo(vo_config(cfg), device=args.device)

    ckpt = None
    start = 0
    if cfg.checkpoint_dir:
        from cvsteer_tpu_torch.utils.checkpoint import SlamCheckpointer

        ckpt = SlamCheckpointer(cfg.checkpoint_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            if engine is not None:
                engine.adopt(state)
            start = state.frame_count
            if args.verbose:
                print(f"resumed at frame {start}", file=sys.stderr)

    metrics = Metrics()
    opened = time.time_ns()
    last_kf_count = len(state.keyframes)
    for k in range(start, len(seq.image_paths)):
        with annotate("cli.decode"):
            img = imread_gray_f32(seq.image_paths[k])
        if img is None:
            if args.verbose:
                print(f"skip unreadable: {seq.image_paths[k]}", file=sys.stderr)
            # keep frame ids aligned with the sequence index
            state.frame_count += 1
            continue
        with annotate("cli.vo"):
            if engine is not None:
                engine.process_image(img)
                state = engine.state
            else:
                state = process_image(state, img)
        metrics.frame()
        if len(state.keyframes) != last_kf_count:
            metrics.count("keyframes", len(state.keyframes) - last_kf_count)
            last_kf_count = len(state.keyframes)
            if ckpt is not None and cfg.checkpoint_every and (
                last_kf_count % cfg.checkpoint_every == 0
            ):
                with annotate("cli.checkpoint"):
                    if engine is not None:
                        engine.sync_host()  # a checkpoint needs the landmark positions
                    ckpt.save(last_kf_count, state)
        if args.verbose and cfg.log_every and (k + 1) % cfg.log_every == 0:
            metrics.gauge("landmarks", state.num_landmarks)
            metrics.log(step=k + 1, **_span_means_ms(opened))

    state = engine.finalize() if engine is not None else finalize(state)
    if ckpt is not None:
        ckpt.save(len(state.keyframes), state)
        ckpt.close()

    if args.output:
        _write_trajectory(args.output, state, seq)
    ate, n_traj = _ate(state, seq)
    if ate is not None:
        print(f"ATE RMSE: {ate:.4f} m over {n_traj} frames")
    if args.verbose:
        print(
            f"frames/s: {metrics.fps:.2f}; keyframes: {len(state.keyframes)}; "
            f"landmarks: {state.num_landmarks}; span ms: {_span_means_ms(opened)}",
            file=sys.stderr,
        )
    return 0


#: the span attribute --verbose also splits a span name's time by, as
#: ``name[attr=value]``: which fetch the host waited on, which stream's event
#: path ran, which pyramid level, which extraction path
_SPLIT = {"fleet.wait": "fetch", "fleet.event": "stream", "features.level": "level",
          "features.extract": "path"}


def _labels(s) -> tuple:
    """A span's name and, for the names in _SPLIT, ``name[attr=value]``
    (the fused path's one ``features.level`` has no level)."""
    k = _SPLIT.get(s.name)
    return (s.name, f"{s.name}[{k}={s.attrs[k]}]") if k in s.attrs else (s.name,)


def _span_means_ms(since_ns: int) -> dict:
    """Each program span label's mean ms (_labels) over the spans the ring
    holds that opened since ``since_ns``."""
    from cvsteer_tpu_torch.utils import profiling

    total, n = collections.defaultdict(float), collections.Counter()
    for s in profiling.spans():
        if s.start_ns >= since_ns:
            for label in _labels(s):
                total[label] += (s.end_ns - s.start_ns) / 1e6
                n[label] += 1
    return {k: round(v / n[k], 3) for k, v in total.items()}


def _print_tick_spans(since_ns: int) -> None:
    """Serving's --verbose report: each span label's self ms a tick
    (_labels), and the fleet.step counts a tick, over the whole ticks
    (``cli.tick``) the ring holds that opened since ``since_ns``."""
    from cvsteer_tpu_torch.utils import profiling

    rec = [s for s in profiling.spans() if s.start_ns >= since_ns]
    ticks = [s for s in rec if s.name == "cli.tick"]
    if not ticks:
        return
    rec = [s for s in rec if s.index >= ticks[0].index]
    own = sorted(profiling.self_ms(rec, _labels).items())
    print(f"span self ms a tick over {len(ticks)} ticks: "
          + ", ".join(f"{k} {v / len(ticks):.3f}" for k, v in own), file=sys.stderr)
    steps = [s for s in rec if s.name == "fleet.step"]
    if steps:
        keys = ("stepped", "bootstrapped", "fp_rows", "promoted", "event_paths")
        print("fleet.step counts a tick: " + ", ".join(
            f"{k} {sum(s.attrs[k] for s in steps) / len(steps):.2f}" for k in keys), file=sys.stderr)


def vo_config(cfg):
    """EngineConfig -> slam.vo.VOConfig (the reference CLI's mapping)."""
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.slam.vo import VOConfig

    return VOConfig(
        intrinsics=Intrinsics(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
            dist=(cfg.camera.k1, cfg.camera.k2, cfg.camera.p1, cfg.camera.p2, cfg.camera.k3),
        ),
        frontend=FrontendConfig(
            levels=cfg.frontend.levels,
            keypoints_per_level=cfg.frontend.keypoints_per_level,
            nms_radius=cfg.frontend.nms_radius,
            threshold=cfg.frontend.threshold,
            descriptor_grid=cfg.frontend.descriptor_grid,
            descriptor_spacing=cfg.frontend.descriptor_spacing,
            order=cfg.frontend.order,
        ),
        match_ratio=cfg.slam.match_ratio,
        min_parallax=cfg.slam.min_parallax,
        init_min_inliers=cfg.slam.init_min_inliers,
        track_min_landmarks=cfg.slam.track_min_landmarks,
        kf_max_gap=cfg.slam.kf_max_gap,
        window=cfg.slam.window,
        ba_iterations=cfg.slam.ba_iterations,
        huber_delta=cfg.slam.huber_delta,
        ransac_hypotheses=cfg.slam.ransac_hypotheses,
        ransac_threshold=cfg.slam.ransac_threshold,
        max_landmarks=cfg.slam.max_landmarks,
        loop_closure=cfg.slam.loop_closure,
        loop_closure_sim3=cfg.slam.loop_closure_sim3,
        loop_min_gap=cfg.slam.loop_min_gap,
        loop_min_inliers=cfg.slam.loop_min_inliers,
        loop_robust_delta=cfg.slam.loop_robust_delta,
        kf_min_flow_px=cfg.slam.kf_min_flow_px,
        loop_consistency=cfg.slam.loop_consistency,
        loop_reject_cooldown=cfg.slam.loop_reject_cooldown,
        ground_height_m=cfg.slam.ground_height_m,
        speed_prior_band=(cfg.slam.speed_prior_lo, cfg.slam.speed_prior_hi),
        motion_model=cfg.slam.motion_model,
        track_local_map=cfg.slam.track_local_map,
    )


def _write_trajectory(path: str, state, seq) -> None:
    """TUM format: t tx ty tz qx qy qz qw (camera->world)."""
    with open(path, "w") as f:
        for (fi, R, t) in state.trajectory:
            Rwc = R.T
            c = -Rwc @ t
            q = _rot_to_quat(Rwc)
            stamp = seq.timestamps[fi] if fi < len(seq.timestamps) else fi
            f.write(
                f"{stamp:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def _ate(state, seq):
    """(ate_rmse or None, #trajectory frames) vs the sequence ground truth."""
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse

    if seq.gt_R is None or len(state.trajectory) < 3:
        return None, len(state.trajectory)
    Rs, ts = state.poses()
    frames = [fi for fi, _, _ in state.trajectory]
    return ate_rmse(Rs, ts, seq.gt_R[frames], seq.gt_t[frames]), len(frames)


def _stream_output_path(base: str, k: int) -> str:
    import os

    root, ext = os.path.splitext(base)
    return f"{root}.{k}{ext or '.txt'}"


def _run_server(args, cfg, roots) -> int:
    """Serving: every sequence of ``roots`` stepped at once. Per tick: the
    streams' images decoded on a thread pool, one batched extract_features
    per distinct image shape (the batch padded to the group's running
    size), then one ``step`` of the server. An unreadable frame advances
    its own stream's frame counter, so trajectory rows stay aligned with
    the ground truth. With a checkpoint directory each stream restores from
    and saves to its ``stream<i>`` subdirectory; a resumed stream skips the
    ticks before its restored frame count (a fleet engine adopts the state,
    and its row enters the stack at its first tick, by ``copy_``)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.io.datasets import open_sequence
    from cvsteer_tpu_torch.io.imageio import imread_gray_f32
    from cvsteer_tpu_torch.utils.profiling import annotate

    vo_cfg = vo_config(cfg)
    seqs = [open_sequence(r, max_frames=args.max_frames or None) for r in roots]
    for r, s in zip(roots, seqs):
        if not s.image_paths:
            print(f"no images found in {r}", file=sys.stderr)
            return 1
    n = len(seqs)
    if args.engine == "device":
        from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

        srv = DeviceVOFleet(vo_cfg, n_streams=n, pipeline=args.pipeline, device=args.device)
    else:
        from cvsteer_tpu_torch.slam.vo_server import VOServer

        srv = VOServer(vo_cfg, n_streams=n, device=args.device)
    engines = srv.engines if args.engine == "device" else None
    ckpts = [None] * n
    start = [0] * n
    if cfg.checkpoint_dir:
        from cvsteer_tpu_torch.utils.checkpoint import SlamCheckpointer

        for i in range(n):
            ckpts[i] = SlamCheckpointer(os.path.join(cfg.checkpoint_dir, f"stream{i}"))
            if ckpts[i].latest_step() is not None:
                restored = ckpts[i].restore(srv.states[i])
                if engines is not None:
                    engines[i].adopt(restored)
                else:
                    srv.states[i] = restored
                start[i] = restored.frame_count
                if args.verbose:
                    print(f"stream {i}: resumed at frame {start[i]}", file=sys.stderr)
    last_kf = [len(st.keyframes) for st in srv.states]
    dev = torch.device(args.device)
    n_ticks = max(len(s.image_paths) for s in seqs)
    frames_done = 0
    group_pad = {}  # image shape -> the group's running batch size
    with ThreadPoolExecutor(max_workers=min(8, n)) as pool:
        t0 = time.perf_counter()
        opened = time.time_ns()
        for k in range(n_ticks):
            with annotate("cli.tick"):
                paths = [s.image_paths[k] if start[i] <= k < len(s.image_paths) else None
                         for i, s in enumerate(seqs)]
                with annotate("cli.decode"):
                    imgs = list(pool.map(lambda p: imread_gray_f32(p) if p else None, paths))
                frames = [None] * n
                by_shape = {}
                for i, im in enumerate(imgs):
                    if im is not None:
                        by_shape.setdefault(im.shape, []).append(i)
                for shape, idxs in by_shape.items():
                    gp = group_pad[shape] = max(group_pad.get(shape, 0), len(idxs))
                    stack = np.zeros((gp,) + shape, np.float32)
                    for slot, i in enumerate(idxs):
                        stack[slot] = imgs[i]
                    batch = extract_features(_to_device(stack, dev), cfg=vo_cfg.frontend)
                    for slot, i in enumerate(idxs):
                        frames[i] = Features(*(x[slot] for x in batch))
                    frames_done += len(idxs)
                srv.step(frames)  # also with no frame: a pipelined server drains
                for i, im in enumerate(imgs):
                    if paths[i] is not None and im is None:
                        if args.verbose:
                            print(f"skip unreadable: {paths[i]}", file=sys.stderr)
                        srv.states[i].frame_count += 1
                for i, st in enumerate(srv.states):
                    nk = len(st.keyframes)
                    if nk != last_kf[i]:
                        last_kf[i] = nk
                        if ckpts[i] is not None and cfg.checkpoint_every and (
                            nk % cfg.checkpoint_every == 0
                        ):
                            # a checkpoint needs the landmark positions
                            ckpts[i].save(nk, srv.sync_host(i) if engines is not None else st)
        if args.verbose:
            _print_tick_spans(opened)
        states = [srv.finalize(i) for i in range(n)]
        for ck, st in zip(ckpts, states):
            if ck is not None:
                ck.save(len(st.keyframes), st)
                ck.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0

    for i, (root, seq, st) in enumerate(zip(roots, seqs, states)):
        if args.output:
            _write_trajectory(_stream_output_path(args.output, i), st, seq)
        ate, n_traj = _ate(st, seq)
        tag = f"stream {i} ({root})"
        if ate is not None:
            print(f"{tag}: ATE RMSE {ate:.4f} m over {n_traj} frames")
        elif args.verbose:
            print(f"{tag}: {n_traj} frames (no ground truth)", file=sys.stderr)
    print(
        f"served {frames_done} frames over {n} streams in {dt:.1f}s "
        f"({frames_done / max(dt, 1e-9):.2f} frames/s aggregate)",
        file=sys.stdout if args.verbose else sys.stderr,
    )
    return 0


def _to_device(a, dev):
    """A numpy array on ``dev`` through pinned memory on a card: a copy from
    pageable memory would make the host wait for the device's queued work
    (the pipelined fleet's tick in flight)."""
    import torch

    t = torch.from_numpy(a)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _rot_to_quat(R):
    """3x3 -> (qx, qy, qz, qw)."""
    import numpy as np

    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (R[2, 1] - R[1, 2]) * s
        y = (R[0, 2] - R[2, 0]) * s
        z = (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q[0], q[1], q[2], q[3]
    return (x, y, z, w)


if __name__ == "__main__":
    raise SystemExit(main())

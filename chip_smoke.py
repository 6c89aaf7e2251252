#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 40] [--seed 0]

Phases (any failure exits non-zero and prints no result line):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the hand-written kernels from the sources in
             cvsteer_tpu_torch/kernels/csrc (one nvcc per source, all
             started together, sm_90a) and load them.
3. inputs  — render the scenes (numpy only): a 480x640 frame and 64 frames
             at 512x512 (written as 8-bit PNGs for the CLI); read the
             committed 185x256 fish image.
4. kernels — run each kernel's wrapper and its plain PyTorch version on the
             same inputs at its path's shapes; check the error against the
             stated tolerance (B, C, D, E′ and F: bit for bit); time kernel, plain
             version and, where one PyTorch call computes the same function,
             that call, two ways: device_ms, the device time of 25 calls
             inside torch.profiler over 25 (a window padded with idle time
             that must see every launch), and call_ms, CUDA events around
             one call on an idle card (median of 25: what a caller that
             waits pays, host work included); compute each kernel's bound
             from the shapes. Kernel A is also timed with the G4/H4 bank,
             the pyramid path's other bank (g4_bank_* fields).
5. VO      — the port's default-configuration VO on a rendered scene with
             known poses (fx = fy = 500, cx = 320, cy = 240) through init_vo
             -> process_image -> finalize, the loop of
             cvsteer_tpu_torch.cli_vo.main; check initialization, one pose
             per frame, the ATE against a bound derived from the scene's
             geometry, and the front-end's launches per frame (B 1, C 1,
             D 1, A 0); then a second run profiled over 5 warm frames:
             device kernels per frame, device busy share, features span.
5b. VO device — the same 40 frames through the device-resident engine,
             cvsteer_tpu_torch.slam.vo_device.DeviceVO(VOConfig(),
             device="cuda").process_image (the loop of cli_vo --engine
             device; phase 5's frames, no decode span); check
             initialization, one pose per frame, the ATE against the same
             bound and within 0.01 m of phase 5's ATE, the trajectory
             within 0.03 m of the host engine's (Sim(3)-aligned), the host
             engine's poses (1e-4 m) on every frame before the first
             promotion on the device, B, C, D one launch per frame, and exactly 2 CUDA
             graphs captured, none after the first upload; print frames/s,
             the features / track / keyframe / capture spans, the device ms
             of one replay of T (track) and of P (promote) (device_ms over
             25 replays, each held to the device events of one eager run of
             its half), and the same profiled window as phase 5 for this
             engine, each graph launch in it held to T's or P's count.
    chunks — the same 40 frames through DeviceVO.issue_chunk /
             complete_chunk, CHUNK (8) frames a chunk, each chunk's
             features from one batched extract_features: keyframes and
             poses against the sequential DeviceVO fed the same feature
             rows (1e-5 m; bit for bit expected), 3 graphs (T, P and the
             chunk graph C), one fetch per chunk, B, C, D once per batched
             front-end call (one a chunk); frames/s and C's device ms per
             replay beside T's and P's.
5c. serving — eight streams at the default VOConfig: (a) kernels B, C, D
             bit for bit against their plain versions on an [8, 480, 640]
             stack of eight PlanesSequence seeds' first frames
             (frontend_agreement); (b) the eight sequences (seeds 0-7, 40
             frames, fx = fy = 500) written as TUM directories (PNG frames,
             rgb.txt, groundtruth.txt) by spawned processes, then
             cvsteer_tpu_torch.cli_vo.main on all eight with --engine device
             (the classic DeviceVOFleet) and with --engine device --pipeline;
             each stream's camera centers within 0.03 m of a single-stream
             DeviceVO's on the same frames until that DeviceVO's first
             promotion after initialization (past it the window BA carries
             the batch's float32 rounding much further: the whole
             trajectories' distance is printed), its ATE under its
             ate_bound wherever that DeviceVO's is, B, C, D once per tick;
             then the batch axis alone: seed 0's stream through a 1-stream
             fleet equal to a DeviceVO's bit for bit, and eight copies of it
             through an 8-stream fleet giving eight equal rows; (c) the
             library paths timed on the same frames (one batched
             extract_features and one step a tick): DeviceVOServer (its
             engines are (b)'s single-stream DeviceVOs), the classic fleet,
             the pipelined fleet (promote_cap 2) and VOServer (20 frames):
             aggregate frames/s, per-stream ATE, peak allocator memory,
             device kernels and busy share over 5 warm ticks; the fleets'
             graphs FT and FP (device ms and events per replay), 2 captures
             each and none by their engines. Then checkpoints: cli_vo
             --engine device --checkpoint-dir with checkpoint_every 1 on
             seed 0's sequence alone and on all eight (the classic fleet),
             each run twice on one directory: the second run writes the
             first run's trajectory files; B, C, D once per frame (tick)
             each run stepped; each save is timed. From here
             through phase 6 the PNG codec's decodes are counted.
6. CLI     — cvsteer_tpu_torch.cli.main on a list of the 64 frames and one
             unreadable entry, with --filters g2 and then g4 (default
             --batch 16): 192 PNGs per run, each within 1 gray level of the
             plain path's 8-bit maps on the card with >= 99.9 % of pixels
             equal, and the maps kernel launched; then the fish image
             against the decoded goldens (mean L1 <= 2.5, the reference's
             no-recode bar). Prints images/s, and that the frames of
             phases 5c and 6 decoded through io.native_codec (built from
             io/native/codec.c at first use).
10. features — extract_features on bench.py's g4_feature input (32 frames
             of 480x640, uniform in [0, 255) from default_rng(7)) at order
             4 (kernel D′ at 11 channels) and at order 2 with the
             'strength' score: launches per call (B′ 1, A 5, D′ 1), the
             whole Features equal to the path with every kernel replaced
             by its plain version (plain_kernels), A at every level, B′ and
             D′ bit for bit against their plain versions, frames/s (median
             of FEAT_REPS warm calls) and A's, B′'s and D′'s device ms per
             frame; (b) the same checks on phase 5's first frame at the
             order-4 VO path's shapes ([1, 480, 640]: A at every level, B′,
             D′ at C = 11, Features, launches), then DeviceVO with
             frontend.order = 4 on phase 5's frames: initialized, one finite
             pose per frame, 2 graphs, A 5, B′ 1, D′ 1 launches per frame,
             frames/s, the ATE printed beside ate_bound (not gated).
7. pyramid — steerable_pyramid_maps (5 levels, G2 and G4) on the 480x640
             frame against the same maps from the plain versions of the
             kernels, and d sum(basis^2) / d image through g2_basis and
             g4_basis against autograd through the plain bank; kernels A, B
             and F launched (A's launch count in the JSON line is this
             phase's).
9. loop    — (a) a deterministic closure on the synthetic feature world of
             tests/test_loopclosure.py (built here with numpy): a 13-keyframe
             circle that revisits its start with injected SE(3) drift through
             loopclosure.close_loops (dense solver) on the card, then the
             host engine (init_vo -> process_frame) around a 48-frame circle,
             injected scale drift, close_loops_sim3 against close_loops on
             copies of the drifted state; check >= 1 closure accepted, the
             newest keyframe's rotation error halved and translation error cut
             by 15 % (SE(3)), the keyframe ATE at least halved and Sim(3) better
             than SE(3) on scale drift. (b) the campaign configuration of
             scripts/slam_scale_run.py (Sim(3) closure, ground prior 1.5 m,
             speed band (0.5, 2.0), window 12, 262,144 landmark slots) on
             io.synth.CityLoop cut to a 40 m circuit and LOOP_FRAMES frames
             (one lap ~754 frames, so the run revisits its start) through
             DeviceVO(cfg, device="cuda").process_image, and the host engine
             on its first LOOP_HOST_FRAMES frames; print frames/s, ATE
             against ate_bound, keyframes, ground corrections, speed clamps,
             closure events (attempted, accepted, sync and solve ms each),
             captures, peak allocator memory, launches of B, C and D; check 2
             graphs at the end, the ATE under its bound, B, C, D launched and
             >= 1 ground correction (both engines), and B, C and D bit for bit
             against their plain versions on the sequence's first frame at
             this path's shapes (240x320 down to 15x20, upright descriptors:
             phase 4's comparisons, frontend_agreement).
8. probes  — each module of cvsteer_tpu_torch.probes (the port of the TPU
             probe scripts) walks its path once untimed at its script's
             shapes (the probes' paths, whose launches are counted), then
             measures once; then kernels G (rows, patches), S and V bit for
             bit and M within its stated tolerance against their plain
             versions, at those shapes and ragged ones, timed as in phase 4.
11. mesh   — the mesh paths (cvsteer_tpu_torch.parallel) in worlds spawned
             on this one card, the kernels built first: a 2-rank gloo world
             on cuda:0 (the collectives staged through the host) and a
             1-rank NCCL world, each running sharded_g2_maps /
             sharded_g4_maps on 16x512x512 over {space: W} and {data: W}
             (against steerable_pipeline_g2 / _g4 on the card with every
             kernel replaced by its plain version, at the reference's bars),
             sharded_extract_features on 8x480x640 over {space: W} at orders
             2 and 4 (against the single-device generic path with every
             kernel plain: valid masks equal, fields within 1e-5; bit-equality
             with the kernel-backed single-device calls printed), each timed
             (host clock, median of MESH_REPS) beside the kernel-backed
             single-device call timed the same way, with the staged-transport
             share and the launches of one call on each rank, and cli.main
             --mesh space=W in the world (E/E4 launch only for the batch that
             skips the mesh); then torchrun --nproc-per-node 2 -m
             cvsteer_tpu_torch.cli --mesh space=2 on 16 of phase 6's PNGs and
             the fish: every PNG equal to the plain fp32 pipeline quantized,
             within 2 levels and 99.9 % within 1 of the unsharded CLI's bf16
             maps, the fish's skip line. The ranks share one card: no figure
             of this phase is a multi-card figure.
12. mesh solvers, fleet, runtime — in phase 11's two worlds, after it:
             (a) bundle_adjust_sharded with C = 8 cameras and L = 65,536
             landmarks (ba_world: tests/test_ba.py's scene in numpy) over
             {data: W}, 10 LM iterations, against bundle_adjust on the card
             (rotation < 1e-3 rad, t within 1e-3; the 1-rank world bit for
             bit), the collectives per rank from parallel.halo's log
             exactly one packed all-reduce of C^2 36 + C 36 + 2 C 6 floats
             per LM iteration and one scalar per cost, and one all-gather
             of X after the loop; (b) optimize_pose_graph_sharded on a
             circle of 4,541 poses (KITTI 00's length) with its chain and
             ~2 P random closures, PCG 20 x 50, against the single-device
             PCG (cost <= 1.05x, rotation < 2e-3 rad; 1 rank: bit for bit),
             collectives exactly (b, D) once per LM iteration, Hv once per
             CG iteration, one scalar per cost; both timed per LM iteration
             on the host clock beside the single device with the staged
             share; (c) phase 5c's eight sequences through each rank's
             extract_features on its [8/W, 480, 640] batch (B′, C′, D′ bit
             for bit against plain there, then once a tick a rank) and
             DeviceVOFleet(mesh=) classic and pipelined (promote_cap 2),
             each beside the unsharded fleet in the same world: 2 captures
             a rank, the 1-rank fleet equal to the unsharded one bit for
             bit, on 2 ranks each stream within 0.03 m of its single-stream
             DeviceVO (phase 5c's) until its first promotion and its ATE
             under ate_bound where the unsharded stream's is, aggregate
             frames/s of both (host clock); (d) initialize_distributed,
             device_barrier (the rank count), allreduce_checksum (exact)
             and a Heartbeat's 2 beats. The ranks share one card: no
             figure of this phase is a multi-card figure.
Phases 10, 11 and 12 run after phase 6, then 7, 9 and 8.
Each path phase (5-10, 5b, the chunks, each cli_vo run of 5c and of the
checkpoints) sets the launch counts to 0 just before it and reads them just
after. The line before the last is the per-kernel JSON record;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TOL_REL = 1e-5  # fp32 kernels vs their plain versions, relative to scale
TOL_GRAD = 1e-3  # gradient vs autograd through the plain bank (the reference's bar)
MIN_U8_EQUAL = 0.999  # CLI maps equal to the plain path's 8-bit maps
GOLDEN_L1 = 2.5  # mean L1 vs the decoded goldens (tests/test_golden.py, no recode)

# NVIDIA H100 SXM data-sheet peaks at the 700 W limit: HBM3 bandwidth and
# the fp32 rate outside the tensor cores. A kernel's bound is the larger of
# its bytes (each input read once, each output written once) over the first
# and its flops over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores (kernel M)

CLI_FRAMES, CLI_HW, CLI_BATCH = 64, (512, 512), 16
MAPS = ("edges", "lines_dark", "lines_bright")
PATH_KERNELS = {  # phase -> the kernels its path must launch
    "vo": ("pyr_down", "g2_features_full", "desc_sample"),
    "vo_device": ("pyr_down", "g2_features_full", "desc_sample"),
    "cli_g2": ("g2_maps",),
    "cli_g4": ("g4_maps",),
    "pyramid": ("filter_bank", "pyr_down", "filter_bank_adj"),
    "probes": ("probe_gather_rows", "probe_gather_patches", "probe_maps_stages",
               "probe_maps_variants", "probe_maps_mma"),
    "loop": ("pyr_down", "g2_features_full", "desc_sample"),
    "loop_host": ("pyr_down", "g2_features_full", "desc_sample"),
    "serving": ("pyr_down", "g2_features_full", "desc_sample"),
    "features_g4": ("filter_bank", "pyr_down", "desc_sample"),
    "features_g2_strength": ("filter_bank", "pyr_down", "desc_sample"),
    "vo_g4": ("filter_bank", "pyr_down", "desc_sample"),
}
VO_LAUNCHES_PER_FRAME = {  # the VO front-end: one B, one C and one D per frame
    "filter_bank": 0, "pyr_down": 1, "g2_features_full": 1, "desc_sample": 1,
}
LAUNCHES_FROM = {  # kernel -> the phase whose launch count the JSON line reports
    "filter_bank": "pyramid", "pyr_down": "vo", "g2_features_full": "vo", "desc_sample": "vo",
    "g2_maps": "cli_g2", "g4_maps": "cli_g4", "filter_bank_adj": "pyramid",
    "g2_feature_maps": None,  # E′: no path in either package calls it
    **{k: "probes" for k in PATH_KERNELS["probes"]},
}
VO_PROFILE_WARM, VO_PROFILE_FRAMES = 10, 5
VO_TWIN_ATE = 0.01  # the device engine's ATE against the host engine's, m (tests/test_vo_device.py)
# the two engines' trajectories (Sim(3)-aligned), m: they read 0.0144 apart on
# an H100, the gap opening at the first window BA on the device (PERF.md §6)
VO_TWIN_GAP = 0.03
VO_SAME_POSE = 1e-4  # camera centers before the first device promotion: the same arithmetic, m
# phase 9 (b): CityLoop at its own image size, focal length, noise and speed
# per frame (~0.194 m), the circuit cut from 120 m to 40 m a side so that a
# lap (~754 frames) ends inside the run; the campaign ran 4,200 frames
LOOP_CITY = dict(n_frames=900, laps=1.2, side=40.0)
LOOP_FRAMES = 900
LOOP_HOST_FRAMES = 150
LOOP_RENDER_WORKERS = 6
# phase 5c: the reference's default fleet (n_streams 8) at the default
# VOConfig on eight rendered sequences; the pipelined fleet with
# FLEET_r05.json's S = 8 pipelined row's promote_cap
SERVE_STREAMS, SERVE_FRAMES, SERVE_HOST_FRAMES = 8, 40, 20
SERVE_PIPE_CAP = 2
SERVE_PROFILE_FROM, SERVE_PROFILE_TICKS = 10, 5  # profiled ticks; later ones are timed
SERVE_RENDER_WORKERS = 8
# phase 10: the reference benchmark's g4_feature cell (bench.py:316-322):
# 32 frames of 480x640, uniform in [0, 255) from default_rng(7)
FEAT_FRAMES, FEAT_HW, FEAT_SEED = 32, (480, 640), 7
FEAT_REPS = 7  # timed calls after warm-up; their median is the call time
FEAT_LAUNCHES_PER_CALL = {"filter_bank": 5, "pyr_down": 1, "desc_sample": 1}  # 5 levels
# phase 10 (b), DeviceVO at order 4: the generic front-end once per frame
VO_G4_LAUNCHES_PER_FRAME = {**FEAT_LAUNCHES_PER_CALL, "g2_features_full": 0}
CHUNK = 8  # phase 5b: frames per issue_chunk
CHUNK_SAME_POSE = 1e-5  # m: the chunk's poses against the sequential engine's
REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "cvsteer_tpu_torch", "io", "golden")


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def timings(kernel, names, per_call, plain, library=None, plain_reps=25) -> dict:
    """Device and call times (ms) of a kernel's wrapper, its plain version
    and, where there is one, the one-call library yardstick. Each of
    ``kernel``, ``plain`` and ``library`` is a list of calls that make up
    one unit of work (a frame's levels, a batch); ``per_call`` is the
    kernel launches of one call (the CUDA functions ``names``). A call time
    is the sum of the calls' medians, a device time that of the calls
    together. ``plain_reps``: calls per window of the plain version (its
    hundreds of small kernels per call make the profiler's windows slow).
    Every window must see each of its launches (device_ms raises
    otherwise), so the events-seen counts are exact."""
    from cvsteer_tpu_torch.utils.profiling import call_ms, device_ms

    run = lambda calls: (lambda: [c() for c in calls])  # noqa: E731
    dev, seen = device_ms(run(kernel), names, per_call * len(kernel))
    plain_dev, plain_seen = device_ms(run(plain), reps=plain_reps)
    t = dict(device_ms=dev, device_launches_per_unit=per_call * len(kernel),
             device_events_seen_per_unit=seen, call_ms=sum(map(call_ms, kernel)),
             plain_device_ms=plain_dev, plain_device_events_seen_per_unit=plain_seen,
             plain_call_ms=sum(call_ms(c, plain_reps) for c in plain),
             library_device_ms=None, library_call_ms=None)
    if library is not None:
        lib_dev, lib_seen = device_ms(run(library))
        t.update(library_device_ms=lib_dev, library_device_events_seen_per_unit=lib_seen,
                 library_call_ms=sum(map(call_ms, library)))
    # the contract's fields: kernel, plain and library times are device times
    t.update(ms=t["device_ms"], plain_ms=t["plain_device_ms"], library_ms=t["library_device_ms"])
    return t


class Bound:
    """The least time the card could take for a set of calls:
    max(bytes / HBM bandwidth, flops / fp32 peak) over their sums."""

    def __init__(self):
        self.nbytes = 0.0
        self.flops = 0.0

    def add(self, nbytes: float, flops: float) -> None:
        self.nbytes += nbytes
        self.flops += flops

    def fields(self) -> dict:
        b_ms = self.nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = self.flops / FP32_FLOPS_PER_S * 1e3
        return dict(bound_ms=max(b_ms, f_ms), bound_by="bytes" if b_ms >= f_ms else "operations",
                    bound_bytes=self.nbytes, bound_flops=self.flops)


def pass_flops(taps) -> int:
    """Least flops per output of one 1-D correlation pass: one multiply per
    non-zero tap, but one per mirrored pair of equal magnitude (a x + b y =
    a (x +- y) where |a| = |b|), and one add per non-zero tap but the
    first."""
    import numpy as np

    t = np.asarray(taps, np.float64)
    r = len(t) // 2
    mults = int(t[r] != 0)
    for k in range(1, r + 1):
        a, b = t[r - k], t[r + k]
        if a != 0 and b != 0 and np.isclose(abs(a), abs(b), rtol=1e-6, atol=0.0):
            mults += 1
        else:
            mults += int(a != 0) + int(b != 0)
    return mults + int((t != 0).sum()) - 1


def distinct_rows(taps) -> list:
    """Indices of the tap vectors that are not proportional to an earlier
    one (the reference's _dedup_xtaps test)."""
    import numpy as np

    unit = [v / v[np.argmax(np.abs(v))] for v in np.asarray(taps, np.float64)]
    keep = []
    for k, u in enumerate(unit):
        if not any(np.allclose(u, unit[j], rtol=1e-6, atol=1e-9) for j in keep):
            keep.append(k)
    return keep


def bank_flops(px: int, xtaps, ytaps) -> int:
    """Least flops of a separable bank over px outputs: one row pass per
    distinct (up to scale) x-tap vector, its scale absorbed by the column
    taps, then one column pass per filter, each at pass_flops."""
    rows = sum(pass_flops(xtaps[k]) for k in distinct_rows(xtaps))
    return px * (rows + sum(pass_flops(y) for y in ytaps))


def maps_tail_flops(order: int) -> int:
    """Flops per pixel of the maps tails, counted from the expressions of
    ops/cuda_frontend.py (selects not counted): G2 73 (sum and difference
    2, c2 17, c3 13, (u, v) 7, steering 29, maps 5); G4 57 outside the
    quadratic form ((u, v) 7, half-angle powers 7, steering 38, maps 5),
    plus a product, a multiply and an add per term of its list."""
    if order == 2:
        return 73
    from cvsteer_tpu_torch.ops.cuda_frontend import g4_live_terms

    return 57 + 3 * len(g4_live_terms())


def render_inputs(seed: int, workdir: str):
    """(480x640 frame, 64 8-bit 512x512 frames, their PNG paths, fish)."""
    import numpy as np

    from cvsteer_tpu_torch.io.imageio import imread_gray_f32, imwrite_u8
    from cvsteer_tpu_torch.io.render import PlanesSequence

    frame = PlanesSequence(n_frames=1, seed=seed).render(0)
    h, w = CLI_HW
    seq = PlanesSequence(n_frames=CLI_FRAMES, image_hw=CLI_HW, cx=w / 2, cy=h / 2, seed=seed)
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(seq.render, range(CLI_FRAMES)))
    frames_u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    paths = [os.path.join(workdir, f"frame{i:03d}.png") for i in range(CLI_FRAMES)]
    for p, f in zip(paths, frames_u8):
        imwrite_u8(p, f)
    fish = imread_gray_f32(os.path.join(GOLDEN_DIR, "fish.png"))
    if fish is None or fish.shape != (185, 256):
        raise RuntimeError("the committed fish image cvsteer_tpu_torch/io/golden/fish.png is unreadable")
    return frame, np.stack(frames_u8).astype(np.float32), paths, fish


def add_record(records, name, src, replaces, err, good, times, bound, **extra) -> bool:
    """Print one kernel's check and times and append its JSON record;
    returns whether it passed."""
    ms = lambda v: "none" if v is None else f"{v:.4f}"  # noqa: E731
    b = bound.fields()
    print(f"kernel {name}: max_abs_err {err:.3e} {'ok' if good else 'FAILED'}; device ms: "
          f"kernel {ms(times['device_ms'])} ({times['device_launches_per_unit']:g} launches, "
          f"{times['device_events_seen_per_unit']:g} seen), "
          f"plain {ms(times['plain_device_ms'])}, library {ms(times['library_device_ms'])}; "
          f"call ms: kernel {ms(times['call_ms'])}, plain {ms(times['plain_call_ms'])}, "
          f"library {ms(times['library_call_ms'])}; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) {extra if extra else ''}")
    records.append(dict(
        name=name, route="cuda", source=src, replaces=replaces, max_abs_err=err,
        **times, **b, **extra,
    ))
    return bool(good)


def diff(got, want):
    """Max abs difference and bit equality of two lists of tensors (p3's
    packed bits compare as its float values do)."""
    import torch

    e = max((a - b).abs().max().item() for a, b in zip(got, want))
    return e, all(torch.equal(a, b) for a, b in zip(got, want))


def frontend_agreement(img, fcfg, bank) -> dict:
    """Kernels B, C and D against their plain versions on one frame ``img
    [1, H, W]`` (float32, on the card), called as extract_features(cfg=fcfg)
    calls them: the whole pyramid in one B launch, every level's detector
    maps in one C launch, then every level's keypoints (fcfg's capacity per
    level, upright when fcfg.upright_desc) sampled in one D launch. Returns
    (max abs error, bit-equal) per kernel name, C's agreement on which
    pixels keep a keypoint, and the plain pyramid, the maps and D's inputs
    for the caller's timings."""
    import torch

    from cvsteer_tpu_torch.features.descriptors import _rotated_grid_coords
    from cvsteer_tpu_torch.features.keypoints import detect_keypoints_packed
    from cvsteer_tpu_torch.ops import cuda_desc as cd
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    xt, yt = bank.xtaps, bank.ytaps
    levels = [img]
    for _ in range(fcfg.levels - 1):
        levels.append(cf.pyr_down_plain(levels[-1]).contiguous())
    out = dict(levels=levels, pyr_down=diff(cf.pyr_down_levels(img, len(levels))[1:], levels[1:]))

    maps = cf.g2_features_levels(levels, xt, yt, threshold=fcfg.threshold,
                                 nms_radius=fcfg.nms_radius)
    err, bits, agree = 0.0, True, 1.0
    for lv, ko in zip(levels, maps):
        po = cf.g2_features_full_plain(lv, xt, yt, threshold=fcfg.threshold,
                                       nms_radius=fcfg.nms_radius)
        e, same = diff(ko, po)
        err, bits = max(err, e), bits and same
        sent = cf.P3_SENTINEL * 0.5
        agree = min(agree, ((ko[0] > sent) == (po[0] > sent)).float().mean().item())
    out.update(maps=maps, g2_features_full=(err, bits), p3_keep_agreement=agree)

    ys_l, xs_l = [], []
    for lvl, (p3, dy, dx, ct, st, _) in enumerate(maps):
        kp = detect_keypoints_packed(p3, dy, dx, ct, st, max_keypoints=fcfg.level_capacity(lvl))
        if fcfg.upright_desc:
            kp = kp._replace(theta=torch.zeros_like(kp.theta))
        ys, xs, _, _ = _rotated_grid_coords(kp, fcfg.descriptor_grid, fcfg.descriptor_spacing)
        ys_l.append(ys)
        xs_l.append(xs)
    counts = [y.shape[1] for y in ys_l]
    ys, xs = torch.cat(ys_l, 1).contiguous(), torch.cat(xs_l, 1).contiguous()
    bases = [m[5] for m in maps]
    out.update(bases=bases, ys=ys, xs=xs, counts=counts,
               desc_sample=diff([cd.sample_patches_levels(bases, ys, xs, counts)],
                                [cd.sample_patches_levels_plain(bases, ys, xs, counts)]))
    return out


def check_kernels(frame, frames512, fish):
    """Phase 4: each kernel against its plain version at its path's shapes.
    Returns (records, ok)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.ops import cuda_desc as cd
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.utils.precision import precise
    from cvsteer_tpu_torch.utils.profiling import call_ms, device_ms

    bank = g2_bank()
    xt, yt = bank.xtaps, bank.ytaps
    img = torch.from_numpy(frame).cuda()[None].contiguous()  # [1, 480, 640]
    # B, C and D against their plain versions on the VO path of this frame
    fe = frontend_agreement(img, FrontendConfig(), bank)
    levels, per_level_out = fe["levels"], fe["maps"]
    shapes = [tuple(l.shape[-2:]) for l in levels]
    records, ok = [], True

    def record(*args, **extra):
        nonlocal ok
        ok &= add_record(records, *args, **extra)

    def conv_bank(taps_x, taps_y, stride=1):
        """nn.Conv2d(padding_mode="reflect") with the outer-product weights:
        the one-call library yardstick for kernels A and B (TF32 off)."""
        K, T = taps_x.shape
        conv = torch.nn.Conv2d(1, K, T, stride=stride, padding=(T - 1) // 2,
                               padding_mode="reflect", bias=False).cuda()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(np.einsum("ku,kv->kuv", taps_y, taps_x)[:, None]))

        def call(x):
            with torch.no_grad(), precise():
                return conv(x[:, None])
        return call

    # A: the G2/H2 bank (K=7, T=9) on every level of the VO pyramid; beside
    # it, the pyramid path's other bank, G4/H4 (K=11, T=13), on the same levels
    g4 = g4_bank()
    err, scale, lib_err, bound = 0.0, 0.0, 0.0, Bound()
    err4, scale4 = 0.0, 0.0
    conv, conv4 = conv_bank(xt, yt), conv_bank(g4.xtaps, g4.ytaps)
    for lv in levels:
        k = cf.filter_bank(lv, xt, yt)
        p = cf.filter_bank_plain(lv, xt, yt)
        err = max(err, (k - p).abs().max().item())
        scale = max(scale, p.abs().max().item())
        lib_err = max(lib_err, (conv(lv) - p).abs().max().item())
        px = lv.numel()
        bound.add(px * 4 * (1 + 7), bank_flops(px, xt, yt))
        p = cf.filter_bank_plain(lv, g4.xtaps, g4.ytaps)
        err4 = max(err4, (cf.filter_bank(lv, g4.xtaps, g4.ytaps) - p).abs().max().item())
        scale4 = max(scale4, p.abs().max().item())
    g4_calls = [lambda lv=lv: cf.filter_bank(lv, g4.xtaps, g4.ytaps) for lv in levels]
    record(
        "filter_bank", "cvsteer_tpu_torch/kernels/csrc/filter_bank.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:142 filter_bank_pallas (+ :1311 bank_tiled_pallas)",
        err, err <= TOL_REL * scale and err4 <= TOL_REL * scale4,
        timings([lambda lv=lv: cf.filter_bank(lv, xt, yt) for lv in levels], ("filter_bank_kernel",), 1,
                [lambda lv=lv: cf.filter_bank_plain(lv, xt, yt) for lv in levels],
                [lambda lv=lv: conv(lv) for lv in levels]), bound,
        shapes=shapes, library_abs_err=lib_err, g4_bank_max_abs_err=err4,
        g4_bank_device_ms=device_ms(lambda: [c() for c in g4_calls], ("filter_bank_kernel",), len(levels))[0],
        g4_bank_call_ms=sum(map(call_ms, g4_calls)),
        g4_bank_library_device_ms=device_ms(lambda: [conv4(lv) for lv in levels])[0],
    )

    # B: the 5-level pyramid of the frame in one launch. Its bound: level 0
    # read once and levels 1-4 written once, and the flops of each step's
    # row pass at the even columns and column pass at the even rows
    b5 = cf._BINOMIAL5.reshape(1, -1)
    conv = conv_bank(b5, b5, stride=2)
    (err, bits), lib_err, bound = fe["pyr_down"], 0.0, Bound()
    bound.add(4 * img.numel(), 0)
    for lv, w in zip(levels[:-1], levels[1:]):
        lib_err = max(lib_err, (conv(lv)[:, 0] - w).abs().max().item())
        h, wd = lv.shape[-2:]
        ho, wo = -(-h // 2), -(-wd // 2)
        bound.add(4 * ho * wo, 9 * wo * (h + ho))
    record(
        "pyr_down", "cvsteer_tpu_torch/kernels/csrc/pyr_down.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:1461 pyr_down_pallas (call :1499)",
        err, bits,
        timings([lambda: cf.pyr_down_levels(img, len(levels))], ("pyr_down_kernel",), 1,
                [lambda lv=lv: cf.pyr_down_plain(lv) for lv in levels[:-1]],
                [lambda lv=lv: conv(lv) for lv in levels[:-1]]), bound,
        bit_equal=bits, levels_per_launch=len(levels), library_abs_err=lib_err,
    )

    # C: the detector maps of all 5 levels (basis included) in one launch.
    # Its flops: the bank, then ~70 for (score, ct, st), ~60 for the NMS
    # window, the packed 3x3 pool and the subpixel offsets.
    feats = lambda: cf.g2_features_levels(levels, xt, yt, threshold=1.0, nms_radius=2)  # noqa: E731
    (err, bits), agree, bound = fe["g2_features_full"], fe["p3_keep_agreement"], Bound()
    for lv in levels:
        px = lv.numel()
        bound.add(px * 4 * (1 + 7 + 5), bank_flops(px, xt, yt) + 130 * px)
    record(
        "g2_features_full", "cvsteer_tpu_torch/kernels/csrc/g2_features.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:1122 g2_features_full_pallas",
        err, bits and agree == 1.0,
        timings([feats], ("g2_features_kernel",), 1,
                [lambda lv=lv: cf.g2_features_full_plain(lv, xt, yt, threshold=1.0) for lv in levels]),
        bound, bit_equal=bits, p3_keep_agreement=agree, levels_per_launch=len(levels),
    )

    # D: descriptor sampling at the 256 detected keypoints of each level, all
    # levels in one launch; the library call is F.grid_sample per level on
    # the same (clipped) coordinates
    lib_err, grids, bound = 0.0, [], Bound()
    bases, ys, xs, counts = fe["bases"], fe["ys"], fe["xs"], fe["counts"]
    for basis, k0, k1 in zip(bases, np.cumsum([0, *counts[:-1]]), np.cumsum(counts)):
        ysl, xsl = ys[:, k0:k1], xs[:, k0:k1]
        h, w = basis.shape[-2:]
        grid = torch.stack([2 * xsl.clamp(0, w - 1) / max(w - 1, 1) - 1,
                            2 * ysl.clamp(0, h - 1) / max(h - 1, 1) - 1], -1)
        lib = F.grid_sample(basis, grid, mode="bilinear", padding_mode="border", align_corners=True)
        lib_err = max(lib_err, (lib.permute(0, 2, 3, 1) - cd.sample_patches_plain(basis, ysl, xsl))
                      .abs().max().item())
        grids.append((basis, grid))
        n_s, c = ysl.numel(), basis.shape[1]
        # coordinates in, 4 corner texels of C channels in, C samples out;
        # ~10 flops of coordinates per sample and 8 of lerps per channel
        bound.add(n_s * (8 + 16 * c + 4 * c), n_s * (10 + 8 * c))
    err, bits = fe["desc_sample"]
    record(
        "desc_sample", "cvsteer_tpu_torch/kernels/csrc/desc_sample.cu",
        "cvsteer_tpu/ops/pallas_desc.py:211 bilinear_sample_patch_dma (kernel :148 sample_patches_pallas)",
        err, bits,
        timings([lambda: cd.sample_patches_levels(bases, ys, xs, counts)], ("desc_sample_kernel",), 1,
                [lambda: cd.sample_patches_levels_plain(bases, ys, xs, counts)],
                [lambda g=g: F.grid_sample(g[0], g[1], mode="bilinear", padding_mode="border",
                                           align_corners=True) for g in grids]),
        bound, bit_equal=bits, keypoints=counts, library_abs_err=lib_err,
    )

    # E / E4: the fused maps at the CLI's batch (16x512x512, bf16 maps, the
    # timed shape), the VO frame size and the unaligned fish
    inputs = [torch.from_numpy(frames512[:CLI_BATCH]).cuda(), img,
              torch.from_numpy(fish).cuda()[None].contiguous()]
    for order, name, fn, plain, bk, repl in (
        (2, "g2_maps", cf.g2_maps, cf.g2_maps_plain, bank,
         "cvsteer_tpu/ops/pallas_frontend.py:946 g2_maps_tiled_pallas mode \"maps\" (call :1034; g2_maps_pallas :806)"),
        (4, "g4_maps", cf.g4_maps, cf.g4_maps_plain, g4,
         "cvsteer_tpu/ops/pallas_frontend.py:946 g2_maps_tiled_pallas mode \"g4maps\" (call :1034; g4_maps_pallas :868)"),
    ):
        err, rel, bits = 0.0, 0.0, True
        for x in inputs:
            for dtype in (torch.float32, torch.bfloat16):
                for km, pm in zip(fn(x, bk.xtaps, bk.ytaps, out_dtype=dtype),
                                  plain(x, bk.xtaps, bk.ytaps, out_dtype=dtype)):
                    e = (km.float() - pm.float()).abs().max().item()
                    err = max(err, e)
                    rel = max(rel, e / max(pm.float().abs().max().item(), 1e-30))
                    bits &= bool(torch.equal(km, pm))
        batch = inputs[0]
        px = batch.numel()
        bound = Bound()
        bound.add(px * (4 + 3 * 2), bank_flops(px, bk.xtaps, bk.ytaps) + px * maps_tail_flops(order))
        record(
            name, f"cvsteer_tpu_torch/kernels/csrc/{name}.cu", repl, err, rel <= TOL_REL,
            timings([lambda: fn(batch, bk.xtaps, bk.ytaps, out_dtype=torch.bfloat16)], ("maps_kernel",), 1,
                    [lambda: plain(batch, bk.xtaps, bk.ytaps, out_dtype=torch.bfloat16)]),
            bound, max_rel_err=rel, bit_equal=bits, timed_shape=list(batch.shape),
            device_ms_fp32_maps=device_ms(lambda: fn(batch, bk.xtaps, bk.ytaps), ("maps_kernel",), 1)[0],
            shapes=[list(x.shape) for x in inputs],
        )

    # E′: the fused feature maps (score, ct, st) at the CLI's batch (the
    # timed shape) and the VO frame; its bound: the image in, three fp32
    # maps out, the least bank work and the 74 flops of the feature tail
    # (counted from common.cuh's g2_feature_tail; selects not counted)
    plain_fm = lambda x: cf.g2_feature_maps_plain(cf.filter_bank_plain(x, xt, yt))  # noqa: E731
    err, bits = 0.0, True
    for x in inputs[:2]:
        e, same = diff(cf.g2_feature_maps(x, xt, yt), plain_fm(x))
        err, bits = max(err, e), bits and same
    batch = inputs[0]
    bound = Bound()
    bound.add(batch.numel() * (4 + 3 * 4), bank_flops(batch.numel(), xt, yt) + 74 * batch.numel())
    record(
        "g2_feature_maps", "cvsteer_tpu_torch/kernels/csrc/g2_feature_maps.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:881 g2_feature_maps_pallas (g2_maps_tiled_pallas :946 mode \"features\", call :1034)",
        err, bits,
        timings([lambda: cf.g2_feature_maps(batch, xt, yt)], ("maps_kernel",), 1, [lambda: plain_fm(batch)]),
        bound, bit_equal=bits, timed_shape=list(batch.shape), shapes=[list(x.shape) for x in inputs[:2]],
        device_ms_480x640=device_ms(lambda: cf.g2_feature_maps(img, xt, yt), ("maps_kernel",), 1)[0],
    )

    # F: the bank's adjoint with both banks at every shape, bit for bit;
    # timed at the gradient phase's 1x480x640 (one G2 and one G4 call)
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, bits, ag_rel, bound, timed, timed_plain = 0.0, True, 0.0, Bound(), [], []
    for bk in (bank, g4):
        K, T = bk.xtaps.shape
        for x in inputs:
            g = torch.randn(tuple(x.shape[:-2]) + (K,) + tuple(x.shape[-2:]), device="cuda",
                            generator=gen)
            k = cf.filter_bank_adjoint(g, bk.xtaps, bk.ytaps)
            p = cf.filter_bank_adjoint_plain(g, bk.xtaps, bk.ytaps)
            s = p.abs().max().item()
            err, bits = max(err, (k - p).abs().max().item()), bits and torch.equal(k, p)
            xr = x.clone().requires_grad_()
            (ref,) = torch.autograd.grad(cf.filter_bank_plain(xr, bk.xtaps, bk.ytaps), xr, g)
            ag_rel = max(ag_rel, (k - ref).abs().max().item() / s)
            if x is img:
                timed.append(lambda g=g, bk=bk: cf.filter_bank_adjoint(g, bk.xtaps, bk.ytaps))
                timed_plain.append(lambda g=g, bk=bk: cf.filter_bank_adjoint_plain(g, bk.xtaps, bk.ytaps))
                h, w = x.shape[-2:]
                bound.add(h * w * 4 * (K + 1), bank_flops((h + T - 1) * (w + T - 1), bk.xtaps, bk.ytaps))
    record(
        "filter_bank_adj", "cvsteer_tpu_torch/kernels/csrc/filter_bank_adj.cu",
        "cvsteer_tpu/ops/pallas_frontend.py:1224-1252 filter_bank_pallas_diff (custom VJP backward)",
        err, bits and ag_rel <= TOL_GRAD,
        timings(timed, ("adj_kernel",), 1, timed_plain), bound,
        bit_equal=bits, autograd_rel_err=ag_rel, timed_shape=list(img.shape),
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
    """Phase 5: the port's default VO on the rendered scene, on the card."""
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
    raw = []  # each frame's pose as tracked, before finalize re-anchors it
    images = []  # kept for phase 5b
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(n_frames):  # the loop of cli_vo.main
        with timer.span("decode"):
            img = seq.render(k)
        with timer.span("vo"):
            state = process_image(state, img)
        raw.append(state.trajectory[-1][1:])
        images.append(img)
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
        finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()), raw=raw, images=images,
    )


@functools.lru_cache(maxsize=None)
def _profile_frames(seed: int):
    """The profiled runs' frames: the default camera's scene over
    VO_PROFILE_WARM + VO_PROFILE_FRAMES frames, rendered once for both
    engines."""
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.vo import VOConfig

    K = VOConfig().intrinsics
    n = VO_PROFILE_WARM + VO_PROFILE_FRAMES
    seq = PlanesSequence(n_frames=n, image_hw=(480, 640), fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy,
                         seed=seed)
    with ThreadPoolExecutor(8) as pool:
        return tuple(pool.map(seq.render, range(n)))


def profile_vo(seed: int, engine: str = "host", graphs=()) -> dict:
    """The VO's device picture: a second run of the default VO (``engine``
    "host", slam.vo, or "device", slam.vo_device), warmed up over
    VO_PROFILE_WARM frames, then VO_PROFILE_FRAMES frames inside
    torch.profiler, a window that must see every launch and, for each graph
    launch, the events of one of ``graphs`` (T's and P's per replay; the
    host engine launches none). Returns device
    kernels and copies/memsets per frame, the device busy share of the
    window's host-clock time, the mean ``features`` span and the device ms
    per frame of kernels B, C and D."""
    import torch

    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_image
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO
    from cvsteer_tpu_torch.utils.metrics import StepTimer
    from cvsteer_tpu_torch.utils.profiling import device_window

    cfg = VOConfig()
    n = VO_PROFILE_WARM + VO_PROFILE_FRAMES
    frames = _profile_frames(seed)
    if engine == "device":
        vo = DeviceVO(cfg, device="cuda")
        state, step = vo.state, vo.process_image
    else:  # the host engine steps its state in place
        state = init_vo(cfg, device="cuda")
        step = lambda img: process_image(state, img)  # noqa: E731
    for k in range(VO_PROFILE_WARM):
        step(frames[k])
    state.timer = timer = StepTimer(sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    with device_window() as win:
        t0 = time.perf_counter()
        for k in range(VO_PROFILE_WARM, n):
            step(frames[k])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    win.check(graphs=graphs)
    kernels_n, copies_n, busy = _busy(win, wall_s)
    names = {"pyr_down": "pyr_down_kernel", "g2_features_full": "g2_features_kernel",
             "desc_sample": "desc_sample_kernel"}
    per_kernel = {k: sum(e.duration_ns() for e in win.named((v,))) / 1e6 / VO_PROFILE_FRAMES
                  for k, v in names.items()}
    return dict(
        kernels_per_frame=kernels_n / VO_PROFILE_FRAMES,
        copies_per_frame=copies_n / VO_PROFILE_FRAMES,
        launches=len(win.launches), graph_launches=len(win.graph_events()),
        busy_share=busy,
        wall_ms_per_frame=1e3 * wall_s / VO_PROFILE_FRAMES,
        features_ms=timer.means_ms().get("features", float("nan")),
        frontend_kernel_ms=per_kernel,
    )


def run_vo_device(n_frames: int, seed: int, host: dict) -> dict:
    """Phase 5b: the device-resident engine on phase 5's frames (``host``:
    phase 5's result, its images included, so no decode span), on the
    card; then the device time of one replay of each of its two graphs."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO
    from cvsteer_tpu_torch.utils.metrics import StepTimer
    from cvsteer_tpu_torch.utils.profiling import call_ms

    cfg = VOConfig()
    K = cfg.intrinsics
    seq = PlanesSequence(n_frames=n_frames, image_hw=(480, 640), fx=K.fx, fy=K.fy,
                         cx=K.cx, cy=K.cy, seed=seed)
    vo = DeviceVO(cfg, device="cuda")
    timer = StepTimer(sync=torch.cuda.synchronize)
    vo.state.timer = timer
    captures, raw, first_promotion = [], [], None
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k, img in enumerate(host["images"]):  # the loop of cli_vo.main --engine device
        with timer.span("vo"):
            vo.process_image(img)
        captures.append(vo.captures)
        raw.append(vo.state.trajectory[-1][1:])
        if first_promotion is None and timer.count.get("keyframe", 0):
            first_promotion = k
    state = vo.finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    Rs, ts = state.poses()
    gR, gt = seq.gt_arrays()
    frames = [fi for fi, _, _ in state.trajectory]
    whole = len(frames) == n_frames
    ate = ate_rmse(Rs, ts, gR[frames], gt[frames]) if whole else float("nan")
    twin = ate_rmse(Rs, ts, *host["state"].poses()) if whole else float("nan")
    # the frames before the first promotion on the device ran the same
    # bootstrap and the same tracking arithmetic as the host engine
    upto = first_promotion if first_promotion is not None else n_frames
    same = [np.abs(Ra.T @ ta - Rb.T @ tb).max()  # camera centers -R^T t
            for (Ra, ta), (Rb, tb) in zip(raw[:upto], host["raw"][:upto])]
    # one replay of each graph, on the run's final map (the run is over:
    # repeating P keeps shifting the ring, with the same fixed shapes)
    replay = {}
    for name, half in (("T", 0), ("P", 1)):
        fn = lambda h=half: vo._run_half(h)  # noqa: E731
        eager = lambda h=half: vo._run_half(h, eager=True)  # noqa: E731
        replay[name] = dict(**replay_ms(fn, eager), call_ms=call_ms(fn))
    return dict(
        state=state, launches=launches, ate=ate, twin_ate=twin, gate=ate_bound(seq, state, cfg),
        wall_s=wall, vo_s=timer.total_s["vo"], means_ms=timer.means_ms(), frames=frames,
        finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()), captures=captures,
        replay=replay, keyframes=timer.count.get("keyframe", 0), first_promotion=first_promotion,
        max_pose_diff_before=float(max(same, default=math.inf)),
    )


# --- phase 5c: serving -------------------------------------------------------


def graph_kernels(eager) -> int:
    """The device events one replay of a CUDA graph makes: those of one
    eager run of the half it captured (``eager``), in a window that must
    see every launch (a graph replays the kernels, memsets and copies that
    its capture recorded)."""
    from cvsteer_tpu_torch.utils.profiling import device_window

    with device_window() as win:
        eager()
    win.check()
    return len(win.events)


def replay_ms(replay, eager, reps: int = 25) -> dict:
    """A CUDA graph's replay: device ms per replay and device events per
    replay (utils.profiling.device_ms over ``reps`` replays, which must
    show graph_kernels(eager) events each)."""
    from cvsteer_tpu_torch.utils.profiling import device_ms

    ms, seen = device_ms(replay, reps=reps, events=graph_kernels(eager))
    return dict(device_ms=ms, events_per_replay=int(seen))


def one_thread():
    """A render worker's initializer: numpy's BLAS on one thread, so that
    the workers do not oversubscribe the cores (set before numpy loads)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def render_planes(job):
    """The first ``n`` frames of PlanesSequence(seed=seed) at the default
    camera (480x640, fx = fy = 500), rounded to 8 bits, as float32 [n, 480,
    640]: what a PNG of each decodes to. A worker process's task."""
    seed, n = job
    import numpy as np

    from cvsteer_tpu_torch.io.render import PlanesSequence

    seq = PlanesSequence(n_frames=SERVE_FRAMES, image_hw=(480, 640), seed=seed)
    return np.stack([np.clip(np.rint(seq.render(k)), 0, 255) for k in range(n)]).astype(np.float32)


def _write_serving_sequence(job):
    """Render PlanesSequence(seed=seed) over SERVE_FRAMES frames and write
    it under ``root`` in the TUM-RGBD layout: 8-bit PNG frames, rgb.txt,
    groundtruth.txt (camera -> world). A worker process's task; returns the
    frames as float32."""
    seed, root = job
    import numpy as np

    from cvsteer_tpu_torch.cli_vo import _rot_to_quat
    from cvsteer_tpu_torch.io.imageio import imwrite_u8
    from cvsteer_tpu_torch.io.render import PlanesSequence

    frames = render_planes((seed, SERVE_FRAMES))
    gR, gt = PlanesSequence(n_frames=SERVE_FRAMES, image_hw=(480, 640), seed=seed).gt_arrays()
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rgb, truth = [], []
    for k in range(SERVE_FRAMES):
        name = f"rgb/{k:06d}.png"
        imwrite_u8(os.path.join(root, name), frames[k].astype(np.uint8))
        Rwc = gR[k].T.astype(np.float64)
        c = -Rwc @ gt[k].astype(np.float64)
        rgb.append(f"{0.1 * k:.6f} {name}\n")
        pose = " ".join(f"{v:.9f}" for v in (*c, *_rot_to_quat(Rwc)))
        truth.append(f"{0.1 * k:.6f} {pose}\n")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.writelines(rgb)
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.writelines(truth)
    return frames


def _tum_poses(path):
    """(R [F, 3, 3], t [F, 3]) world -> camera from a TUM trajectory file."""
    import numpy as np

    from cvsteer_tpu_torch.io.datasets import _quat_to_R

    rows = np.loadtxt(path, ndmin=2)
    Rwc = _quat_to_R(rows[:, 4:8])
    R = np.swapaxes(Rwc, 1, 2)
    return R.astype(np.float32), (-np.einsum("fij,fj->fi", R, rows[:, 1:4])).astype(np.float32)


def _busy(win, wall_s):
    """(device kernels, copies / memsets, busy share) of a device window
    (utils.profiling.device_window) whose work took ``wall_s``."""
    dev = win.events
    copies = [e for e in dev if e.name().startswith(("Memcpy", "Memset"))]
    busy_ns, end = 0.0, -math.inf
    for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev):
        if b > end:  # the union of the device intervals
            busy_ns += b - max(a, end)
            end = b
    return len(dev) - len(copies), len(copies), busy_ns / (wall_s * 1e9)


def _serve(make, stacks, n_ticks, fcfg, profile=True, after=None, graphs=None) -> dict:
    """A library serving run: ``make()`` builds the server; per tick the
    streams' images go to the card as one [S, 480, 640] stack, one batched
    extract_features, then ``step``. Ticks SERVE_PROFILE_FROM.. are
    profiled (torch.profiler: device kernels per tick, busy share; without
    ``profile`` they only warm up), the later ones timed (aggregate
    frames/s). Returns the finalized states, the timings, the peak
    allocator memory above the run's start, and ``after(server)``'s items;
    the server goes when it returns. The profiled window must see every
    launch and give each graph launch the events of one of ``graphs(server,
    items)``, the server's graphs' events per replay, taken once the run
    is over."""
    import torch

    from cvsteer_tpu_torch.cli_vo import _to_device
    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.utils.profiling import device_window

    S = stacks.shape[1]
    gc.collect()  # the previous run's cyclic garbage holds card memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    srv = make()
    prof_end = SERVE_PROFILE_FROM + SERVE_PROFILE_TICKS

    def tick(k):  # the cli's upload: pinned, no wait for the device
        batch = extract_features(_to_device(stacks[k], torch.device("cuda")), cfg=fcfg)
        srv.step([Features(*(x[i] for x in batch)) for i in range(S)])

    for k in range(SERVE_PROFILE_FROM if profile else prof_end):
        tick(k)
    kernels_n, copies_n, busy, win = math.nan, math.nan, math.nan, None
    if profile:
        torch.cuda.synchronize()
        with device_window() as win:
            t0 = time.perf_counter()
            for k in range(SERVE_PROFILE_FROM, prof_end):
                tick(k)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        kernels_n, copies_n, busy = _busy(win, prof_s)
    t0 = time.perf_counter()
    for k in range(prof_end, n_ticks):
        tick(k)
    states = [srv.finalize(i) for i in range(S)]
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    items = after(srv) if after else {}
    launches = math.nan
    if win is not None:
        win.check(graphs=graphs(srv, items))
        launches = len(win.launches)
    return dict(
        states=states, fps=S * (n_ticks - prof_end) / timed_s,
        tick_ms=1e3 * timed_s / (n_ticks - prof_end), wall_s=time.perf_counter() - t_start,
        kernels_per_tick=kernels_n / SERVE_PROFILE_TICKS,
        copies_per_tick=copies_n / SERVE_PROFILE_TICKS, busy_share=busy, launches=launches,
        peak_bytes=peak, **items,
    )


def run_serving(workdir: str) -> dict:
    """Phase 5c: (a) B, C, D against their plain versions on an [8, 480,
    640] stack of eight sequences' first frames; (b) the eight sequences
    written as TUM directories and served through cli_vo.main with
    --engine device, then --engine device --pipeline, each stream held to
    a single-stream DeviceVO on the same frames (DeviceVOServer's engines);
    (c) the library runs timed: DeviceVOServer, the classic and the
    pipelined fleet, VOServer (SERVE_HOST_FRAMES frames), and one replay
    of each fleet graph."""
    import contextlib
    import io as _io
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from cvsteer_tpu_torch import cli_vo, kernels
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet, DeviceVOServer
    from cvsteer_tpu_torch.slam.vo_server import VOServer

    cfg = VOConfig()
    S = SERVE_STREAMS
    roots = [os.path.join(workdir, f"serve{s}") for s in range(S)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(SERVE_RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=one_thread) as pool:
        frames = list(pool.map(_write_serving_sequence, zip(range(S), roots)))
    stacks = np.ascontiguousarray(np.stack(frames, 1))  # [frames, S, 480, 640]
    render_s = time.perf_counter() - t0
    seqs = [PlanesSequence(n_frames=SERVE_FRAMES, image_hw=(480, 640), seed=s) for s in range(S)]
    gts = [q.gt_arrays() for q in seqs]

    # (a) B, C, D on the fleet's batch
    fe = frontend_agreement(torch.from_numpy(stacks[0]).cuda(), cfg.frontend, g2_bank())
    agree = {k: fe[k] for k in PATH_KERNELS["serving"]}
    agree["p3_keep_agreement"] = fe["p3_keep_agreement"]

    # (c) the library runs; DeviceVOServer's engines are the single-stream
    # references of (b)
    def fleet_graphs(flt):  # after the run: one replay of each graph, timed
        out = dict(captures=flt.captures, engine_captures=[e.captures for e in flt.engines])
        for g, half in (("FT", 0), ("FP", 1)):
            out[g] = replay_ms(lambda h=half: flt._run_half(h),
                               lambda h=half: flt._run_half(h, eager=True))
        return out

    def engine_graphs(srv, _):  # every engine's T and P are the same two graphs
        return [graph_kernels(lambda h=half: srv.engines[0]._run_half(h, eager=True))
                for half in (0, 1)]

    def fleet_kernels(_, items):
        return [items[g]["events_per_replay"] for g in ("FT", "FP")]

    res = {}
    res["DeviceVOServer"] = _serve(lambda: DeviceVOServer(cfg, n_streams=S), stacks,
                                   SERVE_FRAMES, cfg.frontend, graphs=engine_graphs)
    res["fleet classic"] = _serve(lambda: DeviceVOFleet(cfg, n_streams=S), stacks,
                                  SERVE_FRAMES, cfg.frontend, after=fleet_graphs, graphs=fleet_kernels)
    res["fleet pipelined"] = _serve(
        lambda: DeviceVOFleet(cfg, n_streams=S, pipeline=True, promote_cap=SERVE_PIPE_CAP),
        stacks, SERVE_FRAMES, cfg.frontend, after=fleet_graphs, graphs=fleet_kernels)
    res["VOServer"] = _serve(lambda: VOServer(cfg, n_streams=S), stacks, SERVE_HOST_FRAMES,
                             cfg.frontend, profile=False)
    single = res["DeviceVOServer"]["states"]
    for name, r in res.items():
        n = len(r["states"][0].trajectory)
        r["ate"] = [ate_rmse(*st.poses(), g[0][:n], g[1][:n]) for st, g in zip(r["states"], gts)]
        r["whole"] = all([f for f, _, _ in st.trajectory] == list(range(n)) for st in r["states"])
        r["finite"] = all(np.isfinite(st.poses()[1]).all() for st in r["states"])
    graphs = {f"{name} {g}": res[name][g] for name in ("fleet classic", "fleet pipelined")
              for g in ("FT", "FP")}

    # (d) the batch axis alone: seed 0's stream through a DeviceVO, a
    # 1-stream fleet and an 8-stream fleet of eight copies of it, fed the
    # rows of the same batched extraction as the runs above
    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    one, eight, vo = DeviceVOFleet(cfg, n_streams=1), DeviceVOFleet(cfg, n_streams=S), DeviceVO(cfg)
    for k in range(SERVE_FRAMES):
        b = extract_features(torch.from_numpy(stacks[k]).cuda(), cfg=cfg.frontend)
        f0 = Features(*(x[0] for x in b))
        vo.process_frame(f0)
        one.step([f0])
        eight.step([f0] * S)
    ref0 = vo.finalize().poses()
    rows = [eight.finalize(i).poses() for i in range(S)]
    batching = dict(
        one_equal=all(np.array_equal(a, b) for a, b in zip(one.finalize(0).poses(), ref0)),
        rows_equal=all(np.array_equal(a, b) for r in rows for a, b in zip(r, rows[0])),
        rows_apart=float(ate_rmse(*rows[0], *ref0)),
    )

    # (b) the CLI, counts from 0 around each run
    gates = [ate_bound(q, st, cfg) for q, st in zip(seqs, single)]
    # each single-stream run's first promotion after its initialization:
    # the frames before it are tracked against the two-view map alone, no
    # window BA has taken up the batch's rounding yet
    first_promo = [st.keyframes[2].index if len(st.keyframes) > 2 else SERVE_FRAMES
                   for st in single]
    cli = {}
    for name, flags in (("device", []), ("device --pipeline", ["--pipeline"])):
        out = os.path.join(workdir, "serve_" + name.replace(" ", "_").replace("-", "") + ".txt")
        buf = _io.StringIO()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_vo.main(["--input", ",".join(roots), "--engine", "device", *flags,
                              "--output", out, "--verbose"])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t1
        streams = []
        for i, (q, g) in enumerate(zip(seqs, gts)):
            R, t = _tum_poses(cli_vo._stream_output_path(out, i))
            whole = len(t) == SERVE_FRAMES
            Rs, ts = single[i].poses()
            n0 = first_promo[i]
            centers = lambda R_, t_: -np.einsum("fji,fj->fi", R_[:n0], t_[:n0])  # noqa: E731
            streams.append(dict(
                ate=ate_rmse(R, t, *g) if whole else float("nan"),
                twin=ate_rmse(R, t, Rs, ts) if whole else float("nan"),
                before=float(np.linalg.norm(centers(R, t) - centers(Rs, ts), axis=1).max())
                if whole else float("nan"),
                whole=whole, finite=bool(np.isfinite(t).all()),
            ))
        cli[name] = dict(rc=rc, launches=launches, streams=streams, wall_s=wall,
                         stdout=buf.getvalue().strip().splitlines())
    stacks_path = os.path.join(workdir, "serve_stacks.npy")  # phase 12's frames, 8 bits
    np.save(stacks_path, stacks.astype(np.uint8))
    return dict(agree=agree, lib=res, graphs=graphs, cli=cli, gates=gates, render_s=render_s,
                batching=batching, first_promo=first_promo, stacks_path=stacks_path)


# --- phase 9: loop closure --------------------------------------------------
# The synthetic feature world of tests/test_loopclosure.py (loop_world, the
# renderer of tests/test_vo.py), rebuilt here with numpy: the tests import jax.
LOOP_K = (500.0, 500.0, 320.0, 240.0)  # fx, fy, cx, cy
LOOP_N_CAP, LOOP_DESC = 256, 32


def _loop_world():
    import numpy as np

    rng = np.random.default_rng(9)
    X = rng.uniform([-2, -1.5, -2], [2, 1.5, 2], (300, 3)).astype(np.float32)
    desc = rng.normal(size=(300, LOOP_DESC)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return X, desc


def _render_feats(X, desc, R, t, rng, pix_noise=0.1, desc_noise=0.05):
    """tests/test_vo.py::_render_features on the card: the visible points'
    pixels and noisy descriptors as a Features set."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch.features.frontend import Features

    fx, fy, cx, cy = LOOP_K
    p = X @ R.T + t
    z = p[:, 2]
    uv = p[:, :2] / z[:, None]
    pix = np.stack([uv[:, 1] * fy + cy, uv[:, 0] * fx + cx], -1)
    vis = (z > 0.5) & (pix[:, 0] > 5) & (pix[:, 0] < 475) & (pix[:, 1] > 5) & (pix[:, 1] < 635)
    ids = np.nonzero(vis)[0]
    rng.shuffle(ids)
    ids = ids[:LOOP_N_CAP]
    n = len(ids)
    yx = np.zeros((LOOP_N_CAP, 2), np.float32)
    dsc = np.zeros((LOOP_N_CAP, LOOP_DESC), np.float32)
    valid = np.zeros(LOOP_N_CAP, bool)
    yx[:n] = pix[ids] + rng.normal(0, pix_noise, (n, 2))
    d = desc[ids] + rng.normal(0, desc_noise, (n, LOOP_DESC))
    dsc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
    valid[:n] = True

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    return Features(yx=dev(yx), score=dev(valid), theta=dev(np.zeros(LOOP_N_CAP)),
                    level=dev(np.zeros(LOOP_N_CAP), torch.int32), desc=dev(dsc),
                    valid=dev(valid, torch.bool))


def _lookat_pose(c):
    """World->camera pose of a camera at ``c`` looking at the origin."""
    import numpy as np

    z = -c / np.linalg.norm(c)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1).T.astype(np.float32)
    return R, (-R @ c).astype(np.float32)


def _circle_pose(k, n, radius=7.0):
    import numpy as np

    a = 2 * np.pi * k / n
    return _lookat_pose(np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)]))


def _inject_scale_drift(state, rate):
    """tests/test_loopclosure.py::_inject_scale_drift: each odometry step's
    translation scaled by (1 + rate)^k, landmarks following their anchoring
    keyframe's similarity, the trajectory and its re-anchoring records too.
    Returns the accumulated drift."""
    import numpy as np

    kfs = state.keyframes
    P = len(kfs)
    centers = [(-kf.R.T @ kf.t).astype(np.float64) for kf in kfs]
    s = [(1.0 + rate) ** k for k in range(P)]
    c_new = [centers[0]]
    for k in range(1, P):
        c_new.append(c_new[-1] + s[k - 1] * (centers[k] - centers[k - 1]))
    anchor = {}
    for k, kf in enumerate(kfs):
        for lid in kf.landmark_ids[kf.landmark_ids >= 0]:
            anchor.setdefault(int(lid), k)
    for lid, k in anchor.items():
        X = state.landmarks[lid].astype(np.float64)
        state.landmarks[lid] = (c_new[k] + s[k] * (X - centers[k])).astype(np.float32)
    for k, kf in enumerate(kfs):
        kf.t = (-kf.R @ c_new[k]).astype(np.float32)
    kf_by_frame = {kf.index: k for k, kf in enumerate(kfs)}
    for i, (f, R, t) in enumerate(state.trajectory):
        if f in kf_by_frame:
            state.trajectory[i] = (f, R, (-R @ c_new[kf_by_frame[f]]).astype(np.float32))
        elif i < len(state.traj_ref) and state.traj_ref[i] is not None:
            ref, R_rel, t_rel, pidx, b_old = state.traj_ref[i]
            k = kf_by_frame.get(ref)
            if k is None:
                continue
            c = (-R.T @ t).astype(np.float64)
            c2 = c_new[k] + s[k] * (c - centers[k])
            state.trajectory[i] = (f, R, (-R @ c2).astype(np.float32))
            state.traj_ref[i] = (ref, R_rel, (s[k] * t_rel).astype(np.float32), pidx,
                                 b_old * (s[k - 1] if k >= 1 else s[k]))
    return s[-1]


def _kf_ate(state, gt) -> float:
    import numpy as np

    from cvsteer_tpu_torch.slam.evaluate import ate_rmse

    kfs = state.keyframes
    return ate_rmse(np.stack([kf.R for kf in kfs]), np.stack([kf.t for kf in kfs]),
                    np.stack([gt[kf.index][0] for kf in kfs]),
                    np.stack([gt[kf.index][1] for kf in kfs]))


def run_loop_closure() -> dict:
    """Phase 9 (a): close_loops on the drifted 13-keyframe revisit (the
    reference's test_close_loops_corrects_drift, two rounds), then the host
    engine around the 48-frame circle with injected scale drift, closed by
    close_loops_sim3 and, on a copy, by close_loops; all on the card."""
    import copy

    import numpy as np
    import torch

    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.slam import se3
    from cvsteer_tpu_torch.slam.loopclosure import close_loops, close_loops_sim3
    from cvsteer_tpu_torch.slam.vo import Keyframe, VOConfig, init_vo, process_frame

    X, desc = _loop_world()
    K = Intrinsics(*LOOP_K)
    out = {}

    # (a1) SE(3) drift on a keyframed revisit, no landmark map
    rng = np.random.default_rng(3)
    gt = [_circle_pose(k, 12) for k in range(12)] + [_circle_pose(0, 12)]
    state = init_vo(VOConfig(intrinsics=K), device="cuda")
    for n, (R, t) in enumerate(gt):
        s = n / len(gt)
        xi = np.concatenate([0.06 * s * np.array([1, -1, 0.5]), 0.4 * s * np.array([1, 0.3, -0.5])])
        dR, dt = se3.exp_se3(torch.tensor(xi, dtype=torch.float32))
        Rn, tn = se3.compose(dR, dt, torch.from_numpy(R), torch.from_numpy(t))
        state.keyframes.append(Keyframe(
            index=n, features=_render_feats(X, desc, R, t, rng), R=Rn.numpy(), t=tn.numpy(),
            landmark_ids=np.full(LOOP_N_CAP, -1, np.int64)))
    state.initialized, state.frame_count = True, len(gt)

    def last_err():  # the newest keyframe's rotation (rad) and translation error
        kf = state.keyframes[-1]
        R, t = gt[-1]
        rot = float(se3.rotation_geodesic(torch.from_numpy(kf.R), torch.from_numpy(R)))
        return rot, float(np.linalg.norm(kf.t - t))

    before = last_err()
    t0 = time.perf_counter()
    n1 = close_loops(state, min_gap=6, min_inliers=20)
    t1 = time.perf_counter()
    n2 = close_loops(state, min_gap=6, min_inliers=20)  # against corrected baselines
    out["se3"] = dict(accepted=(n1, n2), before=before, after=last_err(),
                      ms=(1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))

    # (a2) the host engine around the loop, then injected scale drift
    rng = np.random.default_rng(11)
    n_frames = 48
    gt = [_circle_pose(k, n_frames - 1) for k in range(n_frames)]
    cfg = VOConfig(intrinsics=K, kf_max_gap=4, window=6, track_min_landmarks=40, min_parallax=0.01)
    state = init_vo(cfg, device="cuda")
    for R, t in gt:
        state = process_frame(state, _render_feats(X, desc, R, t, rng))
    drift = _inject_scale_drift(state, rate=0.06)
    before = _kf_ate(state, gt)
    state_se3 = copy.deepcopy(state)
    t0 = time.perf_counter()
    n_sim3 = close_loops_sim3(state, min_gap=6, min_inliers=20)
    t1 = time.perf_counter()
    n_se3 = close_loops(state_se3, min_gap=6, min_inliers=20)
    t2 = time.perf_counter()
    out["sim3"] = dict(
        keyframes=len(state.keyframes), drift=drift, ate_before=before, accepted=n_sim3,
        ate_sim3=_kf_ate(state, gt), accepted_se3=n_se3,
        ate_se3=_kf_ate(state_se3, gt) if n_se3 else before,
        ms=(1e3 * (t1 - t0), 1e3 * (t2 - t1)),
    )
    return out


def pgo_world(P, seed, sim3=False, loops=0):
    """A circle of P world->camera poses (numpy) with odometry edges and two
    closures, plus ``loops`` random closures between poses at least two
    apart, measured from the truth with 0.01 noise, and a start drifted by
    0.05 per pose (and, for Sim(3), a scale ramp to e^0.3); pose 0 fixed."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch.slam import se3

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(P) / P
    Rwc = se3.exp_so3(torch.from_numpy(np.stack([0 * ang, 0 * ang, ang], 1).astype(np.float32)))
    R = Rwc.transpose(-1, -2).numpy()
    c = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], 1)
    t = (-(R @ c[..., None])[..., 0]).astype(np.float32)
    edges = [(k, k + 1) for k in range(P - 1)] + [(0, P - 1), (1, P // 2)]
    if loops:
        lrng = np.random.default_rng(seed + 1)
        a = lrng.integers(0, P, loops)
        edges += list(zip(a.tolist(), ((a + lrng.integers(2, P - 1, loops)) % P).tolist()))
    i = np.array([a for a, _ in edges], np.int32)
    j = np.array([b for _, b in edges], np.int32)
    Rz = R[j] @ np.transpose(R[i], (0, 2, 1))
    tz = t[j] - (Rz @ t[i][..., None])[..., 0]
    dR, dt = se3.exp_se3(torch.from_numpy(rng.normal(0, 0.01, (len(edges), 6)).astype(np.float32)))
    Rz = (dR.numpy() @ Rz).astype(np.float32)
    tz = ((dR.numpy() @ tz[..., None])[..., 0] + dt.numpy()).astype(np.float32)
    drift = rng.normal(0, 0.05, (P, 6)).astype(np.float32)
    drift[0] = 0
    dR, dt = se3.exp_se3(torch.from_numpy(drift))
    fixed = np.arange(P) == 0
    return dict(
        i=i, j=j, Rz=Rz, tz=tz, fixed=fixed, sz=np.ones(len(edges), np.float32),
        R0=(dR.numpy() @ R).astype(np.float32),
        t0=((dR.numpy() @ t[..., None])[..., 0] + dt.numpy()).astype(np.float32),
        s0=np.exp(np.linspace(0.0, 0.3, P)).astype(np.float32) if sim3 else None,
    )


def pgo_tensors(w, device):
    """(Poses, PoseGraph) of a pgo_world on ``device``."""
    import torch

    from cvsteer_tpu_torch.slam import posegraph as pg

    def T(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    g = pg.PoseGraph(T(w["i"], torch.int32), T(w["j"], torch.int32), T(w["Rz"]), T(w["tz"]),
                     torch.ones(len(w["i"]), device=device), T(w["fixed"], torch.bool))
    return pg.Poses(T(w["R0"]), T(w["t0"])), g


def pgo_call(w, device, *, kind, **kw):
    """optimize_pose_graph (kind "se3") or optimize_pose_graph_sim3 ("sim3")
    on a pgo_world on ``device``: (poses, stats)."""
    import torch

    from cvsteer_tpu_torch.slam import posegraph as pg
    from cvsteer_tpu_torch.slam import posegraph_sim3 as ps
    from cvsteer_tpu_torch.slam.sim3 import Sim3

    def T(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    i, j, E = T(w["i"], torch.int32), T(w["j"], torch.int32), len(w["i"])
    fixed = T(w["fixed"], torch.bool)
    if kind == "se3":
        return pg.optimize_pose_graph(*pgo_tensors(w, device), **kw)
    g = ps.Sim3Graph(i, j, T(w["sz"]), T(w["Rz"]), T(w["tz"]), T([1.0] * E), fixed)
    return ps.optimize_pose_graph_sim3(Sim3(T(w["s0"]), T(w["R0"]), T(w["t0"])), g, **kw)


def time_pgo() -> dict:
    """Phase 9 (c): optimize_pose_graph_sim3 on the card at the closers'
    two solver sizes, 20 LM iterations as close_loops_sim3 runs them: dense
    at 256 poses (the skeleton's bucket), PCG with 100 CG iterations at
    512 (past it). Each timed once after a warm-up call, host clock to a
    synchronize."""
    import torch

    out = {}
    for solver, P in (("dense", 256), ("pcg", 512)):
        w = pgo_world(P, 5, sim3=True)
        kw = dict(kind="sim3", iterations=20, solver=solver, cg_iterations=100)
        pgo_call(w, "cuda", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = pgo_call(w, "cuda", **kw)
        c = float(st.cost)  # synchronizes
        out[solver] = dict(P=P, ms=1e3 * (time.perf_counter() - t0), cost=c,
                           initial=float(st.initial_cost))
    return out


def _render_city(frames):
    """Render CityLoop(**LOOP_CITY) frames (a worker process's share)."""
    from cvsteer_tpu_torch.io.synth import CityLoop

    seq = CityLoop(**LOOP_CITY)
    return [seq.render(k) for k in frames]


def _city_cfg():
    """The campaign's VOConfig (scripts/slam_scale_run.py), field for field."""
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.io.synth import CityLoop
    from cvsteer_tpu_torch.slam.vo import VOConfig

    seq = CityLoop(**LOOP_CITY)
    return seq, VOConfig(
        intrinsics=Intrinsics(*seq.intrinsics4), frontend=FrontendConfig(upright_desc=True),
        kf_max_gap=3, window=12, track_min_landmarks=40, min_parallax=0.03, match_ratio=0.80,
        ba_iterations=25, tri_min_ray_angle_deg=0.7, rescue_radius_px=8.0,
        max_landmarks=262144, loop_closure=True, loop_closure_sim3=True, loop_min_gap=50,
        loop_cooldown=25, loop_sig_capacity=4096, loop_signature_threshold=0.8,
        loop_consistency=2, loop_reject_cooldown=15, ground_height_m=1.5,
        speed_prior_band=(0.5, 2.0),
    )


def _events(state, ev):
    return [e for e in (state.diag or []) if e["ev"] == ev]


def run_loop_city() -> dict:
    """Phase 9 (b): the campaign configuration on the cut CityLoop through
    the device engine, then the host engine on the first LOOP_HOST_FRAMES
    frames. Frames are rendered first, in worker processes (set-up, not VO
    time)."""
    import multiprocessing

    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse
    from cvsteer_tpu_torch.slam.vo import finalize, init_vo, process_image
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO
    from cvsteer_tpu_torch.utils.metrics import StepTimer
    from cvsteer_tpu_torch.utils.profiling import MemoryHighWater

    from concurrent.futures import ProcessPoolExecutor

    seq, cfg = _city_cfg()
    t0 = time.perf_counter()
    chunks = [list(range(w, LOOP_FRAMES, LOOP_RENDER_WORKERS)) for w in range(LOOP_RENDER_WORKERS)]
    with ProcessPoolExecutor(LOOP_RENDER_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(_render_city, chunks))
    images = [None] * LOOP_FRAMES
    for idx, imgs in zip(chunks, parts):
        for k, img in zip(idx, imgs):
            images[k] = img
    render_s = time.perf_counter() - t0
    gR, gt = seq.gt_arrays()

    def summary(state, timer, n, launches):  # of a finalized run
        Rs, ts = state.poses()
        frames = [f for f, _, _ in state.trajectory]
        whole = frames == list(range(n))
        ate = ate_rmse(Rs, ts, gR[frames], gt[frames]) if whole else float("nan")
        closures = _events(state, "closure")
        return dict(
            state=state, n=n, vo_s=timer.total_s["vo"], ate=ate, whole=whole,
            finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
            keyframes=len(state.keyframes), ground=len(_events(state, "ground")),
            speed=len(_events(state, "speed_prior")),
            closures=[(e["accepted"], e.get("sync_ms", float("nan")), e["solve_ms"]) for e in closures],
            launches=launches, means_ms=timer.means_ms(),
        )

    # the device engine over the whole cut sequence
    torch.cuda.reset_peak_memory_stats()
    vo = DeviceVO(cfg, device="cuda")
    vo.state.diag = []
    vo.state.timer = timer = StepTimer(sync=torch.cuda.synchronize)
    kernels.reset_launch_counts()
    for img in images:
        with timer.span("vo"):
            vo.process_image(img)
    final = vo.finalize()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    high = MemoryHighWater()
    peak = high.sample()["cuda:0"]["peak_bytes_in_use"]
    dev = summary(final, timer, LOOP_FRAMES, launches)
    dev.update(captures=vo.captures, accepted_total=vo.closures_accepted, peak_bytes=peak,
               render_s=render_s, gate=ate_bound(seq, final, cfg))

    # the host engine over the first frames (both priors, no revisit)
    state = init_vo(cfg, device="cuda")
    state.diag = []
    state.timer = htimer = StepTimer(sync=torch.cuda.synchronize)
    kernels.reset_launch_counts()
    for img in images[:LOOP_HOST_FRAMES]:
        with htimer.span("vo"):
            state = process_image(state, img)
    torch.cuda.synchronize()
    host = summary(finalize(state), htimer, LOOP_HOST_FRAMES, kernels.launch_counts())
    # the bound over the host run's frames: the same circuit and speed
    head = type(seq)(**dict(LOOP_CITY, n_frames=LOOP_HOST_FRAMES,
                            laps=LOOP_CITY["laps"] * LOOP_HOST_FRAMES / LOOP_CITY["n_frames"]))
    host["gate"] = ate_bound(head, host["state"], cfg)

    # B, C and D against their plain versions at this path's shapes (the
    # 240x320 frame down to 15x20) and with its upright descriptors
    img0 = torch.from_numpy(images[0]).cuda().to(torch.float32)[None].contiguous()
    fe = frontend_agreement(img0, cfg.frontend, g2_bank())
    agree = {k: fe[k] for k in PATH_KERNELS["loop"]}
    agree["p3_keep_agreement"] = fe["p3_keep_agreement"]
    agree["shapes"] = [tuple(lv.shape[-2:]) for lv in fe["levels"]]
    return dict(device=dev, host=host, kernels=agree)


def run_cli(frames512, paths, workdir: str):
    """Phase 6: cvsteer_tpu_torch.cli.main with --filters g2 and g4 on the
    64 frames (and one unreadable entry), then on the fish image. Returns
    (per-run results, checks)."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import cli, kernels
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.io.imageio import imread_gray_f32
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.utils.imageproc import normalize_minmax_u8

    lst = os.path.join(workdir, "inputs.txt")
    entries = list(paths)
    entries.insert(len(entries) // 2, os.path.join(workdir, "missing.png"))
    with open(lst, "w") as f:
        f.write("\n".join(entries) + "\n")

    runs, checks = {}, {}
    for filters, plain, bk in (("g2", cf.g2_maps_plain, g2_bank()), ("g4", cf.g4_maps_plain, g4_bank())):
        out = os.path.join(workdir, f"out_{filters}")
        phase = f"cli_{filters}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--input", lst, "--output", out, "--filters", filters])
        dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        pngs = [f for f in os.listdir(out) if f.endswith(".png")]
        max_diff, n_equal, n_total, unreadable = 0.0, 0, 0, 0
        for b0 in range(0, CLI_FRAMES, CLI_BATCH):
            batch = torch.from_numpy(frames512[b0:b0 + CLI_BATCH]).cuda()
            want = [normalize_minmax_u8(m, axes=(-2, -1)).cpu().numpy()
                    for m in plain(batch, bk.xtaps, bk.ytaps, out_dtype=torch.bfloat16)]
            for j in range(batch.shape[0]):
                base = os.path.splitext(os.path.basename(paths[b0 + j]))[0]
                for name, w in zip(MAPS, want):
                    got = imread_gray_f32(os.path.join(out, f"{base}_{name}.png"))
                    if got is None or got.shape != w[j].shape:
                        unreadable += 1
                        continue
                    d = np.abs(got - w[j])
                    max_diff = max(max_diff, float(d.max()))
                    n_equal += int((d == 0).sum())
                    n_total += d.size
        equal = n_equal / max(n_total, 1)
        runs[phase] = dict(rc=rc, seconds=dt, images_per_s=CLI_FRAMES / dt, pngs=len(pngs),
                           max_u8_diff=max_diff, equal_fraction=equal, launches=launches)
        print(f"CLI --filters {filters}: {CLI_FRAMES} images {CLI_HW[0]}x{CLI_HW[1]} in {dt:.3f} s "
              f"({CLI_FRAMES / dt:.2f} images/s, decode + device + PNG writes); {len(pngs)} PNGs; "
              f"vs plain path: max diff {max_diff:.0f} gray levels, {100 * equal:.4f} % equal")
        checks[f"{filters}: rc 0"] = rc == 0
        checks[f"{filters}: {3 * CLI_FRAMES} PNGs"] = len(pngs) == 3 * CLI_FRAMES and unreadable == 0
        checks[f"{filters}: within 1 gray level of plain"] = max_diff <= 1.0
        checks[f"{filters}: >= 99.9 % equal to plain"] = equal >= MIN_U8_EQUAL
        checks[f"{filters}: maps kernel launched"] = all(launches[k] > 0 for k in PATH_KERNELS[phase])

    out = os.path.join(workdir, "out_fish")
    rc = cli.main(["--input", os.path.join(GOLDEN_DIR, "fish.png"), "--output", out])
    l1 = {}
    for name in MAPS:
        got = imread_gray_f32(os.path.join(out, f"fish_{name}.png"))
        gold = imread_gray_f32(os.path.join(GOLDEN_DIR, f"golden_{name}.png"))
        l1[name] = float(np.abs(got.astype(np.float64) - gold).mean()) if got is not None else math.inf
    runs["fish"] = dict(rc=rc, golden_l1=l1)
    print(f"CLI fish 185x256 vs decoded goldens, mean L1 (bar {GOLDEN_L1}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in l1.items()))
    checks["fish: rc 0 and golden L1"] = rc == 0 and all(v <= GOLDEN_L1 for v in l1.values())
    return runs, checks


def run_pyramid(frame):
    """Phase 7: steerable_pyramid_maps and the differentiable bases on the
    card, against the plain kernels' versions."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.features.pyramid_maps import steerable_pyramid_maps
    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    img = torch.from_numpy(frame).cuda()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    levels = steerable_pyramid_maps(img, levels=5, with_g4=True)
    grads = []
    for basis_fn in (fg2.g2_basis, fg4.g4_basis):
        x = img.clone().requires_grad_()
        grads.append(torch.autograd.grad((basis_fn(x) ** 2).sum(), x)[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()

    # the same maps from the plain versions of kernels B and A
    g2b, g4b = fg2.g2_bank(), fg4.g4_bank()
    plain = [img]
    for _ in range(4):
        plain.append(cf.pyr_down_plain(plain[-1]))
    finite, err, odd_bad = True, 0.0, 0.0
    odd = ("h2", "h4", "phase", "theta")  # their sign follows theta's at singular pixels
    for lv, got in zip(plain, levels):
        want = (fg2.g2_maps_from_basis(cf.filter_bank_plain(lv, g2b.xtaps, g2b.ytaps)),
                fg4.g4_maps_from_basis(cf.filter_bank_plain(lv, g4b.xtaps, g4b.ytaps)))
        for g, w in zip((got.g2, got.g4), want):
            for field in w._fields:
                a, b = getattr(g, field), getattr(w, field)
                finite &= bool(torch.isfinite(a).all())
                d = (a - b).abs()
                if field == "phase":
                    d = torch.remainder(a - b + math.pi, 2 * math.pi).sub(math.pi).abs()
                tol = TOL_REL * max(b.abs().max().item(), 1.0)
                if field in odd:
                    odd_bad = max(odd_bad, (d > tol).float().mean().item())
                else:
                    err = max(err, d.max().item() / max(b.abs().max().item(), 1e-30))
    grad_err = 0.0
    for bk, g in zip((g2b, g4b), grads):
        finite &= bool(torch.isfinite(g).all())
        x = img.clone().requires_grad_()
        (ref,) = torch.autograd.grad((cf.filter_bank_plain(x, bk.xtaps, bk.ytaps) ** 2).sum(), x)
        grad_err = max(grad_err, (g - ref).abs().max().item() / ref.abs().max().item())
    shapes = [tuple(l.g2.edges.shape) for l in levels]
    print(f"pyramid: 5 levels {shapes}, G2 + G4 maps and two basis gradients in {dt:.3f} s; "
          f"vs plain: max rel err {err:.3e}, odd-field mismatch {odd_bad:.2e}; "
          f"gradient rel err vs autograd {grad_err:.3e}; launches {launches}")
    checks = {
        "pyramid: finite": finite,
        "pyramid: maps match plain": err <= TOL_REL and odd_bad <= 1e-3,
        "pyramid: gradients match autograd": grad_err <= TOL_GRAD,
        "pyramid: kernels A, B, F launched": all(launches[k] > 0 for k in PATH_KERNELS["pyramid"]),
    }
    return launches, checks


PROBES = ("probe_dma_gather", "profile_v2_stages", "profile_frontend", "probe_r3_variants",
          "profile_variants")
PROBE_REPS = 10  # calls per device-time window in the probes' own tables
PLAIN_REPS = 5  # calls per window of the probe kernels' plain versions


def _fmt(v):
    return round(v, 4) if isinstance(v, float) else v


def run_probes():
    """Phase 8, the probes' paths: each module of cvsteer_tpu_torch.probes
    walks its path once untimed (the launches counted), then measures once
    at its script's shapes; prints its table's rows."""
    import importlib

    import torch

    from cvsteer_tpu_torch import kernels, probes

    mods = [importlib.import_module(f"cvsteer_tpu_torch.probes.{n}") for n in PROBES]
    kernels.reset_launch_counts()
    with probes.untimed():
        for m in mods:
            m.measure("cuda", reps=PROBE_REPS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    results = {n: m.measure("cuda", reps=PROBE_REPS) for n, m in zip(PROBES, mods)}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, res in results.items():
        if isinstance(res, dict):
            res = {k: ([[_fmt(x) for x in r] for r in v] if isinstance(v, list) else _fmt(v))
                   for k, v in res.items()}
        else:
            res = [({k: _fmt(x) for k, x in r.items()} if isinstance(r, dict) else [_fmt(x) for x in r])
                   for r in res]
        print(f"probe {name}: {json.dumps(res)}")
    print(f"probes: {dt:.1f} s; launches {({k: launches[k] for k in PATH_KERNELS['probes']})}")
    checks = {"probes: kernels G, S, V, M launched": all(launches[k] > 0 for k in PATH_KERNELS["probes"])}
    return launches, checks


def check_probe_kernels():
    """Phase 8, the kernels: G, S and V bit for bit against their plain
    versions, M within its stated tolerance (ops.cuda_probes.mma_agreement),
    at the probes' shapes and ragged ones; timed like phase 4, each over the
    calls its probe makes. Returns (records, ok)."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import probes
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.ops import cuda_probes as cp
    from cvsteer_tpu_torch.probes import probe_dma_gather as pdg
    from cvsteer_tpu_torch.probes import probe_r3_variants as r3

    records, ok = [], True
    xt, yt = probes.g2_taps()
    as_bytes = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731

    def same(got, want):
        return all(torch.equal(as_bytes(a), as_bytes(b)) for a, b in zip(got, want))

    def abs_err(got, want):
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    # G, rows: the probe's 32 B and 512 B rows; a ragged table of 14 B rows
    # with indices at and past its ends
    a = pdg.inputs("cuda")
    calls = [(a["tbl"], a["idx"]), (a["tbl512"], a["idx512"])]
    odd = a["tbl"][:1000, :7].contiguous()
    odd_idx = torch.tensor([0, 999, 1000, 5000, -2], dtype=torch.int32, device="cuda")
    got = [cp.gather_rows(t, i) for t, i in calls + [(odd, odd_idx)]]
    want = [cp.gather_rows_plain(t, i) for t, i in calls + [(odd, odd_idx)]]
    # the bytes this run's data needs: the distinct rows it reads, the
    # indices, the rows it writes
    bound = Bound()
    for t, i in calls:
        row_bytes = t[0].numel() * t.element_size()
        distinct = torch.unique(i.long().clamp(0, t.shape[0] - 1)).numel()
        bound.add(distinct * row_bytes + i.numel() * (4 + row_bytes), 0)
    ok &= add_record(
        records, "probe_gather_rows", "cvsteer_tpu_torch/kernels/csrc/probe_gather.cu",
        "scripts/probe_dma_gather.py:36 dma_gather_rows (call :72)",
        abs_err(got, want), same(got, want),
        timings([lambda t=t, i=i: cp.gather_rows(t, i) for t, i in calls], ("gather_rows_kernel",), 1,
                [lambda t=t, i=i: cp.gather_rows_plain(t, i) for t, i in calls],
                [lambda t=t, i=i: torch.index_select(t, 0, i) for t, i in calls]),
        bound, bit_equal=same(got, want), timed_rows=[i.numel() for _, i in calls],
        library="torch.index_select",
    )

    # G, patches: the probe's 2,048 16 x 256 bf16 patches; starts past the
    # edges and unaligned
    img, ys, xs = a["img"], a["ys"], a["xs"]
    ys2, xs2 = ys.clone(), xs.clone()
    ys2[:3] = torch.tensor([0, 470, 900], dtype=torch.int32)
    xs2[:3] = torch.tensor([5117, 3, 4861], dtype=torch.int32)
    got = [cp.gather_patches(img, ys, xs), cp.gather_patches(img, ys2, xs2)]
    want = [cp.gather_patches_plain(img, ys, xs), cp.gather_patches_plain(img, ys2, xs2)]
    # the bytes this run's data needs: the image pixels the windows cover
    # (they overlap), the starts, the patches it writes
    covered = torch.zeros(img.shape, dtype=torch.bool, device="cuda")
    dy = torch.arange(pdg.PATCH_H, device="cuda")[None, :, None]
    dx = torch.arange(pdg.PATCH_W, device="cuda")[None, None, :]
    covered[ys.long()[:, None, None] + dy, xs.long()[:, None, None] + dx] = True
    bound = Bound()
    bound.add((int(covered.sum()) + pdg.PATCH_H * pdg.PATCH_W * ys.numel()) * img.element_size()
              + 8 * ys.numel(), 0)
    ok &= add_record(
        records, "probe_gather_patches", "cvsteer_tpu_torch/kernels/csrc/probe_gather.cu",
        "scripts/probe_dma_gather.py:87 dma_gather_patches (call :117)",
        abs_err(got, want), same(got, want),
        timings([lambda: cp.gather_patches(img, ys, xs)], ("gather_patches_kernel",), 1,
                [lambda: cp.gather_patches_plain(img, ys, xs)],
                [lambda: pdg.patches_by_indexing(img, ys, xs)]),
        bound, bit_equal=same(got, want), patches=ys.numel(), library="advanced indexing",
    )

    # S: every stage, both outputs, at the probes' 16x512x512 and 2x61x83;
    # timed: the five v2 stages (profile_v2_stages' calls)
    batch = probes.uniform_batch(16, 512, "cuda")
    ragged = probes.uniform_batch(2, 83, "cuda")[:, :61].contiguous()
    err, bits = 0.0, True
    for x in (batch, ragged):
        for outputs in cp.OUTPUTS:
            for stage in cp.STAGES:
                got = cp.maps_stage(x, xt, yt, stage, outputs)
                want = cp.maps_stage_plain(x, xt, yt, stage, outputs)
                err, bits = max(err, abs_err(got, want)), bits and same(got, want)
    px = batch.numel()
    bank = bank_flops(px, xt, yt)
    rows = px * sum(pass_flops(xt[k]) for k in distinct_rows(xt))
    bound = Bound()
    for flops in (0, rows, bank, bank + 30 * px, bank + maps_tail_flops(2) * px):
        bound.add(16 * px, flops)
    ok &= add_record(
        records, "probe_maps_stages", "cvsteer_tpu_torch/kernels/csrc/probe_maps_stages.cu",
        "scripts/profile_v2_stages.py:36 stage_kernel (build :126, call :149) + "
        "scripts/profile_frontend.py:43 _stage_kernel (make_variant :137, call :159)",
        err, bits,
        timings([lambda s=s: cp.maps_stage(batch, xt, yt, s, "v2") for s in cp.STAGES],
                ("maps_kernel", "stage_rows_kernel"), 1,
                [lambda s=s: cp.maps_stage_plain(batch, xt, yt, s, "v2") for s in cp.STAGES],
                plain_reps=PLAIN_REPS),
        bound, bit_equal=bits, timed_shape=list(batch.shape), units="the 5 v2 stages",
    )

    # V: every case on the r3 probe's u8-valued batch and on the ragged one;
    # sd against kernel E's fp32 maps; timed: the r3 probe's nine cases
    u8 = probes.uniform_batch(16, 512, "cuda", integers=True)
    err, bits = 0.0, True
    for x in (u8, ragged):
        for tail, carry, tile in sorted(cp.VARIANT_CASES):
            got = cp.maps_variant(x, xt, yt, tail, carry=carry, tile_h=tile)
            want = cp.maps_variant_plain(x, xt, yt, tail)
            err, bits = max(err, abs_err(got, want)), bits and same(got, want)
    sd_is_e = same(cp.maps_variant(u8, xt, yt, "sd"), cf.g2_maps(u8, xt, yt))
    cases = [(r3.variant_args(v), tile) for tile, v in r3.CASES]
    bound = Bound()
    for _ in cases:
        bound.add(16 * px, bank + maps_tail_flops(2) * px)
    ok &= add_record(
        records, "probe_maps_variants", "cvsteer_tpu_torch/kernels/csrc/probe_maps_variants.cu",
        "scripts/probe_r3_variants.py:49 make_kernel (call :188) + scripts/profile_variants.py:106 "
        "_kernel_baseline, :206 _kernel_factored (build :232, call :304)",
        err, bits and sd_is_e,
        timings([lambda c=c, t=t: cp.maps_variant(u8, xt, yt, c[0], carry=c[1], tile_h=t) for c, t in cases],
                ("maps_kernel", "carry_kernel"), 1,
                [lambda c=c: cp.maps_variant_plain(u8, xt, yt, c[0]) for c, _ in cases],
                plain_reps=PLAIN_REPS),
        bound, bit_equal=bits, sd_equals_kernel_e=sd_is_e, timed_shape=list(u8.shape),
        units="probe_r3_variants' 9 cases",
    )

    # M: every case at 16x512x512 and 2x61x83 within its tolerance; timed:
    # the six M calls of profile_variants and profile_frontend. Beside the
    # bytes, the least tensor-core time of the banded products: per 16x8
    # outputs of a filter two k-steps of 16 x 8 x 16 multiply-adds, three
    # products for bf16x3 and one for bf16x1, two more per 16x8 row-pass
    # outputs of the 16 padded x-tap rows for rowmxu
    err, good, worst = 0.0, True, {}
    for x in (batch, ragged):
        for stage, row, col in sorted(cp.MMA_CASES):
            got = cp.maps_mma(x, xt, yt, stage, row, col)
            want = cp.maps_mma_plain(x, xt, yt, stage, row, col)
            c3 = cp.maps_mma_plain(x, xt, yt, "coeff", row, col)[1] if stage == "full" else None
            res = cp.mma_agreement(got, want, stage, row, c3)
            err, good = max(err, abs_err(got, want)), good and res["ok"]
            key = f"{stage}/{row}/{col}"
            if key not in worst or res["max_rel"] > worst[key]["max_rel"]:
                worst[key] = {k: _fmt(v) for k, v in res.items()}
    timed = [("row", "fp32", "bf16x3"), ("col", "fp32", "bf16x3"), ("coeff", "fp32", "bf16x3"),
             ("full", "fp32", "bf16x3"), ("full", "mma", "bf16x3"), ("full", "fp32", "bf16x1")]
    mma = 16 * 8 * 16 * 2
    bound, tc_flops = Bound(), 0.0
    for stage, row, col in timed:
        bound.add(16 * px, 0)
        blocks = px / (16 * 8)
        tc_flops += 0 if stage == "row" else blocks * 7 * 2 * (3 if col == "bf16x3" else 1) * mma
        tc_flops += px * (64 + 8) / 64 / 8 * 2 * mma if row == "mma" else 0  # 72 rows a 64-row tile
    ok &= add_record(
        records, "probe_maps_mma", "cvsteer_tpu_torch/kernels/csrc/probe_maps_mma.cu",
        "scripts/profile_variants.py:148 _kernel_presplit (call :261) + :118 _kernel_rowmxu "
        "(call :304) + scripts/profile_frontend.py:244 the Precision.DEFAULT column pass",
        err, good,
        timings([lambda c=c: cp.maps_mma(batch, xt, yt, *c) for c in timed], ("mma_maps_kernel",), 1,
                [lambda c=c: cp.maps_mma_plain(batch, xt, yt, *c) for c in timed],
                plain_reps=PLAIN_REPS),
        bound, agreement=worst, timed_shape=list(batch.shape), units="the 6 M calls of the probes",
        tensor_core_flops=tc_flops, tensor_core_bound_ms=tc_flops / BF16_TC_FLOPS_PER_S * 1e3,
        tolerance=dict(col_coeff=cp.MMA_TOL, after_rowmxu=cp.MMA_TOL_ROW_MMA, full_max=cp.MMA_FULL_MAX,
                       full_fraction_beyond_1e5=cp.MMA_FULL_FRACTION, full_firm=cp.MMA_FULL_FIRM),
    )
    torch.cuda.synchronize()
    return records, ok


def count_decodes(native_codec) -> list:
    """Count the codec's decodes from now on: [n], kept current by a
    wrapper around native_codec.imdecode_gray (thread-safe: the decode
    pools call it from many threads)."""
    import threading

    n, lock, decode = [0], threading.Lock(), native_codec.imdecode_gray

    def counted(data):
        with lock:
            n[0] += 1
        return decode(data)
    counted.original = decode
    native_codec.imdecode_gray = counted
    return n


def restore_decodes(native_codec) -> None:
    native_codec.imdecode_gray = native_codec.imdecode_gray.original


def served_fps(lines) -> float:
    """The aggregate frames/s of cli_vo's serving summary line."""
    import re

    for line in lines:
        m = re.search(r"\(([0-9.]+) frames/s aggregate\)", line)
        if m:
            return float(m.group(1))
    return math.nan


# --- phase 10: the generic feature path, G4/H4 and G2 'strength' --------------


@functools.lru_cache(maxsize=None)
def feature_batch():
    """Phase 10's input on the card: FEAT_FRAMES frames of FEAT_HW, uniform
    in [0, 255) from default_rng(FEAT_SEED), as bench.py makes them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(FEAT_SEED)
    x = rng.uniform(0, 255, (FEAT_FRAMES, *FEAT_HW)).astype("float32")
    return torch.from_numpy(x).cuda()


class plain_kernels:
    """Within the block, every kernel wrapper the feature path calls is its
    plain PyTorch version on the same device: kernel A (ops.cuda_frontend.
    filter_bank, which g2_basis and g4_basis reach), B′ (the pyramid) and D′
    (the levels' descriptor samples)."""

    def __enter__(self):
        import numpy as np

        from cvsteer_tpu_torch.features import descriptors
        from cvsteer_tpu_torch.ops import cuda_desc as cd
        from cvsteer_tpu_torch.ops import cuda_frontend as cf
        from cvsteer_tpu_torch.ops import pyramid

        def bank(image, xtaps, ytaps):
            return cf.filter_bank_plain(image, np.ascontiguousarray(xtaps, np.float32),
                                        np.ascontiguousarray(ytaps, np.float32))

        def pyr(image, levels):
            out = [image]
            for _ in range(levels - 1):
                out.append(cf.pyr_down_plain(out[-1]).contiguous())
            return tuple(out)

        self.saved = [(cf, "filter_bank", cf.filter_bank), (pyramid, "pyr_down_levels", pyramid.pyr_down_levels),
                      (descriptors, "sample_patches_levels", descriptors.sample_patches_levels)]
        cf.filter_bank, pyramid.pyr_down_levels = bank, pyr
        descriptors.sample_patches_levels = cd.sample_patches_levels_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def generic_agreement(x, fcfg) -> dict:
    """The generic feature path (extract_features(cfg=fcfg) on ``x [B, H,
    W]``, float32 on the card) held against its plain versions: the
    launches of one call (counted from 0), the whole Features against the
    path with every kernel replaced by its plain version (plain_kernels),
    A at every level, B′ and D′ (at the path's keypoints, in one launch)
    bit for bit. Returns those results with the levels, the bank, the
    bases and D′'s inputs for the caller's timings."""
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.features.descriptors import _rotated_grid_coords
    from cvsteer_tpu_torch.features.frontend import _level_keypoints, extract_features
    from cvsteer_tpu_torch.filters import g2, g4
    from cvsteer_tpu_torch.ops import cuda_desc as cd
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    fm = g4 if fcfg.order == 4 else g2
    bank = g4.g4_bank() if fcfg.order == 4 else g2.g2_bank()
    basis_fn = (lambda im: g4.g4_basis(im, bank)) if fcfg.order == 4 else (lambda im: g2.g2_basis(im, bank))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    feats = extract_features(x, cfg=fcfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    with torch.no_grad(), plain_kernels():
        plain = extract_features(x, cfg=fcfg)
    torch.cuda.synchronize()
    same = {f: bool(torch.equal(a, b)) for f, a, b in zip(feats._fields, feats, plain)}

    # the kernels at the path's shapes: the pyramid (B′), the bank on
    # every level (A), the levels' keypoints sampled in one launch (D′)
    levels = [x]
    for _ in range(fcfg.levels - 1):
        levels.append(cf.pyr_down_plain(levels[-1]).contiguous())
    pyr = diff(cf.pyr_down_levels(x, fcfg.levels)[1:], levels[1:])
    a_err, a_bits, bases, kps = 0.0, True, [], []
    for lvl, lv in enumerate(levels):
        k = cf.filter_bank(lv, bank.xtaps, bank.ytaps)
        e, b = diff([k], [cf.filter_bank_plain(lv, bank.xtaps, bank.ytaps)])
        a_err, a_bits = max(a_err, e), a_bits and b
        basis, kp = _level_keypoints(lv, lvl, fcfg, basis_fn=basis_fn, coeff_fn=fm.energy_coefficients)
        bases.append(basis)
        kps.append(kp)
    counts = [k.capacity for k in kps]
    ys, xs = [], []
    for kp in kps:
        yy, xx, _, _ = _rotated_grid_coords(kp, fcfg.descriptor_grid, fcfg.descriptor_spacing)
        ys.append(yy)
        xs.append(xx)
    ys, xs = torch.cat(ys, 1).contiguous(), torch.cat(xs, 1).contiguous()
    desc = diff([cd.sample_patches_levels(bases, ys, xs, counts)],
                [cd.sample_patches_levels_plain(bases, ys, xs, counts)])
    return dict(
        feats=feats, launches=launches, same=same, pyr_down=pyr, filter_bank=(a_err, a_bits),
        desc_sample=desc, levels=levels, bank=bank, bases=bases, ys=ys, xs=xs, counts=counts,
        channels=bases[0].shape[1],
    )


def run_features() -> dict:
    """Phase 10: extract_features on feature_batch() at order 4 (the G4/H4
    bank, D′ at C = 11) and at order 2 with the 'strength' score (the G2
    generic path, D′ at C = 7): generic_agreement's checks, frames/s
    (median of FEAT_REPS warm calls) and the device ms per frame of A, B′
    and D′."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features
    from cvsteer_tpu_torch.ops import cuda_desc as cd
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.utils.profiling import device_ms

    x = feature_batch()
    out = {}
    for tag, fcfg in (("g4", FrontendConfig(order=4)), ("g2_strength", FrontendConfig(score="strength"))):
        ag = generic_agreement(x, fcfg)
        feats, levels, bank = ag["feats"], ag["levels"], ag["bank"]
        bases, ys, xs, counts = ag["bases"], ag["ys"], ag["xs"], ag["counts"]

        # frames/s: the host clock around a call that ends in a synchronize
        for _ in range(2):
            extract_features(x, cfg=fcfg)
        torch.cuda.synchronize()
        times = []
        for _ in range(FEAT_REPS):
            t0 = time.perf_counter()
            extract_features(x, cfg=fcfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        call_s = float(np.median(times))
        n = FEAT_FRAMES
        a_ms = device_ms(lambda: [cf.filter_bank(lv, bank.xtaps, bank.ytaps) for lv in levels],
                         ("filter_bank_kernel",), len(levels))
        b_ms = device_ms(lambda: cf.pyr_down_levels(x, fcfg.levels), ("pyr_down_kernel",), 1)
        d_ms = device_ms(lambda: cd.sample_patches_levels(bases, ys, xs, counts),
                         ("desc_sample_kernel",), 1)
        d_plain = device_ms(lambda: cd.sample_patches_levels_plain(bases, ys, xs, counts), reps=3)[0]
        # D′'s bound: coordinates in, 4 corner texels of C channels in, C
        # samples out; ~10 flops of coordinates per sample and 8 of lerps
        # per channel (phase 4's count)
        c = ag["channels"]
        d_bound = Bound()
        n_s = ys.numel()
        d_bound.add(n_s * (8 + 16 * c + 4 * c), n_s * (10 + 8 * c))
        out[tag] = dict(
            cfg=fcfg, launches=ag["launches"], same=ag["same"], valid=int(feats.valid.sum()),
            shape_ok=tuple(feats.desc.shape) == (n, fcfg.capacity, fcfg.descriptor_dim),
            finite=bool(torch.isfinite(feats.desc).all() and torch.isfinite(feats.yx).all()),
            pyr_down=ag["pyr_down"], filter_bank=ag["filter_bank"], desc_sample=ag["desc_sample"],
            channels=c, fps=n / call_s, call_ms=1e3 * call_s,
            kernel_ms_per_frame={"filter_bank": a_ms[0] / n, "pyr_down": b_ms[0] / n,
                                 "desc_sample": d_ms[0] / n},
            # device events per call (device_ms checks them against the launches)
            kernel_events_seen={"filter_bank": a_ms[1], "pyr_down": b_ms[1], "desc_sample": d_ms[1]},
            desc_sample_ms=d_ms[0], desc_sample_events_seen=d_ms[1], desc_sample_plain_ms=d_plain,
            desc_sample_bound=d_bound.fields(), keypoints=counts,
        )
        del feats, ag, bases, levels
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_vo_g4(images, seed: int) -> dict:
    """Phase 10 (b): A at every level, B′ and D′ at C = 11 bit for bit
    against their plain versions on phase 5's first frame at this path's
    shapes ([1, 480, 640], generic_agreement), then DeviceVO with
    frontend.order = 4 on phase 5's frames (the launches counted from 0)."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    cfg = VOConfig(frontend=FrontendConfig(order=4))
    K = cfg.intrinsics
    n = len(images)
    ag = generic_agreement(torch.as_tensor(images[0]).cuda().to(torch.float32)[None], cfg.frontend)
    agree = {k: ag[k] for k in ("same", "pyr_down", "filter_bank", "desc_sample", "channels",
                                "launches", "counts")}
    del ag
    seq = PlanesSequence(n_frames=n, image_hw=(480, 640), fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy,
                         seed=seed)
    vo = DeviceVO(cfg, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for img in images:
        vo.process_image(img)
    state = vo.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    Rs, ts = state.poses()
    gR, gt = seq.gt_arrays()
    frames = [fi for fi, _, _ in state.trajectory]
    whole = frames == list(range(n))
    return dict(
        state=state, launches=launches, fps=n / dt, captures=vo.captures, whole=whole,
        finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
        ate=ate_rmse(Rs, ts, gR[frames], gt[frames]) if whole else float("nan"),
        gate=ate_bound(seq, state, cfg), agreement=agree,
    )


def run_vo_chunk(images, sequential: dict) -> dict:
    """Phase 5b (chunks): phase 5's frames through DeviceVO.issue_chunk /
    complete_chunk, CHUNK frames a chunk, each chunk's features from one
    batched extract_features; bootstrap frames, and the rows a chunk does
    not consume, one at a time (process_frame). The sequential engine fed
    the same feature rows is the reference (and phase 5b's run, from
    single-frame extraction, is printed beside it). Then the device time of
    one replay of graph C. The chunked run, its batched front-end included,
    is timed, and its launches are counted from 0."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.cli_vo import _to_device
    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import (DeviceVO, _chunk_half, _speed_clamp_on,
                                                  _step_kwargs, _step_math)
    from cvsteer_tpu_torch.utils.metrics import StepTimer

    cfg = VOConfig()
    n = len(images)
    stack = np.stack(images).astype(np.float32)
    dev = torch.device("cuda")
    batches = [extract_features(_to_device(stack[k:k + CHUNK], dev), cfg=cfg.frontend)
               for k in range(0, n, CHUNK)]
    rows = [Features(*(f[j] for f in b)) for b in batches for j in range(b.yx.shape[0])]
    seq = DeviceVO(cfg, device="cuda")
    for f in rows:
        seq.process_frame(f)
    seq_state = seq.finalize()

    vo = DeviceVO(cfg, device="cuda")
    vo.state.timer = timer = StepTimer(sync=torch.cuda.synchronize)
    waits = [0]
    wait = vo._wait_fetch

    def counted(host):
        waits[0] += 1
        return wait(host)
    vo._wait_fetch = counted
    chunks, chunk_waits, consumed = 0, 0, []
    del batches  # the chunked run extracts its own, one batched call a chunk
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    k = 0
    while k < n:
        if k % CHUNK == 0:
            b = extract_features(_to_device(stack[k:k + CHUNK], dev), cfg=cfg.frontend)
        j0 = k % CHUNK
        if vo.map is None or j0:  # bootstrap, or the rest of a chunk a loss cut short
            vo.process_frame(Features(*(f[j0] for f in b)))
            k += 1
            continue
        span = b.yx.shape[0]
        w0 = waits[0]
        out = vo.issue_chunk(b.yx, b.desc, b.valid)
        done = vo.complete_chunk([Features(*(f[j] for f in b)) for j in range(span)], out)
        chunks += 1
        chunk_waits += waits[0] - w0
        consumed.append(done)
        for j in range(done, span):
            vo.process_frame(Features(*(f[j] for f in b)))
        k += span
    state = vo.finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    same_kf = [kf.index for kf in state.keyframes] == [kf.index for kf in seq_state.keyframes]
    d = [max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max())
         for (_, Ra, ta), (_, Rb, tb) in zip(state.trajectory, seq_state.trajectory)]
    bits = same_kf and len(state.trajectory) == len(seq_state.trajectory) and all(
        np.array_equal(Ra, Rb) and np.array_equal(ta, tb)
        for (_, Ra, ta), (_, Rb, tb) in zip(state.trajectory, seq_state.trajectory))
    d5 = [np.abs(-Ra.T @ ta + Rb.T @ tb).max()
          for (_, Ra, ta), (_, Rb, tb) in zip(state.trajectory, sequential["state"].trajectory)]
    ch, graph, _ = vo._chunks[CHUNK]
    track, promote = _step_kwargs(cfg)

    def eager():  # what C captured (DeviceVO._chunk)
        with _step_math(vo.device):
            _chunk_half(vo.map, vo._io, ch, track=track, promote=promote,
                        stop_at_keyframe=_speed_clamp_on(cfg))

    rep = replay_ms(lambda: graph.replay(), eager, reps=5)
    capture_s = timer.total_s.get("capture", 0.0)  # T and P, then C (with their warm-ups)
    return dict(
        state=state, fps=n / wall, fps_no_capture=n / (wall - capture_s), capture_s=capture_s,
        wall_s=wall, chunks=chunks, consumed=consumed,
        waits_per_chunk=chunk_waits / max(chunks, 1), same_keyframes=same_kf, bit_equal=bits,
        max_pose_diff=float(max(d, default=math.inf)), captures=vo.captures,
        keyframes=len(state.keyframes), vs_phase5b=float(max(d5, default=math.inf)),
        graph_ms=rep["device_ms"], graph_events=rep["events_per_replay"],
        launches=launches, calls=-(-n // CHUNK),
    )


def run_checkpoint_cli(roots, workdir: str) -> dict:
    """Phases 5b and 5c (checkpoints): cli_vo --checkpoint-dir with
    checkpoint_every 1, twice on one directory, on one stream (--engine
    device) and on the 8-stream classic fleet; the second run must write
    the first run's trajectory files (tests/test_cli_vo.py:343-368). Each
    save is timed (a wrapper around SlamCheckpointer.save). Each run's
    launches are counted from 0 and held to the frames it stepped: one B,
    C and D per frame on one stream, per tick on the fleet, from the frame
    each stream resumed at (cli_vo --verbose says which) to the end."""
    import contextlib
    import io as _io
    import re

    import torch

    from cvsteer_tpu_torch import cli_vo, kernels
    from cvsteer_tpu_torch.utils import checkpoint as ck

    out = {}
    save = ck.SlamCheckpointer.save
    for name, inputs in (("one stream", roots[:1]), ("fleet", roots)):
        saves = []

        def timed(self, step, state):
            t0 = time.perf_counter()
            save(self, step, state)
            saves.append(1e3 * (time.perf_counter() - t0))
        ck.SlamCheckpointer.save = timed
        tag = "ck1" if len(inputs) == 1 else "ck8"
        trajs, rcs, walls, launches, stepped = [], [], [], [], []
        try:
            for run in ("a", "b"):
                path = os.path.join(workdir, f"{tag}_{run}.txt")
                err = _io.StringIO()
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(_io.StringIO()), contextlib.redirect_stderr(err):
                    rcs.append(cli_vo.main([
                        "--input", ",".join(inputs), "--engine", "device",
                        "--checkpoint-dir", os.path.join(workdir, tag), "--set", "checkpoint_every=1",
                        "--output", path, "--verbose"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                launches.append(kernels.launch_counts())
                starts = [int(m) for m in re.findall(r"resumed at frame (\d+)", err.getvalue())]
                stepped.append(SERVE_FRAMES - (min(starts) if len(starts) == len(inputs) else 0))
                names = ([path] if len(inputs) == 1
                         else [cli_vo._stream_output_path(path, i) for i in range(len(inputs))])
                trajs.append([open(p).read() for p in names])
        finally:
            ck.SlamCheckpointer.save = save
        out[name] = dict(rcs=rcs, same=trajs[0] == trajs[1], lines=[len(t.splitlines()) for t in trajs[0]],
                         saves=len(saves), save_ms=sum(saves) / max(len(saves), 1), walls=walls,
                         launches=launches, stepped=stepped)
    return out


# --- phase 11: the mesh (parallel/) ---------------------------------------------

MESH_MAPS_SHAPE = (16, 512, 512)  # E's unit (PERF.md §6)
MESH_FEAT_SHAPE = (8, 480, 640)  # 5 levels: at S = 2 slabs of 240 ... 15 rows
MESH_SEED = 11
MESH_REPS = 5  # timed calls after one counted warm-up call; their median is the call time
MESH_TOL = {2: dict(rtol=1e-5, atol=1e-4), 4: dict(rtol=1e-4, atol=1e-3)}  # tests/test_parallel.py
MESH_FEAT_ATOL = 1e-5  # tests/test_parallel_features.py
MESH_CLI_PNGS = 16
MESH_KERNELS = ("filter_bank", "pyr_down", "desc_sample", "g2_maps", "g4_maps")
# (world, order) -> launches of one sharded_extract_features call on each rank:
# D′ on every level; at S = 2 order 4's level 4 (15 rows, halo 15) runs
# replicated: A for its basis and B′ for the step down to it
MESH_FEAT_LAUNCHES = {
    (2, 2): {"filter_bank": 0, "pyr_down": 0, "desc_sample": 5},
    (2, 4): {"filter_bank": 1, "pyr_down": 1, "desc_sample": 5},
    (1, 2): {"filter_bank": 0, "pyr_down": 0, "desc_sample": 5},
    (1, 4): {"filter_bank": 0, "pyr_down": 0, "desc_sample": 5},
}
def _mesh_inputs():
    import numpy as np

    maps = np.random.default_rng(MESH_SEED).uniform(0, 255, MESH_MAPS_SHAPE).astype(np.float32)
    feats = np.random.default_rng(FEAT_SEED).uniform(0, 255, MESH_FEAT_SHAPE).astype(np.float32)
    return maps, feats


def _host_timed(fn, before=lambda: None, reps=MESH_REPS):
    """(result, median s, summed s) of ``reps`` calls of ``fn`` on the host
    clock, each after ``before()`` with the device drained before and after
    (the staging of a sharded call blocks the host, so the sharded and the
    single-device calls are both timed this way)."""
    import statistics

    import torch

    times = []
    for _ in range(reps):
        before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), sum(times)


def _mesh_timed(fn):
    """(result, median s, staged-transport share, launches of one call) of
    ``fn`` on every rank: one counted call, then MESH_REPS calls timed by
    _host_timed, each after a barrier."""
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.parallel import halo

    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    halo.reset_transport_stats()
    out, t, total = _host_timed(fn, before=dist.barrier)
    return out, t, halo.transport_stats["seconds"] / total, launches


def _single_plain(fn):
    """``fn()`` with every kernel replaced by its plain version
    (plain_kernels), and whether it launched no kernel: the single-device
    reference of the mesh phase."""
    import torch

    from cvsteer_tpu_torch import kernels

    kernels.reset_launch_counts()
    with torch.no_grad(), plain_kernels():
        out = fn()
    torch.cuda.synchronize()
    return out, not any(kernels.launch_counts().values())


def _maps_single(x, order):
    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4

    if order == 2:
        m = fg2.steerable_pipeline_g2(x)
        return m.edges, m.lines_dark, m.lines_bright
    m = fg4.steerable_pipeline_g4(x)
    return (fg2.find_edges(m.magnitude, m.phase), fg2.find_dark_lines(m.magnitude, m.phase),
            fg2.find_bright_lines(m.magnitude, m.phase))


def _features_single(x, cfg):
    from cvsteer_tpu_torch.features.frontend import _extract_features_generic
    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4

    fm = fg4 if cfg.order == 4 else fg2
    bank = fm.g4_bank() if cfg.order == 4 else fm.g2_bank()
    basis = fm.g4_basis if cfg.order == 4 else fm.g2_basis
    return _extract_features_generic(x, cfg, basis_fn=lambda im: basis(im, bank),
                                     coeff_fn=fm.energy_coefficients)


def _mesh_rank(rank, cli_list, cli_out):
    """One rank of a mesh world on the card: the sharded maps over {space: W}
    and {data: W}, sharded_extract_features over {space: W} at orders 2 and
    4, each timed and its launches counted; rank 0 also holds each against
    the single-device version with every kernel plain, and against the
    kernel-backed one (printed, and timed as the sharded call is); then
    cli.main --mesh space=W on ``cli_list`` (every rank; rank 0 writes),
    its launches counted."""
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch import cli, kernels
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.parallel import (
        gather_blocks, make_mesh, shard_batch, sharded_extract_features, sharded_g2_maps,
        sharded_g4_maps,
    )
    from cvsteer_tpu_torch.parallel.halo import staged

    world = dist.get_world_size()
    maps_in, feat_in = _mesh_inputs()
    res = dict(backend=dist.get_backend(), world=world, rank=rank, maps={}, features={}, cli={},
               staged=staged(torch.zeros(1, device="cuda"), None))
    for mname, axes in (("space", {"space": world}), ("data", {"data": world})):
        mesh = make_mesh(axes)
        blk = shard_batch(maps_in, mesh)
        for order, fn in ((2, sharded_g2_maps), (4, sharded_g4_maps)):
            out, t, share, launches = _mesh_timed(lambda: fn(blk, mesh))
            full = gather_blocks(out, mesh)
            r = dict(s=t, share=share, launches=launches)
            if rank == 0:
                x = torch.from_numpy(maps_in).cuda()
                want, plain_only = _single_plain(lambda: _maps_single(x, order))
                kern, t1, _ = _host_timed(lambda: _maps_single(x, order))
                r.update(single_s=t1, plain_only=plain_only,
                         bit_equal=all(torch.equal(a, b) for a, b in zip(full, want)),
                         bit_equal_kernel=all(torch.equal(a, b) for a, b in zip(full, kern)),
                         max_abs_err=max(float((a - b).abs().max()) for a, b in zip(full, want)),
                         within=all(torch.allclose(a, b, **MESH_TOL[order]) for a, b in zip(full, want)),
                         finite=all(bool(torch.isfinite(a).all()) for a in full),
                         shape=tuple(full[0].shape))
                del x, want, kern
            dist.barrier()
            res["maps"][(mname, order)] = r
            del out, full
    mesh = make_mesh({"space": world})
    blk = shard_batch(feat_in, mesh)
    for order in (2, 4):
        cfg = FrontendConfig(order=order)
        out, t, share, launches = _mesh_timed(lambda: sharded_extract_features(blk, mesh, cfg))
        full = gather_blocks(out, mesh, row_dim=None)
        r = dict(s=t, share=share, launches=launches)
        if rank == 0:
            x = torch.from_numpy(feat_in).cuda()
            want, plain_only = _single_plain(lambda: _features_single(x, cfg))
            kern, t1, _ = _host_timed(lambda: _features_single(x, cfg))
            v = want.valid
            r.update(
                single_s=t1, plain_only=plain_only, valid=int(v.sum()),
                valid_equal=bool(torch.equal(full.valid, v)),
                bit_equal=all(torch.equal(a, b) for a, b in zip(full, want)),
                bit_equal_kernel=all(torch.equal(a, b) for a, b in zip(full, kern)),
                max_abs_err={f: float((a[v].float() - b[v].float()).abs().max())
                             for f, a, b in zip(want._fields, full, want) if f != "valid"},
                finite=all(bool(torch.isfinite(a.float()).all()) for a in full),
            )
            del x, want, kern
        dist.barrier()
        res["features"][order] = r
        del out, full
    for filters in ("g2", "g4"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--input", cli_list, "--output", os.path.join(cli_out, f"world{world}_{filters}"),
                       "--filters", filters, "--mesh", f"space={world}"])
        res["cli"][filters] = dict(rc=rc, s=time.perf_counter() - t0, launches=kernels.launch_counts())
    return res


def _u8_compare(got_dir, want_dir, names):
    """(max |difference|, share within 1 level, files missing) over the
    three maps of ``names`` in two output directories."""
    import numpy as np

    from cvsteer_tpu_torch.io.imageio import imread_gray_f32

    worst, within, total, missing = 0.0, 0, 0, 0
    for base in names:
        for m in MAPS:
            a = imread_gray_f32(os.path.join(got_dir, f"{base}_{m}.png"))
            b = imread_gray_f32(os.path.join(want_dir, f"{base}_{m}.png"))
            if a is None or b is None or a.shape != b.shape:
                missing += 1
                continue
            d = np.abs(a - b)
            worst, within, total = max(worst, float(d.max())), within + int((d <= 1).sum()), total + d.size
    return worst, within / max(total, 1), missing


def run_mesh(paths, workdir: str, p12: dict) -> dict:
    """Phases 11 and 12: the mesh paths on the card (see the module
    docstring); ``p12``: phase 12's inputs (the BA and pose-graph worlds,
    phase 5c's frames)."""
    import numpy as np
    import torch

    from cvsteer_tpu_torch import cli
    from cvsteer_tpu_torch.io.imageio import imread_gray_f32, imwrite_u8
    from cvsteer_tpu_torch.parallel.launch import spawn_world
    from cvsteer_tpu_torch.utils.imageproc import normalize_minmax_u8

    out = {}
    lst = os.path.join(workdir, "mesh_inputs.txt")
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths[:MESH_CLI_PNGS]]
    with open(lst, "w") as f:
        f.write("\n".join(list(paths[:MESH_CLI_PNGS]) + [os.path.join(GOLDEN_DIR, "fish.png")]) + "\n")
    cli_out = os.path.join(workdir, "mesh_out")
    t0 = time.perf_counter()
    out["p12"] = {}
    for wname, n in (("gloo2", 2), ("nccl1", 1)):
        ranks = spawn_world(_mesh_world_rank, n, args=(lst, cli_out, p12), device_type="cuda")
        out[wname] = [r["mesh"] for r in ranks]
        out["p12"][wname] = [r["p12"] for r in ranks]
    out["worlds_s"] = time.perf_counter() - t0

    # the user's launch: torchrun, 2 ranks on this one card
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "cvsteer_tpu_torch.cli", "--input", lst, "--output", os.path.join(cli_out, "torchrun"),
         "--mesh", "space=2", "--verbose"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    out["torchrun"] = dict(rc=run.returncode, s=time.perf_counter() - t0,
                           stdout=run.stdout, stderr=run.stderr)
    ref_dir = os.path.join(cli_out, "unsharded")
    out["unsharded_rc"] = cli.main(["--input", lst, "--output", ref_dir])
    # the single-device fp32 pipeline, every kernel plain, quantized as the CLI does
    fp32_dir = os.path.join(cli_out, "fp32")
    os.makedirs(fp32_dir, exist_ok=True)
    x = torch.from_numpy(np.stack([imread_gray_f32(p) for p in paths[:MESH_CLI_PNGS]])).cuda()
    maps, out["fp32_plain_only"] = _single_plain(lambda: _maps_single(x, 2))
    for m, arr in zip(MAPS, maps):
        u8 = normalize_minmax_u8(arr, axes=(-2, -1)).cpu().numpy()
        for base, img in zip(names, u8):
            imwrite_u8(os.path.join(fp32_dir, f"{base}_{m}.png"), img)
    del x
    tr = os.path.join(cli_out, "torchrun")
    out["cli_vs_unsharded"] = _u8_compare(tr, ref_dir, names)
    out["cli_vs_fp32"] = _u8_compare(tr, fp32_dir, names)
    out["cli_fish_vs_unsharded"] = _u8_compare(tr, ref_dir, ["fish"])
    return out


# --- phase 12: the sharded solvers, the sharded fleet and the runtime ---------

# (a) BA: the VO window's C = 8 cameras against a map block of 65,536
# landmarks (config 5's BA half: tests/test_ba.py's synthetic scene, its
# pose, point and drop perturbations), 10 LM iterations
MESH_BA = dict(C=8, L=65536, iterations=10, seed=0)
# (b) the pose graph: 4,541 poses (KITTI odometry sequence 00's length,
# config 5's sequence; the dataset is not in the repository, so a synthetic
# circle with its chain and ~2 P random loop closures), PCG 20 x 50
MESH_PGO = dict(P=4541, iterations=20, cg=50, seed=7)
MESH_SOLVER_REPS = 2  # timed calls (after the counted call, which warms up); their mean
MESH_BA_TOL = dict(rot=1e-3, t=1e-3)  # tests/test_parallel.py:108-115
MESH_PGO_TOL = dict(cost=1.05, rot=2e-3)  # tests/test_posegraph.py:187-189
MESH_FLEET_CAP = SERVE_PIPE_CAP  # the pipelined fleet of phase 5c
MESH_FLEET_RUNS = {"classic": {}, "pipelined": dict(pipeline=True, promote_cap=MESH_FLEET_CAP)}


def _np_exp_so3(w):
    """Rodrigues' formula for rotation vectors ``w [..., 3]`` (numpy)."""
    import numpy as np


    th = np.linalg.norm(w, axis=-1)[..., None, None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    s = np.where(th > 1e-12, np.sin(th) / np.maximum(th, 1e-12), 1.0)
    c = np.where(th > 1e-12, (1 - np.cos(th)) / np.maximum(th, 1e-12) ** 2, 0.5)
    return np.eye(3) + s * K + c * (K @ K)


def ba_world(C, L, seed, pose_err=0.02, point_err=0.05, drop=0.2):
    """tests/test_ba.py::_synthetic_ba's scene in numpy: L points in a box
    6-14 m ahead, C cameras along x with small rotations observing them
    (normalized coordinates, a share ``drop`` of the observations masked),
    the start perturbed by ``pose_err`` (cameras 1..C-1; camera 0 fixed)
    and ``point_err``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -3, 6], [3, 3, 14], (L, 3))
    R = _np_exp_so3(rng.normal(0, 0.05, (C, 3))).astype(np.float32)
    t = np.stack([[0.4 * c - 0.2 * C, 0.02 * c, 0.01 * c] for c in range(C)]).astype(np.float32)
    p = np.einsum("cij,lj->cli", R, X) + t[:, None, :]
    mask = (p[..., 2] > 0.5) & (rng.uniform(size=(C, L)) > drop)
    R0, t0 = R.copy(), t.copy()
    R0[1:] = _np_exp_so3(rng.normal(0, pose_err, (C - 1, 3))).astype(np.float32) @ R0[1:]
    t0[1:] += rng.normal(0, pose_err, (C - 1, 3)).astype(np.float32)
    return dict(uv=(p[..., :2] / p[..., 2:3]).astype(np.float32), mask=mask,
                fixed=np.arange(C) == 0, R0=R0, t0=t0,
                X0=(X + rng.normal(0, point_err, X.shape)).astype(np.float32))


def _ba_tensors(w, device):
    import torch

    from cvsteer_tpu_torch.slam.ba import BAProblem, BAState

    def T(a):
        return torch.as_tensor(a, device=device)

    return (BAProblem(uv=T(w["uv"]), mask=T(w["mask"]), fixed_cameras=T(w["fixed"])),
            BAState(R=T(w["R0"]), t=T(w["t0"]), X=T(w["X0"])))


def _geodesic_max(Ra, Rb) -> float:
    """The largest rotation angle between ``Ra`` and ``Rb`` [..., 3, 3], as
    2 asin(|Ra - Rb|_F / 2 sqrt 2) in float64: exact 0 for equal matrices
    (arccos of the float32 trace reads ~1e-3 there)."""
    import torch

    d = torch.linalg.matrix_norm(Ra.double() - Rb.double()) / (2 * math.sqrt(2))
    return float(2 * torch.asin(d.clamp(max=1.0)).max())


def _logged(fn):
    """(fn(), the collectives it made: parallel.halo.record_collectives)."""
    from cvsteer_tpu_torch.parallel import halo

    with halo.record_collectives() as log:
        out = fn()
    return out, log


def _solver_timed(fn, single, iterations):
    """(result, ms per iteration, staged share) of a sharded solver call
    (barriers, host clock, MESH_SOLVER_REPS calls; the caller has made the
    counted call, which warms the path up), and the single-device call's
    (result, ms per iteration: a warm-up, then as many calls) on rank 0,
    the other ranks waiting."""
    import torch.distributed as dist

    from cvsteer_tpu_torch.parallel import halo

    halo.reset_transport_stats()
    out, t, total = _host_timed(fn, before=dist.barrier, reps=MESH_SOLVER_REPS)
    share = halo.transport_stats["seconds"] / total
    ref = t1 = None
    if dist.get_rank() == 0:
        single()  # warm-up: the whole problem's shapes
        ref, t1, _ = _host_timed(single, reps=MESH_SOLVER_REPS)
    dist.barrier()
    return out, 1e3 * t / iterations, share, ref, None if t1 is None else 1e3 * t1 / iterations


def _mesh_solvers(world: int, ba_w, pgo_w) -> dict:
    """Phase 12 (a) and (b) on this rank: bundle_adjust_sharded over {data:
    world} against bundle_adjust, optimize_pose_graph_sharded against the
    single-device PCG, each with its collectives and ms per iteration."""
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch.parallel import make_mesh
    from cvsteer_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded, place_ba_inputs
    from cvsteer_tpu_torch.parallel.mesh import mesh_axis
    from cvsteer_tpu_torch.parallel.posegraph_sharded import (
        optimize_pose_graph_sharded, place_pose_graph,
    )
    from cvsteer_tpu_torch.slam.ba import BAProblem, bundle_adjust
    from cvsteer_tpu_torch.slam.posegraph import optimize_pose_graph

    mesh = make_mesh({"data": world})
    group = mesh_axis(mesh, "data")[2]
    out = {}
    it = MESH_BA["iterations"]
    prob, init = _ba_tensors(ba_w, "cuda")
    sst, sprob, L = place_ba_inputs(init, prob, mesh)
    _, lm_log = _logged(lambda: bundle_adjust(sst, BAProblem(*sprob), iterations=it, group=group))
    _, whole_log = _logged(lambda: bundle_adjust_sharded(init, prob, mesh, iterations=it))
    (got, stats), ms, share, ref, ms1 = _solver_timed(
        lambda: bundle_adjust_sharded(init, prob, mesh, iterations=it),
        lambda: bundle_adjust(init, prob, iterations=it), it)
    r = dict(lm_log=lm_log, whole_log=whole_log, ms=ms, share=share, ms_single=ms1, L=L,
             shard=tuple(sprob.uv.shape), cost=float(stats.cost), initial=float(stats.initial_cost),
             finite=all(bool(torch.isfinite(a).all()) for a in got), shape=tuple(got.X.shape))
    if ref is not None:
        st1, s1 = ref
        r.update(rot=_geodesic_max(got.R, st1.R), t=float((got.t - st1.t).abs().max()),
                 X=float((got.X - st1.X).abs().max()), cost_single=float(s1.cost),
                 bit_equal=all(torch.equal(a, b) for a, b in zip(got, st1)))
    out["ba"] = r
    del prob, init, sst, sprob, got, ref

    kw = dict(iterations=MESH_PGO["iterations"], cg_iterations=MESH_PGO["cg"])
    poses, graph = pgo_tensors(pgo_w, "cuda")
    placed = place_pose_graph(graph, mesh)
    _, log = _logged(lambda: optimize_pose_graph_sharded(poses, placed, mesh, **kw))
    (got, stats), ms, share, ref, ms1 = _solver_timed(
        lambda: optimize_pose_graph_sharded(poses, graph, mesh, **kw),
        lambda: optimize_pose_graph(poses, graph, solver="pcg", **kw), kw["iterations"])
    r = dict(log=log, ms=ms, share=share, ms_single=ms1, E=int(graph.i.shape[0]),
             shard=int(placed.i.shape[0]), cost=float(stats.cost),
             initial=float(stats.initial_cost), finite=bool(torch.isfinite(got.t).all()))
    if ref is not None:
        p1, s1 = ref
        r.update(rot=_geodesic_max(got.R, p1.R), cost_single=float(s1.cost),
                 bit_equal=torch.equal(got.R, p1.R) and torch.equal(got.t, p1.t))
    out["pgo"] = r
    dist.barrier()
    return out


def _fleet_run(make, stacks, lo, m, cfg, barrier=True):
    """A library serving run of phase 5c's frames through ``make()``'s
    fleet, this rank's streams lo..lo+m-1 only: per tick their images to
    the card, one extract_features over the [m, 480, 640] batch, then
    ``step`` with every other stream's frame None. Ticks from
    SERVE_PROFILE_FROM on are timed on the host clock (after a barrier of
    the world unless ``barrier`` is False). Returns each stream's (R, t)
    (finalize: a collective on a mesh), the timed seconds, the launches of
    the run and the fleet's captures."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch import kernels
    from cvsteer_tpu_torch.cli_vo import _to_device
    from cvsteer_tpu_torch.features.frontend import Features, extract_features

    n_ticks, S = stacks.shape[0], stacks.shape[1]
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    flt = make()
    t0 = None
    for k in range(n_ticks):
        if k == SERVE_PROFILE_FROM:
            torch.cuda.synchronize()
            if barrier:
                dist.barrier()
            t0 = time.perf_counter()
        imgs = np.ascontiguousarray(stacks[k, lo: lo + m], np.float32)
        batch = extract_features(_to_device(imgs, torch.device("cuda")), cfg=cfg.frontend)
        frames = [None] * S
        for i in range(m):
            frames[lo + i] = Features(*(x[i] for x in batch))
        flt.step(frames)
    flt._flush()
    torch.cuda.synchronize()
    timed = time.perf_counter() - t0
    launches = kernels.launch_counts()
    poses = [flt.finalize(i).poses() for i in range(S)]
    return dict(poses=poses, s=timed, launches=launches, captures=flt.captures,
                engine_captures=sum(e.captures for e in flt.engines), engines=len(flt.engines))


def _mesh_fleet(world: int, stacks_path: str) -> dict:
    """Phase 12 (c) on this rank: B′, C′, D′ against their plain versions
    on the rank's [S/n, 480, 640] sub-fleet batch; DeviceVOFleet(mesh=)
    classic and pipelined over {data: world}, each followed by the
    unsharded fleet on rank 0 (the others waiting at a barrier)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.parallel import make_mesh
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

    cfg = VOConfig()
    stacks = np.load(stacks_path, mmap_mode="r")
    S = stacks.shape[1]
    mesh = make_mesh({"data": world})
    m, rank = S // world, dist.get_rank()
    lo = rank * m
    fe = frontend_agreement(torch.from_numpy(np.asarray(stacks[0, lo: lo + m], np.float32)).cuda(),
                            cfg.frontend, g2_bank())
    out = dict(agree={k: fe[k] for k in PATH_KERNELS["serving"]}, batch=m,
               p3_keep_agreement=fe["p3_keep_agreement"])
    del fe
    for name, kw in MESH_FLEET_RUNS.items():
        out[name] = _fleet_run(lambda: DeviceVOFleet(cfg, n_streams=S, mesh=mesh, **kw),
                               stacks, lo, m, cfg)
        if rank == 0:
            out[f"{name} unsharded"] = _fleet_run(
                lambda: DeviceVOFleet(cfg, n_streams=S, **kw), stacks, 0, S, cfg, barrier=False)
        dist.barrier()
    return out


def _mesh_runtime(world: int) -> dict:
    """Phase 12 (d) on this rank: initialize_distributed on the joined
    world, device_barrier, allreduce_checksum of a CUDA tensor against its
    exact sum, and a Heartbeat's beats."""
    import torch
    import torch.distributed as dist

    from cvsteer_tpu_torch.parallel.multihost import (
        Heartbeat, allreduce_checksum, device_barrier, initialize_distributed,
    )

    n = 4096  # integer sums below 2^24: exact in float32
    x = torch.arange(n, dtype=torch.float32, device="cuda") - 1000.0 * dist.get_rank()
    want = sum(abs(k - 1000 * r) for r in range(world) for k in range(n))
    out = dict(joined=initialize_distributed(), barrier=device_barrier(), want=float(want),
               checksum=float(allreduce_checksum(x, dist.group.WORLD)))
    hb = Heartbeat(interval_s=0.05, timeout_s=30.0).start()
    deadline = time.monotonic() + 30.0
    while hb.beats < 2 and not hb.failed and time.monotonic() < deadline:
        time.sleep(0.02)
    hb.stop()
    out.update(beats=hb.beats, failed=hb.failed)
    return out


def _mesh_world_rank(rank, cli_list, cli_out, p12):
    """One rank of a mesh world on the card: phase 11 (_mesh_rank), then
    phase 12's solvers, fleet and runtime, each timed on this rank."""
    import torch.distributed as dist

    out = dict(mesh=_mesh_rank(rank, cli_list, cli_out))
    world = dist.get_world_size()
    t0 = time.perf_counter()
    r = dict(solvers=_mesh_solvers(world, p12["ba"], p12["pgo"]))
    r["solvers_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    r["fleet"] = _mesh_fleet(world, p12["stacks"])
    r["fleet_s"] = time.perf_counter() - t1
    r["runtime"] = _mesh_runtime(world)
    r["s"] = time.perf_counter() - t0
    out["p12"] = r
    return out


def _centers(R, t):
    import numpy as np

    return -np.einsum("fji,fj->fi", R, t)


def check_phase12(p12: dict, ref: dict, card: str):
    """Phase 12's lines and checks from the worlds' results ``p12`` (world
    name -> the ranks' results) and phase 5c's references ``ref``; returns
    (checks, launches of B′, C′, D′ per world, run and rank)."""
    import numpy as np

    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.evaluate import ate_rmse

    checks, launches = {}, {}
    note = "ranks on one card: not a multi-card figure"
    S = SERVE_STREAMS
    gts = [PlanesSequence(n_frames=SERVE_FRAMES, image_hw=(480, 640), seed=s).gt_arrays()
           for s in range(S)]
    it, P = MESH_BA["iterations"], MESH_PGO["P"]
    packed = MESH_BA["C"] ** 2 * 36 + MESH_BA["C"] * 36 + 2 * MESH_BA["C"] * 6
    for wname, ranks in p12.items():
        n = len(ranks)
        r0 = ranks[0]
        tag = f"{card} | phase 12, {wname} ({n} rank(s) on cuda:0; {note})"
        one = n == 1
        # (a) BA
        b = r0["solvers"]["ba"]
        print(f"{tag} | bundle_adjust_sharded, C = {MESH_BA['C']}, L = {MESH_BA['L']} over "
              f"{{data: {n}}} (shard {b['shard']}), {it} LM iterations: "
              f"{[round(r['solvers']['ba']['ms'], 3) for r in ranks]} ms per LM iteration per rank "
              f"(host clock, mean of {MESH_SOLVER_REPS} calls; staged share "
              f"{[round(r['solvers']['ba']['share'], 4) for r in ranks]}) against "
              f"{b['ms_single']:.3f} single-device bundle_adjust; cost {b['initial']:.4e} -> "
              f"{b['cost']:.4e} (single {b['cost_single']:.4e}); against the single device: "
              f"rotation {b['rot']:.3e} rad, t {b['t']:.3e}, X {b['X']:.3e}, bit-equal "
              f"{b['bit_equal']}; collectives per rank in the LM loop: "
              f"{b['lm_log'].count(('all_reduce', packed))} x {packed} floats, "
              f"{b['lm_log'].count(('all_reduce', 1))} scalars, {len(b['lm_log'])} in all; "
              f"bundle_adjust_sharded adds {b['whole_log'][len(b['lm_log']):]}")
        checks[f"phase 12 {wname} BA: per rank {it} all-reduces of {packed} floats, {it + 1} "
               f"scalars, nothing else; one all-gather of X after the loop"] = all(
            r["solvers"]["ba"]["lm_log"].count(("all_reduce", packed)) == it
            and r["solvers"]["ba"]["lm_log"].count(("all_reduce", 1)) == it + 1
            and len(r["solvers"]["ba"]["lm_log"]) == 2 * it + 1
            and r["solvers"]["ba"]["whole_log"] == r["solvers"]["ba"]["lm_log"]
            + [("all_gather", r["solvers"]["ba"]["shard"][1] * 3)] for r in ranks)
        checks[f"phase 12 {wname} BA: " + ("bit-equal to the single device" if one else
               f"rotation < {MESH_BA_TOL['rot']}, t within {MESH_BA_TOL['t']} of the single device")] = (
            b["finite"] and b["shape"] == (MESH_BA["L"], 3) and b["cost"] < b["initial"]
            and (b["bit_equal"] if one else b["rot"] < MESH_BA_TOL["rot"] and b["t"] <= MESH_BA_TOL["t"]))
        # (b) the pose graph
        g = r0["solvers"]["pgo"]
        log = g["log"]
        print(f"{tag} | optimize_pose_graph_sharded, P = {P}, E = {g['E']} (shard {g['shard']}), "
              f"PCG {MESH_PGO['iterations']} x {MESH_PGO['cg']} over {{data: {n}}}: "
              f"{[round(r['solvers']['pgo']['ms'], 3) for r in ranks]} ms per LM iteration per rank "
              f"(staged share {[round(r['solvers']['pgo']['share'], 4) for r in ranks]}) against "
              f"{g['ms_single']:.3f} single-device PCG; cost {g['initial']:.4e} -> {g['cost']:.4e} "
              f"(single {g['cost_single']:.4e}); rotation {g['rot']:.3e} rad from the single "
              f"device, bit-equal {g['bit_equal']}; collectives per rank: "
              f"{log.count(('all_reduce', 42 * P))} x {42 * P}, {log.count(('all_reduce', 6 * P))} "
              f"x {6 * P}, {log.count(('all_reduce', 1))} scalars, {len(log)} in all")
        L_, C_ = MESH_PGO["iterations"], MESH_PGO["cg"]
        checks[f"phase 12 {wname} PGO: per rank {L_} x {42 * P}, {L_ * C_} x {6 * P}, {L_ + 1} "
               f"scalars, nothing else"] = all(
            r["solvers"]["pgo"]["log"].count(("all_reduce", 42 * P)) == L_
            and r["solvers"]["pgo"]["log"].count(("all_reduce", 6 * P)) == L_ * C_
            and r["solvers"]["pgo"]["log"].count(("all_reduce", 1)) == L_ + 1
            and len(r["solvers"]["pgo"]["log"]) == L_ * (C_ + 2) + 1 for r in ranks)
        checks[f"phase 12 {wname} PGO: " + ("bit-equal to the single device" if one else
               f"cost <= {MESH_PGO_TOL['cost']} x, rotation < {MESH_PGO_TOL['rot']}")] = (
            g["finite"] and g["cost"] < g["initial"]
            and (g["bit_equal"] if one else g["cost"] <= MESH_PGO_TOL["cost"] * g["cost_single"]
                 + 1e-10 and g["rot"] < MESH_PGO_TOL["rot"]))
        # (c) the fleet
        f0 = r0["fleet"]
        agree = [{k: r["fleet"]["agree"][k] for k in PATH_KERNELS["serving"]} for r in ranks]
        print(f"{tag} | B′, C′, D′ against their plain versions on each rank's "
              f"[{f0['batch']}, 480, 640] sub-fleet batch: " + json.dumps(
                  [{k: {"max_abs_err": a[k][0], "bit_equal": a[k][1]} for k in a} for a in agree])
              + f"; p3 keep agreement {[r['fleet']['p3_keep_agreement'] for r in ranks]}")
        checks[f"phase 12 {wname} fleet: B′, C′, D′ bit-equal to plain on the sub-fleet batch"] = all(
            a[k][1] for a in agree for k in a) and all(
            r["fleet"]["p3_keep_agreement"] == 1.0 for r in ranks)
        for mode in MESH_FLEET_RUNS:
            sh, un = f0[mode], f0[f"{mode} unsharded"]
            timed = SERVE_FRAMES - SERVE_PROFILE_FROM
            fps = S * timed / max(r["fleet"][mode]["s"] for r in ranks)
            lc = [{k: r["fleet"][mode]["launches"][k] for k in VO_LAUNCHES_PER_FRAME} for r in ranks]
            launches[f"{wname}_{mode}"] = lc
            ate = [ate_rmse(*p, *g_) for p, g_ in zip(sh["poses"], gts)]
            ate_un = [ate_rmse(*p, *g_) for p, g_ in zip(un["poses"], gts)]
            before = [float(np.linalg.norm(_centers(*p)[:k] - _centers(*q)[:k], axis=1).max())
                      for p, q, k in zip(sh["poses"], ref["single"], ref["first_promo"])]
            same = all(np.array_equal(a, b_) for p, q in zip(sh["poses"], un["poses"])
                       for a, b_ in zip(p, q))
            print(f"{tag} | DeviceVOFleet(mesh=) {mode}"
                  + (f" (promote_cap {MESH_FLEET_CAP})" if mode == "pipelined" else "")
                  + f", S = {S} over {{data: {n}}} ({S // n} streams a rank), phase 5c's "
                  f"{SERVE_FRAMES} frames: {fps:.2f} frames/s aggregate over ticks "
                  f"{SERVE_PROFILE_FROM}-{SERVE_FRAMES - 1} against {S * timed / un['s']:.2f} "
                  f"unsharded in this world (both on the host clock, front-end included); bit-equal "
                  f"to the unsharded fleet {same}; ATE per stream {[round(a, 4) for a in ate]} "
                  f"(unsharded {[round(a, 4) for a in ate_un]}, bounds "
                  f"{[round(x, 4) for x in ref['gates']]}); camera centers apart from the "
                  f"single-stream DeviceVO's before its first promotion at most "
                  f"{[round(x, 6) for x in before]} m (bar {VO_TWIN_GAP}); captures per rank "
                  f"{[r['fleet'][mode]['captures'] for r in ranks]} (engines "
                  f"{[r['fleet'][mode]['engine_captures'] for r in ranks]}); launches per rank {lc}")
            whole = all(len(p[1]) == SERVE_FRAMES and np.isfinite(p[1]).all() for p in sh["poses"])
            checks[f"phase 12 {wname} fleet {mode}: one finite pose per frame, 2 captures a rank, "
                   f"B′, C′, D′ once a tick a rank"] = whole and all(
                r["fleet"][mode]["captures"] == 2 and r["fleet"][mode]["engine_captures"] == 0
                and r["fleet"][mode]["engines"] == S // n for r in ranks) and all(
                l_[k] == v * SERVE_FRAMES for l_ in lc for k, v in VO_LAUNCHES_PER_FRAME.items())
            if one:
                checks[f"phase 12 {wname} fleet {mode}: bit-equal to the unsharded fleet"] = same
            else:
                checks[f"phase 12 {wname} fleet {mode}: each stream at its single-stream DeviceVO "
                       f"until its first promotion, ATE within bound where the unsharded "
                       f"stream's is"] = all(x < VO_TWIN_GAP for x in before) and all(
                    a < bd for a, u, bd in zip(ate, ate_un, ref["gates"]) if u < bd)
        # (d) the runtime
        rt = [r["runtime"] for r in ranks]
        print(f"{tag} | multihost: initialize_distributed {[x['joined'] for x in rt]}, "
              f"device_barrier {[x['barrier'] for x in rt]}, allreduce_checksum "
              f"{[x['checksum'] for x in rt]} (exact {rt[0]['want']}), Heartbeat beats "
              f"{[x['beats'] for x in rt]}, failed {[x['failed'] for x in rt]}")
        checks[f"phase 12 {wname} multihost: barrier {float(n)}, checksum exact, 2 beats"] = all(
            x["joined"] == (n > 1) and x["barrier"] == float(n) and x["checksum"] == x["want"]
            and x["beats"] >= 2 and not x["failed"] for x in rt)
        print(f"{tag} | phase 12 on rank 0: {r0['s']:.1f} s (solvers {r0['solvers_s']:.1f} s, "
              f"fleet {r0['fleet_s']:.1f} s)")
    return checks, launches


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    device_name = torch.cuda.get_device_name(0)
    print(f"device: {device_name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")

    with tempfile.TemporaryDirectory(prefix="cvsteer_smoke_") as workdir:
        # 3. inputs
        t0 = time.perf_counter()
        frame, frames512, paths, fish = render_inputs(args.seed, workdir)
        print(f"inputs: {time.perf_counter() - t0:.1f} s")

        # 4. kernel checks (their launches are not the paths')
        records, ok = check_kernels(frame, frames512, fish)
        if not ok:
            return _fail("a kernel disagrees with its plain version")

        # 5. VO
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
            "VO: initialized": st.initialized,
            "VO: one pose per frame": res["frames"] == list(range(n)),
            "VO: finite poses": res["finite"],
            "VO: ATE within bound": res["ate"] < gate["bound"],
            "VO: kernels B-D launched": all(res["launches"][k] > 0 for k in PATH_KERNELS["vo"]),
            "VO: launches per frame": all(res["launches"][k] == v * n
                                          for k, v in VO_LAUNCHES_PER_FRAME.items()),
        }
        prof = profile_vo(args.seed)
        print(f"VO profile, frames {VO_PROFILE_WARM}-{VO_PROFILE_WARM + VO_PROFILE_FRAMES - 1} "
              f"of a second run (torch.profiler): {prof['kernels_per_frame']:.1f} device kernels, "
              f"{prof['copies_per_frame']:.1f} copies/memsets per frame; device busy "
              f"{100 * prof['busy_share']:.2f} % of {prof['wall_ms_per_frame']:.2f} ms per frame; "
              f"features span {prof['features_ms']:.3f} ms; kernels B-D device ms per frame "
              f"{prof['frontend_kernel_ms']}; every one of {prof['launches']} launches seen")
        checks["VO profile: device time seen"] = prof["busy_share"] > 0
        launches = {"vo": res["launches"]}

        # 5b. VO device
        dres = run_vo_device(args.frames, args.seed, res)
        dst, caps = dres["state"], dres["captures"]
        print(
            f"VO device: {n} frames 480x640 in {dres['vo_s']:.2f} s of VO time "
            f"({n / dres['vo_s']:.2f} frames/s; {dres['wall_s']:.2f} s wall, phase 5's frames); "
            f"keyframes {len(dst.keyframes)} ({dres['keyframes']} promoted on the device), "
            f"landmarks {dst.num_landmarks}"
        )
        print("VO device phase ms (mean per call): " + json.dumps(
            {k: round(v, 3) for k, v in dres["means_ms"].items()}
        ))
        print(f"VO device: ATE {dres['ate']:.4f} m, bound {dres['gate']['bound']:.4f} m; host "
              f"engine {res['ate']:.4f} m (bar on the difference {VO_TWIN_ATE}); the two "
              f"trajectories {dres['twin_ate']:.6f} m apart (bar {VO_TWIN_GAP}); "
              f"poses before the first promotion on the device (frame {dres['first_promotion']}) "
              f"within {dres['max_pose_diff_before']:.3e} m of the host engine's")
        print(f"VO device: graphs captured {caps[-1]}, first at frame "
              f"{next((i for i, c in enumerate(caps) if c), None)}; launches {dres['launches']}")
        for graph, r in dres["replay"].items():
            print(f"VO device graph {graph}: {r['device_ms']:.4f} ms device per replay "
                  f"(torch.profiler, 25 replays, each with the {r['events_per_replay']} device "
                  f"events of an eager run of its half); {r['call_ms']:.4f} ms per replay with "
                  f"the wait (CUDA events)")
        checks.update({
            "VO device: initialized": dst.initialized,
            "VO device: one pose per frame": dres["frames"] == list(range(n)),
            "VO device: finite poses": dres["finite"],
            "VO device: ATE within bound": dres["ate"] < dres["gate"]["bound"],
            "VO device: as accurate as the host engine": abs(dres["ate"] - res["ate"]) < VO_TWIN_ATE,
            "VO device: the host engine's trajectory": dres["twin_ate"] < VO_TWIN_GAP,
            "VO device: the host engine's poses until its first promotion": (
                dres["first_promotion"] is not None and dres["max_pose_diff_before"] < VO_SAME_POSE),
            "VO device: kernels B-D launched": all(dres["launches"][k] > 0
                                                   for k in PATH_KERNELS["vo_device"]),
            "VO device: launches per frame": all(dres["launches"][k] == v * n
                                                 for k, v in VO_LAUNCHES_PER_FRAME.items()),
            "VO device: 2 graphs, none after the first upload": (
                caps[-1] == 2 and set(caps) <= {0, 2} and caps == sorted(caps)),
            "VO device: promotions ran on the device": dres["keyframes"] > 0,
        })
        dprof = profile_vo(args.seed, engine="device",
                           graphs=[r["events_per_replay"] for r in dres["replay"].values()])
        print(f"VO device profile, frames {VO_PROFILE_WARM}-{VO_PROFILE_WARM + VO_PROFILE_FRAMES - 1} "
              f"of a second run (torch.profiler): {dprof['kernels_per_frame']:.1f} device kernels, "
              f"{dprof['copies_per_frame']:.1f} copies/memsets per frame; device busy "
              f"{100 * dprof['busy_share']:.2f} % of {dprof['wall_ms_per_frame']:.2f} ms per frame; "
              f"features span {dprof['features_ms']:.3f} ms; kernels B-D device ms per frame "
              f"{dprof['frontend_kernel_ms']}; every one of {dprof['launches']} launches seen, "
              f"{dprof['graph_launches']} of them graph launches with T's or P's events")
        checks["VO device profile: device time seen"] = dprof["busy_share"] > 0
        launches["vo_device"] = dres["launches"]

        # 5b (chunks): the same frames through issue_chunk / complete_chunk
        t0 = time.perf_counter()
        cres = run_vo_chunk(res["images"], dres)
        t_rep, p_rep = dres["replay"]["T"]["device_ms"], dres["replay"]["P"]["device_ms"]
        print(f"{card} | VO device chunks of {CHUNK}: {n} frames in {cres['wall_s']:.2f} s "
              f"({cres['fps']:.2f} frames/s, batched front-end included; "
              f"{cres['fps_no_capture']:.2f} without the {cres['capture_s']:.2f} s of the three "
              f"captures and their warm-ups); {cres['chunks']} chunks, "
              f"rows consumed {cres['consumed']}, {cres['waits_per_chunk']:.2f} fetches per chunk; "
              f"keyframes {cres['keyframes']}, the sequential engine's on the same feature rows: "
              f"{cres['same_keyframes']}, poses bit for bit {cres['bit_equal']} (max |diff| "
              f"{cres['max_pose_diff']:.3e}); camera centers against phase 5b's single-frame "
              f"extraction {cres['vs_phase5b']:.3e} m; captures {cres['captures']}")
        print(f"{card} | VO device graph C ({CHUNK} frames, T then masked P each): "
              f"{cres['graph_ms']:.4f} ms device per replay, {cres['graph_ms'] / CHUNK:.4f} ms per "
              f"frame (torch.profiler, 5 replays, each with the {cres['graph_events']} device "
              f"events of an eager run of the chunk); sequential T "
              f"{t_rep:.4f} + P {p_rep:.4f} ms per replay; phase {time.perf_counter() - t0:.1f} s")
        checks.update({
            "VO chunks: the sequential engine's keyframes": cres["same_keyframes"],
            f"VO chunks: the sequential engine's poses (bar {CHUNK_SAME_POSE} m)":
                cres["max_pose_diff"] <= CHUNK_SAME_POSE,
            "VO chunks: 3 graphs (T, P, C)": cres["captures"] == 3,
            "VO chunks: one fetch per chunk": cres["waits_per_chunk"] == 1.0,
            "VO chunks: B, C, D once per batched front-end call (one a chunk), A none": all(
                cres["launches"][k] == v * cres["calls"] for k, v in VO_LAUNCHES_PER_FRAME.items()),
        })
        print(f"{card} | VO device chunks: launches {cres['launches']} over {cres['calls']} "
              f"batched front-end calls of {CHUNK} frames")
        launches["chunk"] = cres["launches"]
        del cres

        # 5c. serving; PNG decodes counted from here (the codec's calls)
        from cvsteer_tpu_torch.io import native_codec

        codec_ok = native_codec.available()
        decodes = count_decodes(native_codec)
        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated()
        srv = run_serving(workdir)
        ag = srv["agree"]
        print(f"{card} | serving: B, C, D against their plain versions on the [8, 480, 640] stack: "
              + json.dumps({k: {"max_abs_err": ag[k][0], "bit_equal": ag[k][1]}
                            for k in PATH_KERNELS["serving"]})
              + f"; p3 keep agreement {ag['p3_keep_agreement']}")
        checks["serving: B, C, D bit-equal to plain at [8, 480, 640]"] = (
            all(ag[k][1] for k in PATH_KERNELS["serving"]) and ag["p3_keep_agreement"] == 1.0)
        window = f"{SERVE_PROFILE_FROM}-{SERVE_PROFILE_FROM + SERVE_PROFILE_TICKS - 1}"
        for path, r in srv["lib"].items():
            n = len(r["states"][0].trajectory)
            if math.isnan(r["busy_share"]):  # the host engine: not profiled, to save ~50 s
                prof = f"ticks {window} not profiled"
            else:
                prof = (f"ticks {window} profiled: {r['kernels_per_tick']:.1f} device kernels, "
                        f"{r['copies_per_tick']:.1f} copies/memsets per tick, device busy "
                        f"{100 * r['busy_share']:.2f} %, every one of {r['launches']} launches "
                        f"seen")
                checks[f"serving {path}: device time seen"] = r["busy_share"] > 0
            print(f"{card} | serving {path}, {SERVE_STREAMS} streams x {n} frames 480x640: "
                  f"{r['fps']:.2f} frames/s aggregate over ticks "
                  f"{SERVE_PROFILE_FROM + SERVE_PROFILE_TICKS}-{n - 1} ({r['tick_ms']:.2f} ms per "
                  f"tick, decode excluded, H2D of the stack and features included); {prof}; peak "
                  f"allocator memory above the run's start {r['peak_bytes'] / 2**20:.1f} MiB; run "
                  f"{r['wall_s']:.1f} s; "
                  f"ATE per stream {[round(a, 4) for a in r['ate']]}")
            checks[f"serving {path}: one finite pose per frame"] = r["whole"] and r["finite"]
        for path in ("fleet classic", "fleet pipelined"):
            r = srv["lib"][path]
            print(f"{card} | serving {path}: graphs captured {r['captures']}, its engines "
                  f"{r['engine_captures']}")
            checks[f"serving {path}: 2 graphs, its engines none"] = (
                r["captures"] == 2 and not any(r["engine_captures"]))
        for g, r in srv["graphs"].items():
            print(f"{card} | serving {g} (S = {SERVE_STREAMS}): {r['device_ms']:.4f} ms device per "
                  f"replay (torch.profiler, 25 replays, each with the {r['events_per_replay']} "
                  f"device events of an eager run of its half)")
        print(f"{card} | serving: single-stream DeviceVO (DeviceVOServer's engines) ATE "
              f"{[round(a, 4) for a in srv['lib']['DeviceVOServer']['ate']]}, bounds "
              f"{[round(g['bound'], 4) for g in srv['gates']]}")
        single_ate = srv["lib"]["DeviceVOServer"]["ate"]
        for path, r in srv["cli"].items():
            for line in r["stdout"]:
                print(f"{card} | serving cli_vo --engine {path}: {line}")
            st = r["streams"]
            print(f"{card} | serving cli_vo --engine {path}: rc {r['rc']}, {r['wall_s']:.1f} s "
                  f"wall with decode; per stream ATE {[round(x['ate'], 4) for x in st]}; camera "
                  f"centers apart from the single-stream DeviceVO's before its first promotion "
                  f"after initialization (frames {srv['first_promo']}) at most "
                  f"{[round(x['before'], 6) for x in st]} m (bar {VO_TWIN_GAP}); whole "
                  f"trajectories apart (Sim(3)-aligned) {[round(x['twin'], 6) for x in st]} m; "
                  f"launches {r['launches']}")
            checks[f"serving cli {path}: rc 0, one finite pose per frame per stream"] = (
                r["rc"] == 0 and all(x["whole"] and x["finite"] for x in st))
            checks[f"serving cli {path}: each stream at its single-stream DeviceVO until the "
                   f"first promotion after initialization"] = all(
                x["before"] < VO_TWIN_GAP for x in st)
            checks[f"serving cli {path}: ATE within bound where the single stream's is"] = all(
                x["ate"] < g["bound"] for x, g, a in zip(st, srv["gates"], single_ate)
                if a < g["bound"])
            checks[f"serving cli {path}: B-D once per tick"] = all(
                r["launches"][k] == SERVE_FRAMES for k in PATH_KERNELS["serving"])
        bt = srv["batching"]
        print(f"{card} | serving: seed 0's stream through a 1-stream fleet equals a DeviceVO's "
              f"bit for bit: {bt['one_equal']}; eight copies of it through an 8-stream fleet: "
              f"rows equal bit for bit: {bt['rows_equal']}, {bt['rows_apart']:.6f} m apart from "
              f"the DeviceVO's (Sim(3)-aligned)")
        checks["serving: a 1-stream fleet is DeviceVO bit for bit"] = bt["one_equal"]
        checks["serving: eight copies of a stream give eight equal rows"] = bt["rows_equal"]
        launches["serving"] = srv["cli"]["device"]["launches"]
        serve_decodes = decodes[0]
        serve_fps = {k: served_fps(r["stdout"]) for k, r in srv["cli"].items()}

        # 5b and 5c (checkpoints): cli_vo --checkpoint-dir, run twice
        t1 = time.perf_counter()
        ckr = run_checkpoint_cli([os.path.join(workdir, f"serve{s}") for s in range(SERVE_STREAMS)],
                                 workdir)
        for name, r in ckr.items():
            print(f"{card} | checkpoints, cli_vo --engine device, {name}: rc {r['rcs']}, "
                  f"{r['saves']} saves at {r['save_ms']:.2f} ms each (checkpoint_every 1), runs "
                  f"{[round(w, 2) for w in r['walls']]} s; the resumed run's trajectory files "
                  f"equal the first run's: {r['same']} ({r['lines']} poses)")
            print(f"{card} | checkpoints, {name}: launches per run {r['launches']}, frames (ticks) "
                  f"stepped per run {r['stepped']}")
            checks[f"checkpoints {name}: rc 0, resumed run writes the same trajectories"] = (
                r["rcs"] == [0, 0] and r["same"] and all(n == SERVE_FRAMES for n in r["lines"])
                and r["saves"] > 0)
            checks[f"checkpoints {name}: B, C, D once per frame (tick) stepped, A none"] = (
                r["stepped"][0] == SERVE_FRAMES and all(
                    la[k] == v * st for la, st in zip(r["launches"], r["stepped"])
                    for k, v in VO_LAUNCHES_PER_FRAME.items()))
        launches["checkpoint"] = {k: sum(la[k] for r in ckr.values() for la in r["launches"])
                                  for k in VO_LAUNCHES_PER_FRAME}
        print(f"{card} | checkpoints: {time.perf_counter() - t1:.1f} s")
        print(f"{card} | phase 5c (serving) {time.perf_counter() - t0:.1f} s (frames rendered "
              f"and written in {srv['render_s']:.1f} s, {SERVE_RENDER_WORKERS} processes)")
        # phase 12's references: the single-stream DeviceVOs of the same frames
        fleet_ref = dict(single=[s_.poses() for s_ in srv["lib"]["DeviceVOServer"]["states"]],
                         gates=[g["bound"] for g in srv["gates"]], first_promo=srv["first_promo"])
        p12_inputs = dict(
            stacks=srv["stacks_path"],
            ba=ba_world(MESH_BA["C"], MESH_BA["L"], MESH_BA["seed"]),
            pgo=pgo_world(MESH_PGO["P"], MESH_PGO["seed"], loops=2 * MESH_PGO["P"] - 2),
        )
        del srv
        gc.collect()  # the serving runs' card memory goes before phase 9's peak
        print(f"{card} | card memory allocated before phase 5c {mem0 / 2**20:.1f} MiB, after it "
              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")

        # 6. CLI
        runs, cli_checks = run_cli(frames512, paths, workdir)
        checks.update(cli_checks)
        launches.update({k: v["launches"] for k, v in runs.items() if "launches" in v})
        print(f"CLI images/s on {card}: g2 {runs['cli_g2']['images_per_s']:.2f}, "
              f"g4 {runs['cli_g4']['images_per_s']:.2f}")
        cli_decodes = decodes[0] - serve_decodes
        print(f"{card} | codec: native_codec.available() {codec_ok}; PNG decodes through it: "
              f"serving and checkpoint runs {serve_decodes}, CLI {cli_decodes}; cli_vo serving "
              f"frames/s with decode: classic {serve_fps['device']:.2f}, pipelined "
              f"{serve_fps['device --pipeline']:.2f} (PERF.md §5, the numpy decoder: 46.12 classic); "
              f"CLI images/s g2 {runs['cli_g2']['images_per_s']:.2f}, g4 "
              f"{runs['cli_g4']['images_per_s']:.2f} (PERF.md §5, the numpy decoder: 50.93 / 47.61)")
        checks["codec: available and the frames decoded through it"] = (
            codec_ok and serve_decodes >= 2 * SERVE_STREAMS * SERVE_FRAMES
            and cli_decodes >= 2 * CLI_FRAMES)
        restore_decodes(native_codec)

        # 10. the generic feature path (G4/H4 and G2 'strength')
        t0 = time.perf_counter()
        fr = run_features()
        for tag, r in fr.items():
            c = r["cfg"]
            print(f"{card} | features {tag} (order {c.order}, score {c.score}): {FEAT_FRAMES} frames "
                  f"{FEAT_HW[0]}x{FEAT_HW[1]}, {r['fps']:.2f} frames/s ({r['call_ms']:.2f} ms per "
                  f"call, median of {FEAT_REPS}); {r['valid']} valid keypoints; launches per call "
                  f"{ {k: r['launches'][k] for k in FEAT_LAUNCHES_PER_CALL} }; device ms per frame "
                  + json.dumps({k: round(v, 6) for k, v in r["kernel_ms_per_frame"].items()})
                  + " (device events seen per call " + json.dumps(r["kernel_events_seen"]) + ")"
                  + f"; D′ at C = {r['channels']}: {r['desc_sample_ms']:.4f} ms per call, plain "
                  f"{r['desc_sample_plain_ms']:.4f}, bound {r['desc_sample_bound']['bound_ms']:.4f} "
                  f"({r['desc_sample_bound']['bound_by']}); against plain: A {r['filter_bank']}, "
                  f"B′ {r['pyr_down']}, D′ {r['desc_sample']}; Features equal to the all-plain "
                  f"path: {r['same']}")
            checks.update({
                f"features {tag}: A, B′, D′ bit-equal to plain":
                    r["filter_bank"][1] and r["pyr_down"][1] and r["desc_sample"][1],
                f"features {tag}: Features equal to the all-plain path": all(r["same"].values()),
                f"features {tag}: launches per call": all(
                    r["launches"][k] == v for k, v in FEAT_LAUNCHES_PER_CALL.items()),
                f"features {tag}: shapes, finite, keypoints": (
                    r["shape_ok"] and r["finite"] and r["valid"] > FEAT_FRAMES * 100),
            })
            launches[f"features_{tag}"] = r["launches"]
            rec = {x["name"]: x for x in records}
            rec["desc_sample"].update({
                f"features_{tag}_c{r['channels']}_ms": r["desc_sample_ms"],
                f"features_{tag}_c{r['channels']}_plain_ms": r["desc_sample_plain_ms"],
                f"features_{tag}_c{r['channels']}_bound_ms": r["desc_sample_bound"]["bound_ms"],
                f"features_{tag}_c{r['channels']}_bound_by": r["desc_sample_bound"]["bound_by"],
                f"features_{tag}_c{r['channels']}_max_abs_err": r["desc_sample"][0],
                f"features_{tag}_c{r['channels']}_bit_equal": r["desc_sample"][1],
                f"features_{tag}_keypoints": r["keypoints"],
            })
            for k in ("filter_bank", "pyr_down"):
                rec[k][f"features_{tag}_device_ms_per_frame"] = r["kernel_ms_per_frame"][k]
        vg = run_vo_g4(res["images"], args.seed)
        print(f"{card} | VO device, frontend.order = 4: {len(res['images'])} frames in "
              f"{len(res['images']) / vg['fps']:.2f} s ({vg['fps']:.2f} frames/s); ATE "
              f"{vg['ate']:.4f} m (ate_bound {vg['gate']['bound']:.4f} m, printed, not gated); "
              f"keyframes {len(vg['state'].keyframes)}; captures {vg['captures']}; launches "
              f"{ {k: vg['launches'][k] for k in PATH_KERNELS['vo_g4']} }; phase 10 "
              f"{time.perf_counter() - t0:.1f} s")
        va = vg["agreement"]
        print(f"{card} | VO order 4 front-end on phase 5's first frame [1, 480, 640] against "
              f"plain: A {va['filter_bank']}, B′ {va['pyr_down']}, D′ at C = {va['channels']} "
              f"{va['desc_sample']} ({sum(va['counts'])} keypoints); Features equal to the "
              f"all-plain path: {va['same']}; launches of that call "
              f"{ {k: va['launches'][k] for k in VO_G4_LAUNCHES_PER_FRAME} }")
        checks.update({
            "VO order 4: initialized, one finite pose per frame": (
                vg["state"].initialized and vg["whole"] and vg["finite"]),
            "VO order 4: 2 graphs": vg["captures"] == 2,
            "VO order 4: A 5, B′ 1, D′ 1 launches per frame, C none": all(
                vg["launches"][k] == v * len(res["images"])
                for k, v in VO_G4_LAUNCHES_PER_FRAME.items()),
            "VO order 4: A, B′, D′ at C = 11 bit-equal to plain on one frame": (
                va["channels"] == 11 and va["filter_bank"][1] and va["pyr_down"][1]
                and va["desc_sample"][1]),
            "VO order 4: one frame's Features equal to the all-plain path": all(va["same"].values()),
            "VO order 4: launches of one frame's call": all(
                va["launches"][k] == v for k, v in VO_G4_LAUNCHES_PER_FRAME.items()),
        })
        launches["vo_g4"] = vg["launches"]
        del fr, vg
        gc.collect()

        # 11 and 12. the mesh: sharded maps, sharded features and cli --mesh,
        # then the sharded solvers, the sharded fleet and the runtime, in
        # spawned worlds on this one card
        t0 = time.perf_counter()
        mr = run_mesh(paths, workdir, p12_inputs)
        note = "all ranks share this one card: these are not multi-card figures"
        for wname in ("gloo2", "nccl1"):
            ranks = mr[wname]
            r0 = ranks[0]
            tag = (f"{card} | mesh world of {r0['world']} rank(s) on cuda:0, backend {r0['backend']}, "
                   f"collectives staged through the host: {r0['staged']} ({note})")
            for (mname, order), m in r0["maps"].items():
                shares = [r["maps"][(mname, order)]["share"] for r in ranks]
                lc = [{k: r["maps"][(mname, order)]["launches"][k] for k in MESH_KERNELS}
                      for r in ranks]
                print(f"{tag} | sharded_g{order}_maps over {{{mname}: {r0['world']}}} on "
                      f"{MESH_MAPS_SHAPE}: {MESH_MAPS_SHAPE[0] / m['s']:.2f} images/s sharded "
                      f"({1e3 * m['s']:.3f} ms per call, median of {MESH_REPS}) against "
                      f"{MESH_MAPS_SHAPE[0] / m['single_s']:.2f} single-device "
                      f"({1e3 * m['single_s']:.3f} ms, both on the host clock); staged-transport "
                      f"share per rank {[round(s, 4) for s in shares]}; against "
                      f"steerable_pipeline_g{order} with every kernel plain: max abs err "
                      f"{m['max_abs_err']:.3e}, bit-equal {m['bit_equal']}; bit-equal to the "
                      f"kernel-backed single-device call {m['bit_equal_kernel']}; launches per "
                      f"call per rank {lc}")
                checks[f"mesh {wname} G{order} maps over {mname}: the plain single device at the "
                       f"reference's bar, finite"] = (
                    m["within"] and m["finite"] and m["shape"] == MESH_MAPS_SHAPE and m["plain_only"])
            for order, f in r0["features"].items():
                shares = [r["features"][order]["share"] for r in ranks]
                lc = [{k: r["features"][order]["launches"][k] for k in MESH_KERNELS} for r in ranks]
                print(f"{tag} | sharded_extract_features order {order} over {{space: {r0['world']}}} "
                      f"on {MESH_FEAT_SHAPE}, 5 levels: {MESH_FEAT_SHAPE[0] / f['s']:.2f} frames/s "
                      f"sharded ({1e3 * f['s']:.3f} ms per call) against "
                      f"{MESH_FEAT_SHAPE[0] / f['single_s']:.2f} single-device generic path "
                      f"({1e3 * f['single_s']:.3f} ms, both on the host clock); staged-transport "
                      f"share per rank {[round(s, 4) for s in shares]}; against the generic path "
                      f"with every kernel plain: {f['valid']} keypoints, valid masks equal "
                      f"{f['valid_equal']}, bit-equal {f['bit_equal']}, max abs err "
                      + json.dumps(f["max_abs_err"]) + f"; bit-equal to the kernel-backed generic "
                      f"path {f['bit_equal_kernel']}; launches per call per rank {lc}")
                want = MESH_FEAT_LAUNCHES[(r0["world"], order)]
                checks[f"mesh {wname} features order {order}: against the plain single device, "
                       f"valid equal, fields within {MESH_FEAT_ATOL}, finite"] = (
                    f["valid_equal"] and f["finite"] and f["valid"] > MESH_FEAT_SHAPE[0] * 100
                    and max(f["max_abs_err"].values()) <= MESH_FEAT_ATOL and f["plain_only"])
                checks[f"mesh {wname} features order {order}: launches per call {want}"] = all(
                    l[k] == v for l in lc for k, v in want.items())
            for filters, c in r0["cli"].items():
                lc = [{k: r["cli"][filters]["launches"][k] for k in MESH_KERNELS} for r in ranks]
                print(f"{tag} | cli --mesh space={r0['world']} --filters {filters} in the world: rc "
                      f"{[r['cli'][filters]['rc'] for r in ranks]}, {c['s']:.3f} s for "
                      f"{MESH_CLI_PNGS + 1} images; launches per rank {lc}")
                kern = "g2_maps" if filters == "g2" else "g4_maps"
                checks[f"mesh {wname} cli {filters}: rc 0; E/E4 only where a batch skips the mesh"] = (
                    all(r["cli"][filters]["rc"] == 0 for r in ranks)
                    and [l[kern] for l in lc] == ([0] * len(lc) if r0["world"] == 1
                                                  else [1] + [0] * (len(lc) - 1)))
            launches[f"mesh_{wname}"] = {
                **{f"maps_g{o}_{m}": [r["maps"][(m, o)]["launches"] for r in ranks]
                   for (m, o) in r0["maps"]},
                **{f"features_g{o}": [r["features"][o]["launches"] for r in ranks]
                   for o in r0["features"]},
                **{f"cli_{f}": [r["cli"][f]["launches"] for r in ranks] for f in r0["cli"]},
            }
        tr = mr["torchrun"]
        skip = [ln for ln in tr["stderr"].splitlines() if ln.startswith("mesh skipped")]
        done = [ln for ln in tr["stdout"].splitlines() if ln.startswith("processed")]
        worst, within, missing = mr["cli_vs_unsharded"]
        w32, _, miss32 = mr["cli_vs_fp32"]
        wf, _, missf = mr["cli_fish_vs_unsharded"]
        print(f"{card} | torchrun --nproc-per-node 2 -m cvsteer_tpu_torch.cli --mesh space=2 (gloo, "
              f"2 ranks on cuda:0, staged through the host; {note}): rc {tr['rc']}, {tr['s']:.2f} s "
              f"with start-up; {done[0] if done else 'no processed line'}; skip lines {skip}; "
              f"{MESH_CLI_PNGS} 512x512 PNG triples against the unsharded CLI (bf16 maps): max "
              f"{worst:.0f} levels, {100 * within:.4f} % within 1; against the single-device fp32 "
              f"pipeline, every kernel plain, quantized: max {w32:.0f}; the fish against the unsharded CLI: max {wf:.0f}")
        if tr["rc"] != 0:
            print(tr["stderr"][-4000:], file=sys.stderr)
        checks["mesh torchrun cli: rc 0, every PNG, the fish's skip line"] = (
            tr["rc"] == 0 and mr["unsharded_rc"] == 0 and missing == miss32 == missf == 0
            and skip == ["mesh skipped for batch (1, 185, 256): rows 185 not divisible by space=2"])
        checks["mesh torchrun cli: equal to the plain fp32 pipeline, within 2 levels and 99.9 % "
               "within 1 of the unsharded CLI"] = (
            w32 == 0 and worst <= 2 and within >= MIN_U8_EQUAL and wf == 0 and mr["fp32_plain_only"])
        print(f"{card} | phases 11 and 12 (mesh) {time.perf_counter() - t0:.1f} s (spawned worlds "
              f"{mr['worlds_s']:.1f} s)")
        # 12. the sharded solvers, the sharded fleet and the runtime
        p12_checks, launches["fleet_mesh"] = check_phase12(mr["p12"], fleet_ref, card)
        checks.update(p12_checks)
        del mr, p12_inputs

    # 7. pyramid maps and gradients
    launches["pyramid"], pyr_checks = run_pyramid(frame)
    checks.update(pyr_checks)

    # 9. loop closure: (a) deterministic closures, (b) the campaign config
    t0 = time.perf_counter()
    lc = run_loop_closure()
    se, sm = lc["se3"], lc["sim3"]
    print(f"{card} | loop (a) SE(3) drift, 13 keyframes: accepted {se['accepted']}, newest "
          f"keyframe's rotation error {se['before'][0]:.4f} -> {se['after'][0]:.4f} rad, "
          f"translation error {se['before'][1]:.4f} -> {se['after'][1]:.4f} m; close_loops ms "
          f"{se['ms'][0]:.1f}, {se['ms'][1]:.1f}")
    print(f"{card} | loop (a) scale drift x{sm['drift']:.3f} on {sm['keyframes']} host-engine "
          f"keyframes: keyframe ATE {sm['ate_before']:.4f} m -> Sim(3) {sm['ate_sim3']:.4f} m "
          f"({sm['accepted']} accepted, {sm['ms'][0]:.1f} ms), SE(3) {sm['ate_se3']:.4f} m "
          f"({sm['accepted_se3']} accepted, {sm['ms'][1]:.1f} ms)")
    checks.update({
        "loop (a): SE(3) closure accepted": se["accepted"][0] >= 1,
        # tests/test_loopclosure.py::test_close_loops_corrects_drift's bars
        "loop (a): SE(3) rotation error halved": se["after"][0] < 0.5 * se["before"][0],
        "loop (a): SE(3) translation error cut": se["after"][1] < 0.85 * se["before"][1],
        "loop (a): Sim(3) closure accepted": sm["accepted"] >= 1,
        "loop (a): Sim(3) keyframe ATE halved": sm["ate_sim3"] <= 0.5 * sm["ate_before"],
        "loop (a): Sim(3) beats SE(3) on scale drift": sm["ate_sim3"] < sm["ate_se3"],
    })
    city = run_loop_city()
    for eng, r in (("device", city["device"]), ("host", city["host"])):
        ev = r["closures"]
        # the device engine logs a closure event when the gate lets one run;
        # the host engine logs each call of its closer (one per promotion)
        what = "closure events" if eng == "device" else "closure calls"
        print(f"{card} | loop (b) {eng} engine, CityLoop {r['n']} frames 240x320 (side "
              f"{LOOP_CITY['side']} m of the campaign's 120, {r['n']} of its 4,200 frames): "
              f"{r['n'] / r['vo_s']:.2f} frames/s of VO time; ATE {r['ate']:.4f} m, bound "
              f"{r['gate']['bound']:.4f} m; keyframes {r['keyframes']}, ground corrections "
              f"{r['ground']}, speed clamps {r['speed']}; {what} {len(ev)}, "
              f"{sum(a for a, _, _ in ev)} accepted; launches "
              f"{ {k: r['launches'][k] for k in PATH_KERNELS['loop']} }")
        print(f"{card} | loop (b) {eng} engine phase ms (mean per call): " + json.dumps(
            {k: round(v, 3) for k, v in r["means_ms"].items()}))
        for n_ev, (acc, sync_ms, solve_ms) in enumerate(ev if eng == "device" else []):
            print(f"{card} | loop (b) device closure event {n_ev}: accepted {acc}, sync "
                  f"{sync_ms} ms, verification and solve {solve_ms} ms")
        key = "loop" if eng == "device" else "loop_host"
        launches[key] = r["launches"]
        checks.update({
            f"loop (b) {eng}: one finite pose per frame": r["whole"] and r["finite"],
            f"loop (b) {eng}: ATE within bound": r["ate"] < r["gate"]["bound"],
            f"loop (b) {eng}: kernels B-D launched": all(r["launches"][k] > 0
                                                         for k in PATH_KERNELS[key]),
            f"loop (b) {eng}: ground corrections": r["ground"] >= 1,
        })
    pgo = time_pgo()
    for solver, r in pgo.items():
        print(f"{card} | loop (c) optimize_pose_graph_sim3 {solver}, {r['P']} poses, 20 LM "
              f"iterations: {r['ms']:.1f} ms; cost {r['initial']:.4g} -> {r['cost']:.4g}")
        checks[f"loop (c) PGO {solver} converges"] = r["cost"] < 0.5 * r["initial"]
    d = city["device"]
    print(f"{card} | loop (b) device engine: graphs captured {d['captures']}; peak allocator "
          f"memory {d['peak_bytes'] / 2**20:.1f} MiB; frames rendered in {d['render_s']:.1f} s "
          f"({LOOP_RENDER_WORKERS} processes); phase 9 {time.perf_counter() - t0:.1f} s")
    checks["loop (b) device: 2 graphs, none recaptured"] = d["captures"] == 2
    kc = city["kernels"]
    print(f"{card} | loop (b) kernels against their plain versions on CityLoop frame 0 (levels "
          f"{kc['shapes']}, upright descriptors): " + json.dumps(
              {k: {"max_abs_err": kc[k][0], "bit_equal": kc[k][1]} for k in PATH_KERNELS["loop"]})
          + f"; p3 keep agreement {kc['p3_keep_agreement']}")
    checks["loop (b): B, C, D bit-equal to plain at the path's shapes"] = (
        all(kc[k][1] for k in PATH_KERNELS["loop"]) and kc["p3_keep_agreement"] == 1.0)

    # 8. probes: their paths, then their kernels against the plain versions
    t0 = time.perf_counter()
    launches["probes"], probe_checks = run_probes()
    checks.update(probe_checks)
    probe_records, probe_ok = check_probe_kernels()
    records += probe_records
    checks["probes: G, S, V bit-equal, M within its tolerance"] = probe_ok
    print(f"phase 8 (probes): {time.perf_counter() - t0:.1f} s")

    for what, good in checks.items():
        print(f"check {what}: {'ok' if good else 'FAILED'}")
    if not all(checks.values()):
        return _fail("path checks failed")

    for r in records:
        phase = LAUNCHES_FROM[r["name"]]
        r["launches"] = launches[phase][r["name"]] if phase else 0
        r["launches_from"] = phase
        if r["name"] in PATH_KERNELS["features_g4"]:
            r["launches_features_g4"] = launches["features_g4"][r["name"]]
            r["launches_features_g2_strength"] = launches["features_g2_strength"][r["name"]]
            r["launches_vo_g4"] = launches["vo_g4"][r["name"]]
        if r["name"] in PATH_KERNELS["vo_device"]:
            r["launches_vo_device"] = launches["vo_device"][r["name"]]
            r["launches_loop"] = launches["loop"][r["name"]]
            r["launches_loop_host"] = launches["loop_host"][r["name"]]
            r["launches_serving"] = launches["serving"][r["name"]]
            r["launches_chunk"] = launches["chunk"][r["name"]]
            r["launches_checkpoint"] = launches["checkpoint"][r["name"]]
        if r["name"] in PATH_KERNELS["serving"]:  # per sharded fleet run (40 ticks), per rank
            r["launches_fleet_mesh"] = {k: [la[r["name"]] for la in per_rank]
                                        for k, per_rank in launches["fleet_mesh"].items()}
        if r["name"] in MESH_KERNELS:  # per sharded call (CLI: per run), per rank
            r["launches_mesh"] = {
                f"{w}_{path}": [la[r["name"]] for la in per_rank]
                for w in ("gloo2", "nccl1") for path, per_rank in launches[f"mesh_{w}"].items()}
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

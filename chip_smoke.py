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
             inside torch.profiler over 25, and call_ms, CUDA events around
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
             of one replay of T (track) and of P (promote), and the same
             profiled window as phase 5 for this engine.
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
             each and none by their engines.
6. CLI     — cvsteer_tpu_torch.cli.main on a list of the 64 frames and one
             unreadable entry, with --filters g2 and then g4 (default
             --batch 16): 192 PNGs per run, each within 1 gray level of the
             plain path's 8-bit maps on the card with >= 99.9 % of pixels
             equal, and the maps kernel launched; then the fish image
             against the decoded goldens (mean L1 <= 2.5, the reference's
             no-recode bar). Prints images/s.
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
Phase 9 runs after phase 7 and before phase 8.
Each path phase (5-9, 5b, each cli_vo run of 5c) sets the launch counts to 0
just before it and reads them just after. The line before the last is the per-kernel JSON record;
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
    An events-seen count of 0 marks a device time that device_ms took with
    CUDA events because the profiler lost every window."""
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


def profile_vo(seed: int, engine: str = "host") -> dict:
    """The VO's device picture: a second run of the default VO (``engine``
    "host", slam.vo, or "device", slam.vo_device), warmed up over
    VO_PROFILE_WARM frames, then VO_PROFILE_FRAMES frames inside
    torch.profiler. Returns device
    kernels and copies/memsets per frame, the device busy share of the
    window's host-clock time, the mean ``features`` span and the device ms
    per frame of kernels B, C and D."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_image
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO
    from cvsteer_tpu_torch.utils.metrics import StepTimer
    from cvsteer_tpu_torch.utils.profiling import device_time_attr, kernel_named

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(VO_PROFILE_WARM, n):
            step(frames[k])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    attr = device_time_attr()
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:  # the union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    names = {"pyr_down": "pyr_down_kernel", "g2_features_full": "g2_features_kernel",
             "desc_sample": "desc_sample_kernel"}
    per_kernel = {k: sum(getattr(e, attr) for e in dev if kernel_named(e.name, v)) / 1e3 / VO_PROFILE_FRAMES
                  for k, v in names.items()}
    return dict(
        kernels_per_frame=(len(dev) - len(copies)) / VO_PROFILE_FRAMES,
        copies_per_frame=len(copies) / VO_PROFILE_FRAMES,
        busy_share=busy_us / (wall_s * 1e6),
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
    from cvsteer_tpu_torch.utils.profiling import call_ms, device_ms

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
        ms, seen = device_ms(fn)
        replay[name] = dict(device_ms=ms, events_per_replay=seen, call_ms=call_ms(fn))
    return dict(
        state=state, launches=launches, ate=ate, twin_ate=twin, gate=ate_bound(seq, state, cfg),
        wall_s=wall, vo_s=timer.total_s["vo"], means_ms=timer.means_ms(), frames=frames,
        finite=bool(np.isfinite(Rs).all() and np.isfinite(ts).all()), captures=captures,
        replay=replay, keyframes=timer.count.get("keyframe", 0), first_promotion=first_promotion,
        max_pose_diff_before=float(max(same, default=math.inf)),
    )


# --- phase 5c: serving -------------------------------------------------------


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


def _busy(prof, wall_s):
    """(device events, copies / memsets, busy share) of a profiled window."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:  # the union of the device intervals
            busy_us += b - max(a, end)
            end = b
    return len(dev) - len(copies), len(copies), busy_us / (wall_s * 1e6)


def _serve(make, stacks, n_ticks, fcfg, profile=True, after=None) -> dict:
    """A library serving run: ``make()`` builds the server; per tick the
    streams' images go to the card as one [S, 480, 640] stack, one batched
    extract_features, then ``step``. Ticks SERVE_PROFILE_FROM.. are
    profiled (torch.profiler: device kernels per tick, busy share; without
    ``profile`` they only warm up), the later ones timed (aggregate
    frames/s). Returns the finalized states, the timings, the peak
    allocator memory above the run's start, and ``after(server)``'s items;
    the server goes when it returns."""
    import torch
    from torch.profiler import ProfilerActivity

    from cvsteer_tpu_torch.cli_vo import _to_device
    from cvsteer_tpu_torch.features.frontend import Features, extract_features

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
    kernels_n, copies_n, busy = math.nan, math.nan, math.nan
    if profile:
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(SERVE_PROFILE_FROM, prof_end):
                tick(k)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        kernels_n, copies_n, busy = _busy(prof, prof_s)
    t0 = time.perf_counter()
    for k in range(prof_end, n_ticks):
        tick(k)
    states = [srv.finalize(i) for i in range(S)]
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    return dict(
        states=states, fps=S * (n_ticks - prof_end) / timed_s,
        tick_ms=1e3 * timed_s / (n_ticks - prof_end), wall_s=time.perf_counter() - t_start,
        kernels_per_tick=kernels_n / SERVE_PROFILE_TICKS,
        copies_per_tick=copies_n / SERVE_PROFILE_TICKS, busy_share=busy,
        peak_bytes=torch.cuda.max_memory_allocated() - base, **(after(srv) if after else {}),
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
    from cvsteer_tpu_torch.utils.profiling import device_ms

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
            ms, seen = device_ms(lambda h=half: flt._run_half(h))
            out[g] = dict(device_ms=ms, events_per_replay=seen)
        return out

    res = {}
    res["DeviceVOServer"] = _serve(lambda: DeviceVOServer(cfg, n_streams=S), stacks,
                                   SERVE_FRAMES, cfg.frontend)
    res["fleet classic"] = _serve(lambda: DeviceVOFleet(cfg, n_streams=S), stacks,
                                  SERVE_FRAMES, cfg.frontend, after=fleet_graphs)
    res["fleet pipelined"] = _serve(
        lambda: DeviceVOFleet(cfg, n_streams=S, pipeline=True, promote_cap=SERVE_PIPE_CAP),
        stacks, SERVE_FRAMES, cfg.frontend, after=fleet_graphs)
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
    return dict(agree=agree, lib=res, graphs=graphs, cli=cli, gates=gates, render_s=render_s,
                batching=batching, first_promo=first_promo)


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


def pgo_world(P, seed, sim3=False):
    """A circle of P world->camera poses (numpy) with odometry edges and two
    closures measured from the truth with 0.01 noise, and a start drifted by
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
        g = pg.PoseGraph(i, j, T(w["Rz"]), T(w["tz"]), T([1.0] * E), fixed)
        return pg.optimize_pose_graph(pg.Poses(T(w["R0"]), T(w["t0"])), g, **kw)
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
              f"{prof['frontend_kernel_ms']}")
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
            how = ("torch.profiler" if r["events_per_replay"]
                   else "CUDA events around the replay: the profiler saw no kernel in it")
            print(f"VO device graph {graph}: {r['device_ms']:.4f} ms device per replay ({how}; "
                  f"{r['events_per_replay']:.0f} device events per replay); "
                  f"{r['call_ms']:.4f} ms per replay with the wait (CUDA events)")
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
        dprof = profile_vo(args.seed, engine="device")
        print(f"VO device profile, frames {VO_PROFILE_WARM}-{VO_PROFILE_WARM + VO_PROFILE_FRAMES - 1} "
              f"of a second run (torch.profiler): {dprof['kernels_per_frame']:.1f} device kernels, "
              f"{dprof['copies_per_frame']:.1f} copies/memsets per frame; device busy "
              f"{100 * dprof['busy_share']:.2f} % of {dprof['wall_ms_per_frame']:.2f} ms per frame; "
              f"features span {dprof['features_ms']:.3f} ms; kernels B-D device ms per frame "
              f"{dprof['frontend_kernel_ms']}")
        checks["VO device profile: device time seen"] = dprof["busy_share"] > 0
        launches["vo_device"] = dres["launches"]

        # 5c. serving
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
                        f"{100 * r['busy_share']:.2f} %")
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
            how = ("torch.profiler" if r["events_per_replay"]
                   else "CUDA events around the replay: the profiler saw no kernel in it")
            print(f"{card} | serving {g} (S = {SERVE_STREAMS}): {r['device_ms']:.4f} ms device per "
                  f"replay, {r['events_per_replay']:.0f} device events per replay ({how})")
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
        print(f"{card} | phase 5c (serving) {time.perf_counter() - t0:.1f} s (frames rendered "
              f"and written in {srv['render_s']:.1f} s, {SERVE_RENDER_WORKERS} processes)")
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
        if r["name"] in PATH_KERNELS["vo_device"]:
            r["launches_vo_device"] = launches["vo_device"][r["name"]]
            r["launches_loop"] = launches["loop"][r["name"]]
            r["launches_loop_host"] = launches["loop_host"][r["name"]]
            r["launches_serving"] = launches["serving"][r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

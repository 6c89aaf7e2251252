"""One run of one cell: set-up, the measured window, the traced window, the
comparison, the result.

Two loops, chosen by the configuration's ``serve``:

- ``fleet``: S cameras served by ``DeviceVOFleet`` (classic tick). Per
  tick the S frames are uploaded from pinned host memory as one
  ``[S, H, W]`` uint8 stack, ``extract_features`` runs on it, and
  ``DeviceVOFleet.step`` takes each stream's row; the tick ends when its
  poses are on the host. Closed loop: the next tick's frames are ready
  when the previous tick returns. Scene k of the traffic's bank joins at
  tick ``k * join_every`` (0: every stream at tick 0); the run's seed
  places the scenes in the fleet's rows.
- ``extract``: batches of B frames cycled from a pool made at set-up;
  batch j + 1 is uploaded on a copy stream while the card runs batch j
  (two upload buffers).

``peak_mem_gib`` is the allocator's peak over the program's set-up and
the window's first ``memory_steps`` ticks or batches (the traffic's): the
fleet keeps every keyframe's batched features, so its peak grows with the
ticks run, and a fixed count keeps a faster change from reading as more
memory. ``memory_peak_bytes`` is the program's peak over the whole run
(set-up, window and traced stretch).

The traffic file gives the camera motion, the joins, the pool and the
window's sampling; the configuration file the program's settings. Frames
are rendered on the device from ``--seed`` (benchmark.render) and kept on
the host as 8-bit pinned frames.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np

from benchmark import devtrace, judge, render, work
from benchmark.devtrace import span

EXTRA_WARMUP_TICKS = 60


def _seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds drawn from the run's seed."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)) for s in ss.spawn(n)]


def vo_config(cfg: dict):
    """The program's VOConfig for a configuration file."""
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.slam.vo import VOConfig

    fx, fy, cx, cy = cfg["intrinsics"]
    return VOConfig(intrinsics=Intrinsics(fx, fy, cx, cy),
                    frontend=FrontendConfig(**cfg["frontend"]), **cfg.get("vo", {}))


def _features_config(cfg: dict):
    from cvsteer_tpu_torch.features.frontend import FrontendConfig

    return FrontendConfig(**cfg["frontend"])


def _rows(feats) -> List[dict]:
    """Per-frame dicts of a batched Features (references, no copies)."""
    return [dict(yx=feats.yx[i], level=feats.level[i], desc=feats.desc[i], valid=feats.valid[i])
            for i in range(feats.yx.shape[0])]


class Run:
    """Everything one run measured, for the result line and the readers."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.setup_s = math.nan
        self.window_s = math.nan
        self.frames = 0
        self.tick_ms: List[float] = []
        self.peak_bytes = 0
        self.peak_at_steps = 0
        self.trace = None
        self.trace_frames = 0
        self.trace_ticks = 0
        self.samples: List[tuple] = []  # (program frame dicts, host uint8 frames)
        self.streams: List[dict] = []
        self.numbers: Dict[str, float] = {}
        self.counters: Dict[str, object] = {}


# -- the fleet ---------------------------------------------------------------


def _bank(traffic: dict, n: int):
    """The traffic's scene bank: n (scene seed, noise seed, Motion), the
    same for every run (traffic ``scene_seed``); a run's seed only orders
    them, so every seed gets the same work in another order."""
    seeds = _seeds(int(traffic["scene_seed"]), 2 * n + 1)
    rng = np.random.default_rng(seeds[-1])
    return [(seeds[i], seeds[n + i], render.motion_from(traffic, rng)) for i in range(n)]


def _fleet_frames(run: Run):
    """(pool [P, S, H, W] pinned uint8, each row's Motion, each row's join
    tick). Row i shows scene perm[i] of the bank (perm drawn from the run's
    seed), which joins at tick perm[i] * join_every and shows its motion's
    frame 0 there, so row T of the pool holds every stream's frame of tick
    T (mod P). Every seed gives each scene the same frames at the same
    ticks; only its row differs."""
    import torch

    cfg, tr = run.cfg, run.traffic
    S = int(cfg["streams"])
    H, W = cfg["image_hw"]
    P = int(tr["motion"]["period_frames"])
    bank = _bank(tr, S)
    perm = np.random.default_rng(abs(run.seed)).permutation(S)
    joins = [int(k) * int(tr["join_every"]) for k in perm]
    run.counters["scene_order"] = perm.tolist()
    pool = torch.empty((P, S, H, W), dtype=torch.uint8, pin_memory=run.device.type == "cuda")
    motions = []
    for i, k in enumerate(perm):
        scene_seed, noise_seed, motion = bank[k]
        R, t = motion.poses((np.arange(P) - joins[i]) % P)
        pool[:, i].copy_(render.render(render.Scene(scene_seed, run.device), R, t, (H, W),
                                       cfg["intrinsics"], noise_seed, float(tr["noise_sigma"])))
        motions.append(motion)
    return pool, motions, joins


def run_fleet(run: Run, seconds: float, trace: bool, t_start: float) -> None:
    import torch

    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

    cfg, tr, dev = run.cfg, run.traffic, run.device
    S = int(cfg["streams"])
    pool, motions, joins = _fleet_frames(run)
    P = pool.shape[0]
    _sync(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    vcfg = vo_config(cfg)
    fleet = DeviceVOFleet(vcfg, n_streams=S, device=str(dev))
    fed = [0] * S
    tick_no = [0]

    def tick():
        T = tick_no[0]
        with span("upload"):
            imgs = pool[T % P].to(dev, non_blocking=True)
        with span("frontend"):
            batch = extract_features(imgs, cfg=vcfg.frontend)
        rows = [Features(*(x[i] for x in batch)) if T >= joins[i] else None for i in range(S)]
        with span("step"):
            fleet.step(rows)
        for i in range(S):
            if T >= joins[i]:
                fed[i] += 1
        tick_no[0] += 1
        return batch

    # warm-up: every stream joins, enters the stack, and the fleet settles;
    # a stream still bootstrapping after EXTRA_WARMUP_TICKS more is left to
    # enter in the window (counted in streams_active_at_open)
    settle = int(tr["settle_ticks"])
    limit = max(joins) + settle + EXTRA_WARMUP_TICKS
    while tick_no[0] < max(joins) + settle or (not fleet.active.all() and tick_no[0] < limit):
        tick()
    _sync(dev)
    run.counters["warmup_ticks"] = tick_no[0]
    run.counters["streams_active_at_open"] = int(fleet.active.sum())
    first = list(fed)
    kf_open = sum(len(e.state.keyframes) for e in fleet.engines)
    run.setup_s = time.perf_counter() - t_start

    sample_every = int(tr["sample_every_ticks"])
    r0 = run.seed % sample_every
    n_samples = int(tr["sample_ticks"])
    mem_at = int(tr["memory_steps"])
    w0 = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        if a - w0 >= seconds:
            break
        T = tick_no[0]
        batch = tick()
        run.tick_ms.append(1e3 * (time.perf_counter() - a))
        if k % sample_every == r0 and len(run.samples) < n_samples:
            run.samples.append((_rows(batch), pool[T % P]))
        k += 1
        if k == mem_at:
            run.peak_at_steps = _peak(dev)
    _sync(dev)
    if k < mem_at:
        run.peak_at_steps = _peak(dev)
    run.counters["memory_read_at_step"] = min(k, mem_at)
    run.window_s = time.perf_counter() - w0
    run.frames = S * len(run.tick_ms)
    run.counters["window_ticks"] = len(run.tick_ms)
    run.counters["keyframes_per_tick"] = (
        sum(len(e.state.keyframes) for e in fleet.engines) - kf_open) / max(len(run.tick_ms), 1)

    if trace:
        from cvsteer_tpu_torch import kernels

        kernels.reset_launch_counts()
        n = int(tr["trace_ticks"])
        with devtrace.traced() as run.trace:
            for j in range(n):
                T = tick_no[0]
                batch = tick()
                if j == 0:
                    run.samples.append((_rows(batch), pool[T % P]))
        run.trace_ticks, run.trace_frames = n, n * S
        run.counters["launches_per_tick"] = {
            k: v / n for k, v in kernels.launch_counts().items() if v}
        run.counters["captures"] = fleet.captures
        steps = run.trace.graph_replays("step")
        run.counters["fp_tick_share"] = sum(len(g) > 1 for g in steps) / max(len(steps), 1)

    run.peak_bytes = _peak(dev)
    # the poses each stream returned since the window opened, with the truth
    for i, eng in enumerate(fleet.engines):
        got = eng.state.trajectory[first[i]: fed[i]]
        gR, gt = motions[i].poses(np.arange(first[i], fed[i]) % P)
        run.streams.append(dict(R=[np.asarray(p[1], np.float64) for p in got],
                                t=[np.asarray(p[2], np.float64) for p in got], gt_R=gR, gt_t=gt))
    del fleet
    _free(dev)


# -- batched extraction ---------------------------------------------------------


def _extract_pool(run: Run):
    """The pinned pool [NB, B, H, W] uint8: the bank's scenes at evenly
    spaced frames of their motion, the frames' order drawn from the run's
    seed (the same frames every run, in other batches)."""
    import torch

    cfg, tr = run.cfg, run.traffic
    B, NB, NS = int(cfg["batch"]), int(tr["pool_batches"]), int(tr["scenes"])
    H, W = cfg["image_hw"]
    P = int(tr["motion"]["period_frames"])
    per = NB * B // NS
    stride = max(P // per, 1)
    frames = torch.empty((NB * B, H, W), dtype=torch.uint8, device=run.device)
    for s, (scene_seed, noise_seed, motion) in enumerate(_bank(tr, NS)):
        R, t = motion.poses(np.arange(per) * stride)
        frames[s::NS] = render.render(render.Scene(scene_seed, run.device), R, t, (H, W),
                                      cfg["intrinsics"], noise_seed, float(tr["noise_sigma"]))
    order = torch.from_numpy(np.random.default_rng(abs(run.seed)).permutation(NB * B))
    pool = torch.empty((NB, B, H, W), dtype=torch.uint8, pin_memory=run.device.type == "cuda")
    pool.copy_(frames[order.to(run.device)].reshape(NB, B, H, W))
    return pool


def run_extract(run: Run, seconds: float, trace: bool, t_start: float) -> None:
    import torch

    from cvsteer_tpu_torch.features.frontend import extract_features

    cfg, tr, dev = run.cfg, run.traffic, run.device
    pool = _extract_pool(run)
    NB, B = pool.shape[:2]
    _sync(dev)
    gc.collect()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fcfg = _features_config(cfg)
    # two upload buffers: batch j + 1 uploads while batch j runs on the card
    bufs = [torch.empty(pool.shape[1:], dtype=torch.uint8, device=dev) for _ in range(2)]
    copy = torch.cuda.Stream(dev) if cuda else None
    copied, done = [None] * 2, [None] * 2
    state = dict(j=0)

    def issue_copy(j):
        """Upload batch j into its buffer once batch j - 2 is done with it."""
        slot = j % 2
        with span("upload"):
            if cuda:
                if done[slot] is not None:
                    done[slot].synchronize()
                with torch.cuda.stream(copy):
                    bufs[slot].copy_(pool[j % NB], non_blocking=True)
                    copied[slot] = torch.cuda.Event()
                    copied[slot].record(copy)
            else:
                bufs[slot].copy_(pool[j % NB])

    def step():
        j = state["j"]
        slot = j % 2
        if j == 0:
            issue_copy(0)
        issue_copy(j + 1)
        if cuda:
            torch.cuda.current_stream(dev).wait_event(copied[slot])
        with span("frontend"):
            feats = extract_features(bufs[slot], cfg=fcfg)
        if cuda:
            done[slot] = torch.cuda.Event()
            done[slot].record()
        state["j"] = j + 1
        return feats, j % NB

    for _ in range(int(tr["warmup_batches"])):
        step()
    _sync(dev)
    run.setup_s = time.perf_counter() - t_start

    every = int(tr["sample_every_batches"])
    r0 = run.seed % every
    mem_at = int(tr["memory_steps"])
    w0 = time.perf_counter()
    k = 0
    while time.perf_counter() - w0 < seconds:
        feats, b = step()
        if k % every == r0 and len(run.samples) < int(tr["sample_batches"]):
            run.samples.append((_rows(feats), pool[b]))
        k += 1
        if k == mem_at:
            run.peak_at_steps = _peak(dev)
    _sync(dev)
    if k < mem_at:
        run.peak_at_steps = _peak(dev)
    run.counters["memory_read_at_step"] = min(k, mem_at)
    run.window_s = time.perf_counter() - w0
    run.frames = k * B
    run.counters["window_batches"] = k

    if trace:
        from cvsteer_tpu_torch import kernels

        kernels.reset_launch_counts()
        n = int(tr["trace_batches"])
        with devtrace.traced() as run.trace:
            for i in range(n):
                feats, b = step()
                if i == 0:
                    run.samples.append((_rows(feats), pool[b]))
        run.trace_frames = n * B
        run.counters["launches_per_batch"] = {
            k: v / n for k, v in kernels.launch_counts().items() if v}
    run.peak_bytes = _peak(dev)
    del bufs
    _free(dev)


# -- shared ------------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def judge_run(run: Run) -> None:
    """The comparison, once the window has closed and the program's state
    is freed: the sampled frames through the reference, in blocks."""
    import torch

    from benchmark import reference

    fcfg = run.cfg["frontend"]
    block = int(run.traffic.get("reference_block", 4))
    frames, refs = [], []
    for rows, host in run.samples:
        imgs = host.to(run.device)
        for lo in range(0, len(rows), block):
            with torch.no_grad():
                refs += reference.features(imgs[lo: lo + block], fcfg, "float64")
            frames += rows[lo: lo + block]
    run.numbers.update(judge.frontend_numbers(frames, refs, int(fcfg.get("levels", 5))))
    run.counters["frames_compared"] = len(frames)
    if run.streams:
        pn = judge.pose_numbers(run.streams, int(run.traffic["pose_gap_frames"]))
        for k in [k for k in pn if k.startswith("_")]:
            run.counters[k[1:]] = pn.pop(k)
        run.numbers.update(pn)


LOOPS = {"fleet": run_fleet, "extract": run_extract}


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device) -> Run:
    run = Run(cfg, traffic, seed, device)
    LOOPS[cfg["serve"]](run, seconds, trace, t_start)
    judge_run(run)
    return run


def end_to_end(run: Run, names) -> Dict[str, float]:
    vals = {
        "frames_per_s": run.frames / run.window_s if run.window_s > 0 else None,
        "tick_p95_ms": (float(np.percentile(run.tick_ms, 95, method="linear"))
                        if len(run.tick_ms) >= 20 else None),
        "peak_mem_gib": run.peak_at_steps / 2**30,
        "setup_s": run.setup_s,
    }
    return {k: vals.get(k) for k in names}


def frontend_work(run: Run) -> dict:
    cfg = run.cfg
    batch = int(cfg["streams"]) if cfg["serve"] == "fleet" else int(cfg["batch"])
    return work.frontend_work(batch, cfg["image_hw"], cfg["frontend"], in_bytes=1)

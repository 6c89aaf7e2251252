"""Re-check the device timer's windows on the card, window by window.

    python -m cvsteer_tpu_torch.kernels.profiler_windows [--windows 50] [--reps 25]
                                                        [--cases b,grid,conv,e,m]
                                                        [--variants plain,padded,timer]
                                                        [--drift SECONDS]

The cases on record where a profiled window saw fewer device events than it
made launches: kernel B′ on 32x480x640 (``pyr_down_levels``, 5 levels),
kernel D's library call (``F.grid_sample`` on 5 levels' 7-channel bases,
5 calls), kernel B's library call (a stride-2 reflect ``nn.Conv2d`` on 4
levels, 4 calls), and kernels E (``g2_maps``, 16x512x512) and M (its 6
probe calls). For each case and each variant it takes ``--windows``
windows of ``reps`` calls after warm-up:

- ``plain``: a bare torch.profiler window around the calls and a
  synchronize (the timer's window before it was mended); records the
  runtime's launch calls that have no device event (matched by correlation
  id in kineto's raw events), where in the window they are, and how long
  after the first launch call kineto's clock puts the first device event
  (negative: before it);
- ``padded``: the same with utils.profiling.WINDOW_PAD_S of idle time after
  its start and after the synchronize, no primers;
- ``timer``: utils.profiling.device_ms itself (pads and primers); a window
  it refuses counts as one with a lost launch.

``--drift SECONDS`` instead keeps the card busy and every ~5 s takes one
utils.profiling.device_window of the first case, printing the process's
age, the launches without a device event and the launch-to-event lags.

What the windows showed on the H100 is in PERF.md ("The device timer").
Prints one summary line per case and variant. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from cvsteer_tpu_torch.utils.profiling import LAUNCH_API

VARIANTS = ("plain", "padded", "timer")


def _cases(names):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.ops import cuda_probes as cp
    from cvsteer_tpu_torch.utils.precision import precise

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    out = {}
    bank = g2_bank()
    xt, yt = bank.xtaps, bank.ytaps
    shapes = [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40)]
    if "b" in names:
        x32 = torch.from_numpy(rng.uniform(0, 255, (32, 480, 640)).astype(np.float32)).to(dev)
        out["b"] = ("B′ pyr_down_levels 32x480x640", lambda: cf.pyr_down_levels(x32, 5),
                    ("pyr_down_kernel",), 1)
    if "grid" in names:
        bases = [torch.from_numpy(rng.standard_normal((1, 7, h, w)).astype(np.float32)).to(dev)
                 for h, w in shapes]
        grids = [torch.from_numpy(rng.uniform(-1, 1, (1, 256, 16, 2)).astype(np.float32)).to(dev)
                 for _ in shapes]

        def grid():
            for b, g in zip(bases, grids):
                F.grid_sample(b, g, mode="bilinear", padding_mode="border", align_corners=True)
        out["grid"] = ("D library F.grid_sample x5", grid, (), None)
    if "conv" in names:
        levels = [torch.from_numpy(rng.uniform(0, 255, (1, 1, h, w)).astype(np.float32)).to(dev)
                  for h, w in shapes[:4]]
        conv = torch.nn.Conv2d(1, 1, 5, stride=2, padding=2, padding_mode="reflect", bias=False).to(dev)

        def convs():
            with torch.no_grad(), precise():
                for lv in levels:
                    conv(lv)
        out["conv"] = ("B library nn.Conv2d stride 2 x4", convs, (), None)
    if "e" in names or "m" in names:
        batch = torch.from_numpy(rng.uniform(0, 255, (16, 512, 512)).astype(np.float32)).to(dev)
    if "e" in names:
        out["e"] = ("E g2_maps 16x512x512", lambda: cf.g2_maps(batch, xt, yt), ("maps_kernel",), 1)
    if "m" in names:
        timed = [("row", "fp32", "bf16x3"), ("col", "fp32", "bf16x3"), ("coeff", "fp32", "bf16x3"),
                 ("full", "fp32", "bf16x3"), ("full", "mma", "bf16x3"), ("full", "fp32", "bf16x1")]

        def mma():
            for c in timed:
                cp.maps_mma(batch, xt, yt, *c)
        out["m"] = ("M the 6 probe calls 16x512x512", mma, ("mma_maps_kernel",), len(timed))
    return out


def _window(fn, names, per_call, reps, variant) -> tuple:
    """One window: the positions of its launches that have no device event,
    and the first device event's start after the first launch call (us;
    None for the timer)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cvsteer_tpu_torch.utils.profiling import WINDOW_PAD_S, ShortWindowError, device_ms

    if variant == "timer":
        try:
            device_ms(fn, names, per_call, reps=reps)
            return [], None
        except ShortWindowError:
            return [0], None
    pad = WINDOW_PAD_S if variant == "padded" else 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    raw = prof.profiler.kineto_results.events()
    dev = [e for e in raw if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    seen = {e.correlation_id() for e in dev}
    launches = sorted((e for e in raw if e.device_type() == DeviceType.CPU and LAUNCH_API.match(e.name())),
                      key=lambda e: e.start_ns())
    lag = (min(e.start_ns() for e in dev) - launches[0].start_ns()) / 1e3 if dev and launches else None
    return [i for i, e in enumerate(launches) if e.correlation_id() not in seen], lag


def _drift(cases, seconds: float, reps: int) -> int:
    """Windows over a process's life: each ~5 s, after busy work, one
    device_window of ``reps`` calls of the first case; one JSON line each."""
    import torch

    from cvsteer_tpu_torch.utils.profiling import device_window

    _, fn, _, _ = next(iter(cases.values()))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t_busy = time.perf_counter()
        while time.perf_counter() - t_busy < 5.0:
            fn()
        torch.cuda.synchronize()
        with device_window() as win:
            for _ in range(reps):
                fn()
        lo, hi = win.lag_ms()
        order = sorted(win.launches, key=lambda e: e.start_ns())
        missing = {e.correlation_id() for e in win.unseen()}
        print(json.dumps(dict(age_s=round(time.perf_counter() - t0, 1), launches=len(win.launches),
                              unseen=len(missing), lag_ms_min=lo, lag_ms_max=hi,
                              unseen_positions=[i for i, e in enumerate(order) if e.correlation_id() in missing])),
              flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=50)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--cases", default="b,grid,conv,e,m")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--drift", type=float, default=0.0, metavar="SECONDS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cases = _cases(args.cases.split(","))
    if args.drift:
        return _drift(cases, args.drift, args.reps)
    for label, fn, names, per_call in cases.values():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for variant in args.variants.split(","):
            wins = [_window(fn, names, per_call, args.reps, variant) for _ in range(args.windows)]
            lags = [lag for _, lag in wins if lag is not None]
            print(json.dumps(dict(case=label, variant=variant, windows=args.windows,
                                  windows_without_lost_launch=sum(1 for w, _ in wins if not w),
                                  lost_launches=sum(len(w) for w, _ in wins),
                                  lost_positions=sorted({p for w, _ in wins for p in w}),
                                  first_event_lag_us=[min(lags), max(lags)] if lags else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

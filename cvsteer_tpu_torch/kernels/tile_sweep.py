"""Tile shapes of kernel C on the card: halo recompute against occupancy.

    python -m cvsteer_tpu_torch.kernels.tile_sweep [--tiles 32x64,16x64,...]

Builds ``csrc/g2_features.cu`` once per tile shape (``-DCVS_C_TILE_H``,
``-DCVS_C_TILE_W``, with ``-Xptxas -v`` for its registers and spills, all
builds started together) into ``_build/sweep/``, runs each on the 5-level
pyramid of a 480x640 frame (the VO path's shapes), checks it bit for bit
against the plain version, and prints one JSON line per shape: registers,
spills, shared memory per block, blocks per SM, tiles, and the device time
per frame (torch.profiler over 25 calls). Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

from cvsteer_tpu_torch import kernels

DEFAULT_TILES = "32x64,16x64,32x32,64x64,16x128,32x128,64x32"


def _build(th: int, tw: int):
    """Start nvcc for one tile shape; returns (process, library path)."""
    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libg2_features_{th}x{tw}.so")
    srcs = [os.path.join(kernels.CSRC, f) for f in ("g2_features.cu", "filter_bank.cu")]
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "--ptxas-options=-v", "-shared",
           f"-DCVS_C_TILE_H={th}", f"-DCVS_C_TILE_W={tw}", "-o", lib, *srcs]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def _ptxas(log: str, radius: int):
    """(registers, spill bytes) of g2_features_kernel<radius> in a ptxas log."""
    m = re.search(rf"Function properties for \S*g2_features_kernelILi{radius}E\S*\n(.*?)\n(.*?)\n", log)
    if not m:
        return None, None
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", m.group(1)))
    regs = re.search(r"Used (\d+) registers", m.group(2))
    return (int(regs.group(1)) if regs else None), spills


def _device_ms(fn, reps: int = 25) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t = [e.time_range.elapsed_us() for e in prof.events()
         if e.device_type == DeviceType.CUDA and "g2_features_kernel" in e.name]
    if not t:
        raise RuntimeError("torch.profiler reported no device time for g2_features_kernel")
    return sum(t) / len(t) / 1e3


def main(argv=None) -> int:
    import numpy as np
    import torch

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default=DEFAULT_TILES)
    ap.add_argument("--nms-radius", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", file=sys.stderr)
        return 1
    tiles = [tuple(int(v) for v in t.split("x")) for t in args.tiles.split(",")]
    builds = [(t, *_build(*t)) for t in tiles]

    bank = g2_bank()
    frame = torch.from_numpy(PlanesSequence(n_frames=1, seed=0).render(0)).cuda()[None]
    levels = [frame.contiguous()]
    for _ in range(4):
        levels.append(cf.pyr_down_plain(levels[-1]).contiguous())
    want = [cf.g2_features_full_plain(lv, bank.xtaps, bank.ytaps, threshold=1.0,
                                      nms_radius=args.nms_radius) for lv in levels]
    props = torch.cuda.get_device_properties(0)
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    radius = (bank.xtaps.shape[1] - 1) // 2
    ok = True
    for (th, tw), proc, path in builds:
        _, log = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: nvcc for {th}x{tw}:\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(path)
        fn = lib.cvs_g2_features
        fn.argtypes, fn.restype = kernels._SIGNATURES["cvs_g2_features"], ctypes.c_int
        lib.cvs_error_string.argtypes, lib.cvs_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
        kernels._lib = lib  # the wrapper launches this build
        call = lambda: cf.g2_features_levels(levels, bank.xtaps, bank.ytaps,  # noqa: E731
                                             threshold=1.0, nms_radius=args.nms_radius)
        got = call()
        same = all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
        ok &= same
        # the kernel's shared-memory layout (g2_features.cu Layout), 6 row passes
        hs = args.nms_radius + 1
        sh, sw = th + 2 * hs, tw + 2 * hs
        swr, shc = -(-sw // 8) * 8, -(-sh // 8) * 8
        ih, iw, rs = shc + 2 * radius, (swr + 2 * radius) | 1, swr | 1
        smem = 4 * (ih * iw + 6 * ih * rs + sh * sw)
        regs, spills = _ptxas(log, radius)
        n_tiles = sum(-(-lv.shape[-1] // tw) * -(-lv.shape[-2] // th) for lv in levels)
        print(json.dumps(dict(
            tile=f"{th}x{tw}", bit_equal=same, registers=regs, spill_bytes=spills,
            smem_bytes=smem, blocks_per_sm=min(2, smem_sm // (smem + 1024)), tiles=n_tiles,
            halo_factor=(ih * swr + shc * sw) / (2 * th * tw), device_ms=_device_ms(call),
            card=torch.cuda.get_device_name(0),
        )), flush=True)
    kernels._lib = None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

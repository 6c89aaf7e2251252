"""Tile shapes of kernels C, A, E, E4, B, F and M on the card, and every
kernel's registers and spills.

    python -m cvsteer_tpu_torch.kernels.tile_sweep [--kernel c|a|e|e4|b|f|m|ptxas] [--tiles 32x64,...]
                                                   [--strips 4,8] [--row-strips 2] [--block-levels 4]
                                                   [--define MACRO=VALUE ...]

``c``, ``a``, ``e``, ``e4``, ``b`` and ``f`` build the kernel's source once per
shape (``-D`` macros, ``-Xptxas -v`` for registers and spills, all builds
started together) into ``_build/sweep/``, run each build through the
kernel's wrapper at its path's shapes, check it bit for bit against the
plain version, and print one JSON line per shape: registers, spill bytes,
shared memory per block, blocks per SM (by registers, shared memory and
threads) and device ms (utils.profiling.device_ms: torch.profiler over 25
calls).

- ``c`` (g2_features.cu, ``CVS_C_TILE_H/W``): the 5-level pyramid of a
  480x640 frame, one launch; ms per frame.
- ``a`` (filter_bank.cu, ``CVS_A_TILE_H/W`` and the row-strip width
  ``CVS_A_ROW_STRIP``, each of ``--row-strips``): the same 5 levels, one
  launch per level, with the G2/H2 bank (R = 4) and the G4/H4 bank
  (R = 6); ms per frame for each.
- ``e4`` (g4_maps.cu, ``CVS_E4_TILE_H/W``, the column-strip height
  ``CVS_E4_STRIP_H`` and the row-strip width ``CVS_E4_ROW_STRIP``, each
  tile with each of ``--strips`` and ``--row-strips``): the CLI's
  16x512x512 batch with bfloat16 maps; ms per batch.
- ``e`` (g2_maps.cu, ``CVS_E_TILE_H/W``, ``CVS_E_STRIP_H``,
  ``CVS_E_ROW_STRIP``): the same for kernel E, the G2/H2 maps
  (g2_feature_maps.cu, E′, takes the same macros).
- ``b`` (pyr_down.cu, ``CVS_B_TILE_H/W``, the tile of the deepest level a
  block builds, and that depth ``CVS_B_LEVELS``, each of
  ``--block-levels``): the 5-level pyramid of a 480x640 frame in one launch
  (the VO path's call), and the same launch for 2, 3 and 4 levels (2: one
  pyramid step); ms per call.
- ``f`` (filter_bank_adj.cu, ``CVS_F_TILE_H/W``, the column-strip height
  ``CVS_F_COL_STRIP`` and the row-strip width ``CVS_F_ROW_STRIP``): the
  gradient phase's 1x480x640 with the G2/H2 (K 7, T 9) and G4/H4 (K 11,
  T 13) banks; ms per call of each.
- ``m`` (probe_maps_mma.cu, the probes' kernel M, tile width
  ``CVS_M_TILE_W``; its tile height is 64, wgmma's M): every case of
  ``cuda_probes.MMA_CASES`` on the probes' 16x512x512 batch within
  ``cuda_probes.mma_agreement``'s tolerance, the launch shape the source
  reports (``cvs_probe_mma_config``: shared bytes, threads and blocks per
  SM of the full bf16x3 instantiation) and device ms per case and for the
  unit of PERF.md's row V3 (the six calls of the probes).

``ptxas`` builds the whole library with ``-Xptxas -v`` and prints one JSON
line per kernel instantiation (registers, spill bytes) and a last line with
the number of instantiations that spill. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.utils.profiling import device_ms

DEFAULT_TILES = {
    "c": "32x64,16x64,32x32,64x64,16x128,32x128,64x32",
    "a": "32x64,32x32,16x64,64x32,16x32,8x64,64x64",
    "e4": "32x32,32x64,64x32,48x32,16x64",
    "e": "32x64,64x32,32x32,16x64",
    "b": "2x4,2x8,4x4,4x8",
    "f": "32x32,16x32,32x16,16x64,32x64,64x32",
    "m": "64x64,64x32,64x48,64x80",
}
SOURCES = {  # kernel -> its source, the macros of its tile height and width, column-strip
    # height and row-strip width (None: fixed in the source), its ctypes entry
    "c": ("g2_features.cu", ("CVS_C_TILE_H", "CVS_C_TILE_W", None, None), "cvs_g2_features"),
    "a": ("filter_bank.cu", ("CVS_A_TILE_H", "CVS_A_TILE_W", None, "CVS_A_ROW_STRIP"),
          "cvs_filter_bank"),
    "e4": ("g4_maps.cu", ("CVS_E4_TILE_H", "CVS_E4_TILE_W", "CVS_E4_STRIP_H", "CVS_E4_ROW_STRIP"),
           "cvs_maps_g4"),
    "e": ("g2_maps.cu", ("CVS_E_TILE_H", "CVS_E_TILE_W", "CVS_E_STRIP_H", "CVS_E_ROW_STRIP"),
          "cvs_maps_g2"),
    # for b the third macro is the depth a block builds (--block-levels)
    "b": ("pyr_down.cu", ("CVS_B_TILE_H", "CVS_B_TILE_W", "CVS_B_LEVELS", None), "cvs_pyr_down_levels"),
    "f": ("filter_bank_adj.cu", ("CVS_F_TILE_H", "CVS_F_TILE_W", "CVS_F_COL_STRIP", "CVS_F_ROW_STRIP"),
          "cvs_filter_bank_adj"),
    # M's tile height is wgmma's M (64), fixed in the source
    "m": ("probe_maps_mma.cu", (None, "CVS_M_TILE_W", None, None), "cvs_probe_mma"),
}
#: the six M calls of the probes (profile_variants, profile_frontend): row V3's unit
MMA_UNIT = (("row", "fp32", "bf16x3"), ("col", "fp32", "bf16x3"), ("coeff", "fp32", "bf16x3"),
            ("full", "fp32", "bf16x3"), ("full", "mma", "bf16x3"), ("full", "fp32", "bf16x1"))
SMEM_PER_SM = 233472  # H100: 228 KB of shared memory per SM, 1 KB of it reserved per block


def ptxas_usage(log: str):
    """[(mangled kernel name, registers, spill bytes)] from an ``-Xptxas -v``
    log: each kernel's "Function properties" block."""
    out = []
    for name, props, used in re.findall(r"Function properties for (\S+)\n(.*?)\n(.*?)\n", log):
        regs = re.search(r"Used (\d+) registers", used)
        if regs is None:
            continue  # a device function's block
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", props))
        out.append((name, int(regs.group(1)), spills))
    return out


def _demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(kernels._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    got = res.stdout.splitlines()
    return got if res.returncode == 0 and len(got) == len(names) else list(names)


def _build(kernel: str, tag: str, defines):
    """Start nvcc for one shape of ``kernel``; returns (process, library)."""
    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{kernel}_{tag}.so")
    srcs = [os.path.join(kernels.CSRC, f) for f in sorted({SOURCES[kernel][0], "filter_bank.cu"})]
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "--ptxas-options=-v", "-shared",
           *(f"-D{k}={v}" for k, v in defines.items()), "-o", lib, *srcs]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def _load(path: str, entry: str):
    """Load a sweep build and make the wrappers launch it."""
    lib = ctypes.CDLL(path)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = kernels._SIGNATURES[entry], ctypes.c_int
    lib.cvs_error_string.argtypes, lib.cvs_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    kernels._lib = lib


def _usage(log: str, pattern: str):
    """(max registers, total spill bytes) of the kernels whose mangled name
    matches ``pattern``."""
    hits = [(r, s) for name, r, s in ptxas_usage(log) if re.search(pattern, name)]
    if not hits:
        return None, None
    return max(r for r, _ in hits), sum(s for _, s in hits)


def _blocks_per_sm(regs, smem: int, threads: int = 256) -> int:
    by_smem = SMEM_PER_SM // (smem + 1024)
    by_threads = 2048 // threads
    if regs is None:
        return min(by_smem, by_threads)
    per_warp = -(-regs * 32 // 256) * 256  # registers are allocated 256 per warp
    return min(by_smem, by_threads, 65536 // (per_warp * (threads // 32)))


def _bank_smem(th: int, tw: int, radius: int, n_rows: int) -> int:
    """Shared bytes of one tile of kernels A and E (bank_core.cuh BankTile)."""
    ih = th + 2 * radius
    return 4 * (ih * ((tw + 2 * radius) | 1) + n_rows * ih * (tw | 1))


def _frame_levels():
    import torch

    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    frame = torch.from_numpy(PlanesSequence(n_frames=1, seed=0).render(0)).cuda()[None]
    levels = [frame.contiguous()]
    for _ in range(4):
        levels.append(cf.pyr_down_plain(levels[-1]).contiguous())
    return levels


def sweep_c(builds, nms_radius: int):
    import torch

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    bank, levels = g2_bank(), _frame_levels()
    want = [cf.g2_features_full_plain(lv, bank.xtaps, bank.ytaps, threshold=1.0,
                                      nms_radius=nms_radius) for lv in levels]
    radius = (bank.xtaps.shape[1] - 1) // 2
    for (th, tw, _, _), log, path in builds:
        _load(path, "cvs_g2_features")
        call = lambda: cf.g2_features_levels(levels, bank.xtaps, bank.ytaps,  # noqa: E731
                                             threshold=1.0, nms_radius=nms_radius)
        got = call()
        same = all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
        # the kernel's shared-memory layout (g2_features.cu Layout), 6 row passes
        hs = nms_radius + 1
        sh, sw = th + 2 * hs, tw + 2 * hs
        swr, shc = -(-sw // 8) * 8, -(-sh // 8) * 8
        ih, iw, rs = shc + 2 * radius, (swr + 2 * radius) | 1, swr | 1
        smem = 4 * (ih * iw + 6 * ih * rs + sh * sw)
        regs, spills = _usage(log, rf"g2_features_kernelILi{radius}E")
        n_tiles = sum(-(-lv.shape[-1] // tw) * -(-lv.shape[-2] // th) for lv in levels)
        yield same, dict(
            tile=f"{th}x{tw}", registers=regs, spill_bytes=spills, smem_bytes=smem,
            blocks_per_sm=min(2, _blocks_per_sm(regs, smem)), tiles=n_tiles,
            halo_factor=(ih * swr + shc * sw) / (2 * th * tw),
            device_ms=device_ms(call, ("g2_features_kernel",), 1)[0],
        )


def sweep_a(builds):
    import torch

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    levels = _frame_levels()
    banks = {"g2": (g2_bank(), 6), "g4": (g4_bank(), 10)}  # bank, distinct x-tap vectors
    want = {k: [cf.filter_bank_plain(lv, b.xtaps, b.ytaps) for lv in levels] for k, (b, _) in banks.items()}
    for (th, tw, _, sw), log, path in builds:
        _load(path, "cvs_filter_bank")
        rec, same = dict(tile=f"{th}x{tw}", row_strip=sw), True
        for key, (b, n_rows) in banks.items():
            radius = (b.xtaps.shape[1] - 1) // 2
            calls = [lambda lv=lv, b=b: cf.filter_bank(lv, b.xtaps, b.ytaps) for lv in levels]
            same &= all(torch.equal(c(), w) for c, w in zip(calls, want[key]))
            regs, spills = _usage(log, rf"filter_bank_kernelILi{radius}E")
            smem = _bank_smem(th, tw, radius, n_rows)
            rec.update({f"{key}_registers": regs, f"{key}_spill_bytes": spills, f"{key}_smem_bytes": smem,
                        f"{key}_blocks_per_sm": _blocks_per_sm(regs, smem),
                        f"{key}_device_ms": device_ms(lambda c=calls: [f() for f in c], ("filter_bank_kernel",),
                                                       len(calls))[0]})
        rec["tiles"] = sum(-(-lv.shape[-1] // tw) * -(-lv.shape[-2] // th) for lv in levels)
        yield same, rec


def sweep_maps(builds, order: int):
    import numpy as np
    import torch

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    seq = PlanesSequence(n_frames=16, image_hw=(512, 512), cx=256, cy=256, seed=0)
    batch = torch.from_numpy(np.stack([np.rint(seq.render(i)).clip(0, 255) for i in range(16)])
                             .astype(np.float32)).cuda()
    b, n_rows = (g2_bank(), 6) if order == 2 else (g4_bank(), 10)
    fn, plain = (cf.g2_maps, cf.g2_maps_plain) if order == 2 else (cf.g4_maps, cf.g4_maps_plain)
    tail = "G2MapsTail" if order == 2 else "G4MapsTail"
    radius = (b.xtaps.shape[1] - 1) // 2
    want = plain(batch, b.xtaps, b.ytaps, out_dtype=torch.bfloat16)
    for (th, tw, strip, sw), log, path in builds:
        _load(path, f"cvs_maps_g{order}")
        call = lambda: fn(batch, b.xtaps, b.ytaps, out_dtype=torch.bfloat16)  # noqa: E731
        same = all(torch.equal(g, w) for g, w in zip(call(), want))
        regs, _ = _usage(log, rf"maps_kernelILi{radius}E\S*{tail}")
        _, spills_any = _usage(log, r"maps_kernel")
        smem = _bank_smem(th, tw, radius, n_rows)
        yield same, dict(
            tile=f"{th}x{tw}", strip_h=strip, row_strip=sw, registers=regs,
            spill_bytes_any_radius=spills_any,
            smem_bytes=smem, blocks_per_sm=_blocks_per_sm(regs, smem),
            tiles=16 * -(-512 // th) * -(-512 // tw), halo_factor=(th + 2 * radius) / th,
            device_ms=device_ms(call, ("maps_kernel",), 1)[0],
        )


def _pyr_smem(th: int, tw: int, max_m: int, m: int, tail: bool) -> int:
    """Shared bytes of kernel B for a block that builds levels 1 .. m
    (pyr_down.cu PyrLayout; row strips of 4, column strips of 2, a 32x48
    tail tile)."""
    up = lambda a, b: -(-a // b) * b  # noqa: E731
    th, tw = th << (max_m - m), tw << (max_m - m)

    def region(n, down):
        for _ in range(down):
            n = 2 * n + 3
        return n
    rh = lambda lv: region(th, m - lv)  # noqa: E731
    rw = lambda lv: region(tw, m - lv)  # noqa: E731
    src_ld = lambda lv: (2 * up(rw(lv), 4) + 3) | 1  # noqa: E731
    level = lambda lv: rh(lv - 1) * src_ld(lv)  # noqa: E731
    a = max(level(lv) for lv in range(1, m + 1, 2))
    b = max((level(lv) for lv in range(2, m + 1, 2)), default=0)
    rows = max((2 * up(rh(lv), 2) + 3) * (up(rw(lv), 4) | 1) for lv in range(1, m + 1))
    floats = a + b + rows
    if tail:
        t_ld, t_rows = (2 * 48 + 3) | 1, 2 * 32 + 3
        floats = max(floats, t_rows * t_ld + t_rows * (48 | 1))
    return 4 * floats


def sweep_b(builds):
    import torch

    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    levels = _frame_levels()
    frame = levels[0]
    for (th, tw, max_m, _), log, path in builds:
        m = min(len(levels) - 1, max_m)
        smem = _pyr_smem(th, tw, max_m, m, len(levels) - 1 > max_m)
        if smem > SMEM_PER_SM - 1024:
            yield True, dict(tile=f"{th}x{tw}", block_levels=max_m, smem_bytes=smem, skipped="shared memory")
            continue
        _load(path, "cvs_pyr_down_levels")
        got = cf.pyr_down_levels(frame, len(levels))
        same = all(torch.equal(g, w) for g, w in zip(got, levels))
        same &= torch.equal(cf.pyr_down(frame), levels[1])
        regs, spills = _usage(log, r"pyr_down_kernel")
        hm, wm = levels[m].shape[-2:]
        yield same, dict(
            tile=f"{th}x{tw}", block_levels=max_m, registers=regs, spill_bytes=spills, smem_bytes=smem,
            blocks_per_sm=_blocks_per_sm(regs, smem), blocks=-(-hm // th) * -(-wm // tw),
            device_ms=device_ms(lambda: cf.pyr_down_levels(frame, len(levels)), ("pyr_down_kernel",), 1)[0],
            # the same launch cut at fewer levels: 2 is one step
            device_ms_by_levels={n: device_ms(lambda n=n: cf.pyr_down_levels(frame, n), ("pyr_down_kernel",),
                                              1)[0] for n in range(2, len(levels))},
        )


def _adj_smem(th: int, tw: int, radius: int, col_strip: int, row_strip: int) -> int:
    """Shared bytes of kernel F (filter_bank_adj.cu AdjLayout: two planes,
    two row buffers)."""
    up = lambda a, b: -(-a // b) * b  # noqa: E731
    gh, gw = th + 3 * radius, tw + 3 * radius
    rows_h, rows_w = up(gh, col_strip) + 2 * radius, up(gw, row_strip)
    plane = rows_h * ((rows_w + 2 * radius) | 1)
    return 4 * (2 * plane + 2 * rows_h * (rows_w | 1))


def sweep_f(builds):
    import torch

    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.ops import cuda_frontend as cf

    gen = torch.Generator(device="cuda").manual_seed(0)
    banks = {"g2": g2_bank(), "g4": g4_bank()}
    grads = {k: torch.randn((1, b.xtaps.shape[0], 480, 640), device="cuda", generator=gen)
             for k, b in banks.items()}
    want = {k: cf.filter_bank_adjoint_plain(grads[k], b.xtaps, b.ytaps) for k, b in banks.items()}
    for (th, tw, cs, rs), log, path in builds:
        _load(path, "cvs_filter_bank_adj")
        rec, same = dict(tile=f"{th}x{tw}", col_strip=cs, row_strip=rs), True
        for key, b in banks.items():
            radius = (b.xtaps.shape[1] - 1) // 2
            call = lambda g=grads[key], b=b: cf.filter_bank_adjoint(g, b.xtaps, b.ytaps)  # noqa: E731
            same &= torch.equal(call(), want[key])
            regs, spills = _usage(log, rf"adj_kernelILi{radius}E")
            smem = _adj_smem(th, tw, radius, cs, rs)
            rec.update({f"{key}_registers": regs, f"{key}_spill_bytes": spills, f"{key}_smem_bytes": smem,
                        f"{key}_blocks_per_sm": _blocks_per_sm(regs, smem),
                        f"{key}_device_ms": device_ms(call, ("adj_kernel",), 1)[0]})
        rec["tiles"] = -(-480 // th) * -(-640 // tw)
        yield same, rec


def sweep_m(builds):
    import torch

    from cvsteer_tpu_torch import probes
    from cvsteer_tpu_torch.ops import cuda_probes as cp

    xt, yt = probes.g2_taps()
    batch = probes.uniform_batch(16, 512, "cuda")
    n_rows = len({row.tobytes() for row in xt})
    cases = sorted(cp.MMA_CASES)
    want = {c: cp.maps_mma_plain(batch, xt, yt, *c) for c in cases}
    c3 = {row: cp.maps_mma_plain(batch, xt, yt, "coeff", row, "bf16x3")[1] for row in ("fp32", "mma")}
    for (_, tw, _, _), log, path in builds:
        _load(path, "cvs_probe_mma")
        agree, good = {}, True
        for c in cases:
            res = cp.mma_agreement(cp.maps_mma(batch, xt, yt, *c), want[c], c[0], c[1],
                                   c3[c[1]] if c[0] == "full" else None)
            agree["/".join(c)] = res["max_rel"]
            good &= res["ok"]
        lib = ctypes.CDLL(path)
        smem, threads, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.cvs_probe_mma_config(n_rows, ctypes.byref(smem), ctypes.byref(threads), ctypes.byref(blocks))
        regs, spills = _usage(log, r"mma_maps_kernel")
        per_case = {"/".join(c): device_ms(lambda c=c: cp.maps_mma(batch, xt, yt, *c), ("mma_maps_kernel",), 1)[0]
                    for c in MMA_UNIT}
        yield good, dict(
            tile=f"64x{tw}", registers=regs, spill_bytes=spills,
            smem_bytes=smem.value if err == 0 else None, threads=threads.value if err == 0 else None,
            blocks_per_sm=blocks.value if err == 0 else None, config_error=err,
            tiles=16 * -(-512 // 64) * -(-512 // tw), halo_factor=(64 + 8) * (tw + 8) / (64 * tw),
            device_ms_per_case=per_case,
            device_ms_unit=device_ms(lambda: [cp.maps_mma(batch, xt, yt, *c) for c in MMA_UNIT],
                                     ("mma_maps_kernel",), len(MMA_UNIT))[0],
            max_rel=agree,
        )


def ptxas_report() -> int:
    """Build the library's sources with -Xptxas -v; one JSON line per kernel."""
    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    units = [s for s in kernels._sources() if s.endswith(".cu")]
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "--ptxas-options=-v", "-c", "-o",
                               os.path.join(out_dir, os.path.basename(s) + ".o"), s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for s in units]
    spilling, n = 0, 0
    for src, proc in zip(units, procs):
        _, log = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: nvcc for {src}:\n{log}", file=sys.stderr)
            return 1
        usage = ptxas_usage(log)
        for (_, regs, spills), name in zip(usage, _demangle([u[0] for u in usage])):
            print(json.dumps(dict(source=os.path.basename(src), kernel=name, registers=regs,
                                  spill_bytes=spills)), flush=True)
            spilling += spills > 0
            n += 1
    print(json.dumps(dict(instantiations=n, spilling=spilling)))
    return 0


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("c", "a", "e", "e4", "b", "f", "m", "ptxas"), default="c")
    ap.add_argument("--tiles", default=None)
    ap.add_argument("--strips", default="4,8", help="e, e4, f: column-strip heights")
    ap.add_argument("--row-strips", default="2", help="a, e, e4, f: row-strip widths")
    ap.add_argument("--block-levels", default="4", help="b: the levels a block builds itself")
    ap.add_argument("--define", action="append", default=[], metavar="MACRO=VALUE",
                    help="another -D for every build (e.g. CVS_F_MIN_BLOCKS=3)")
    ap.add_argument("--nms-radius", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.kernel == "ptxas":
        return ptxas_report()
    tiles = [tuple(int(v) for v in t.split("x"))
             for t in (args.tiles or DEFAULT_TILES[args.kernel]).split(",")]
    macros = SOURCES[args.kernel][1]
    third = args.block_levels if args.kernel == "b" else args.strips
    strips = [int(s) for s in third.split(",")] if macros[2] else [None]
    rows = [int(s) for s in args.row_strips.split(",")] if macros[3] else [None]
    shapes = [(th, tw, s, sw) for th, tw in tiles for s in strips for sw in rows
              if (s is None or args.kernel == "b" or th % s == 0) and (sw is None or tw % sw == 0)]
    procs = []
    for shape in shapes:
        defines = dict(d.split("=", 1) for d in args.define)
        defines.update({m: v for m, v in zip(macros, shape) if m is not None and v is not None})
        procs.append(_build(args.kernel, "x".join(str(v) for v in shape if v is not None), defines))
    builds = []
    for shape, (proc, path) in zip(shapes, procs):
        _, log = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: nvcc for {shape}:\n{log}", file=sys.stderr)
            return 1
        builds.append((shape, log, path))
    sweep = {"c": lambda b: sweep_c(b, args.nms_radius), "a": sweep_a,
             "e": lambda b: sweep_maps(b, 2), "e4": lambda b: sweep_maps(b, 4), "b": sweep_b,
             "f": sweep_f, "m": sweep_m}[args.kernel]
    ok, card = True, torch.cuda.get_device_name(0)
    try:
        for same, rec in sweep(builds):
            ok &= same
            check = "within_tolerance" if args.kernel == "m" else "bit_equal"
            print(json.dumps(dict(kernel=args.kernel, **rec, defines=args.define, **{check: same}, card=card)),
                  flush=True)
    finally:
        kernels._lib = None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

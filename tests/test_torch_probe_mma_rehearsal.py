"""CPU rehearsal of kernel M's tiling (``kernels/csrc/probe_maps_mma.cu``).

Kernel M runs its column pass as wgmma products, which have no CPU mode, so
its index arithmetic is rehearsed here in PyTorch with the tile constants
read from the source:

- the row planes: each row-pass value (y, x) of a tile lives at a byte
  offset of wgmma's canonical MN-major layout without swizzle (8 x 8 core
  matrices of 128 contiguous bytes; the descriptor's leading byte offset
  steps one core matrix along K, its stride byte offset one along N), which
  is both where the row pass stores it and where each warpgroup's k-step
  descriptor reads it;
- the band: C_k [64, 80] as the warps' A registers (two fragments a warp,
  zeros at the other k-steps), zero past column 71;
- the staging: a tile's 72 x (TW + 8) window, 16-byte copies inside the
  image, reflected addresses elsewhere;
- the whole walk, tile by tile, against maps_mma_plain.
"""

import os
import re

import numpy as np
import pytest
import torch

from cvsteer_tpu_torch.filters import taps as taps_mod
from cvsteer_tpu_torch.ops import cuda_probes as cp
from cvsteer_tpu_torch.ops.sepconv import reflect_indices

CSRC = os.path.join(os.path.dirname(cp.__file__), "..", "kernels", "csrc")


def _constants(source: str) -> dict:
    """The source's default ``#define CVS_*`` values, ``constexpr int`` constants
    with a literal value, and the stage stride's padding."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    out = {m[0]: int(m[1]) for m in re.findall(r"#define (CVS_\w+) (\d+)", text)}
    out.update({m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+|R) = (\d+)[;,]", text)})
    out["ld_pad"] = int(re.search(r"constexpr int kLd = kTW \+ (\d+);", text).group(1))
    return out


M = _constants("probe_maps_mma.cu")
R, TH, TW, KP = M["R"], M["kTH"], M["CVS_M_TILE_W"], M["kKP"]
N = TW // 2                      # a warpgroup's columns
IH, IW, LD = TH + 2 * R, TW + 2 * R, TW + M["ld_pad"]
COLS = TW // 8                   # core matrices along N of a plane
LBO, SBO = COLS * M["kCore"], M["kCore"]
PLANE = KP // 8 * LBO
THREADS, SW = M["kThreads"], M["kSW"]


def row_at(y, x):
    """Byte offset of row-pass value (K index y, N index x) in a plane: the
    canonical MN-major no-swizzle layout, core matrix (y // 8, x // 8) at
    (y // 8) LBO + (x // 8) SBO, its row y % 8 (16 bytes) and element x % 8."""
    return (y // 8) * LBO + (x // 8) * SBO + (y % 8) * 16 + (x % 8) * 2


def desc_read(start, lbo, sbo, k, n):
    """Where a wgmma with a no-swizzle MN-major descriptor (start, lbo, sbo)
    reads B[k, n] of its 16 x N k-step."""
    return start + (k // 8) * lbo + (n // 8) * sbo + (k % 8) * 16 + (n % 8) * 2


@pytest.fixture(scope="module")
def bank():
    b = taps_mod.g2h2_bank()
    return np.asarray(b.xtaps, np.float32), np.asarray(b.ytaps, np.float32)


def test_torch_probe_mma_rehearsal_planes_and_stores():
    """The plane map is a bijection of the 80 x TW values onto the plane's
    2-byte slots; each warpgroup's k-step descriptor reads exactly the
    values the map puts there; the row pass's 16-byte stores (a thread: 8
    values of one row, consecutive threads on consecutive rows of a strip)
    cover every row below 72 once, and in every store instruction each
    quarter-warp writes 8 distinct 16-byte bank groups; the zeroed rows 72..79
    are the last K-group of core matrices."""
    ys, xs = np.meshgrid(np.arange(KP), np.arange(TW), indexing="ij")
    offs = row_at(ys, xs)
    assert sorted(offs.ravel().tolist()) == list(range(0, PLANE, 2))
    for g in range(2):
        for ks in range(KP // 16):
            start = 2 * ks * LBO + g * (N // 8) * SBO
            kk, nn = np.meshgrid(np.arange(16), np.arange(N), indexing="ij")
            assert np.array_equal(desc_read(start, LBO, SBO, kk, nn), row_at(16 * ks + kk, g * N + nn))
    tasks = np.arange(IH * COLS)
    strip, y = tasks // IH, tasks % IH
    chunks = row_at(y, SW * strip)
    assert np.all(chunks % 16 == 0) and len(set(chunks.tolist())) == len(chunks)
    covered = {int(o) for c in chunks for o in range(c, c + 16, 2)}
    assert covered == {int(o) for o in offs[:IH].ravel()}
    for first in range(0, len(tasks), THREADS):  # one store instruction a round of the loop
        for q0 in range(first, min(first + THREADS, len(tasks)), 8):
            groups = (chunks[q0:q0 + 8] // 16) % 8
            assert len(set(groups.tolist())) == len(groups), (first, q0)
    pad = {int(o) for o in offs[IH:].ravel()}
    assert pad == set(range((IH // 8) * LBO, PLANE, 2))


def _fragments(ytaps_k, which):
    """Kernel M's two band fragments of one filter and part, per lane:
    [2 steps, 32 lanes, 4 registers, 2 halves] (band_fragments)."""
    hi, lo = cp.bf16_split(torch.from_numpy(np.asarray(ytaps_k, np.float32)))
    t = (lo if which else hi).numpy()

    def tap(i):
        return t[i] if 0 <= i < len(t) else 0.0
    out = np.zeros((2, 32, 4, 2), np.float32)
    for step in range(2):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            base = 16 * step + 2 * q - g
            for r, b in enumerate((base, base - 8, base + 8, base)):
                out[step, lane, r] = (tap(b), tap(b + 1))
    return out


def _band_from_registers(frags):
    """C [64, 80] assembled from the A registers of every warp and k-step: f0
    at the warp's own k-step, f1 at the next, zeros elsewhere."""
    C = np.zeros((TH, KP), np.float32)
    for wl in range(4):
        for ks in range(KP // 16):
            step = ks - wl
            if step not in (0, 1):
                continue
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                    for half in range(2):
                        C[16 * wl + g + dm, 16 * ks + 2 * q + dk + half] = frags[step, lane, r, half]
    return C


def test_torch_probe_mma_rehearsal_band_gives_whole_image_column_pass(bank):
    """The band the warps hold in registers is the tile's C_k hi / lo,
    col_conv_matrix split into bf16 parts, padded with zero columns to K =
    80; tile by tile, C_pad times the tile's 72 row-pass rows and 8 more (any
    finite values) gives the whole image's column pass (float64, where the 9
    products of bf16 parts and their sums are exact)."""
    _, yt = bank
    want = torch.from_numpy(cp.col_conv_matrix(yt, TH, IH))
    hi, lo = cp.bf16_split(want)
    rng = np.random.default_rng(3)
    h, w = 150, 45
    for k in range(yt.shape[0]):
        for which, part in ((0, hi[k]), (1, lo[k])):
            C = _band_from_registers(_fragments(yt[k], which))
            assert np.array_equal(C[:, :IH], part.numpy()) and not C[:, IH:].any()
            rows = torch.from_numpy(cp.bf16_split(torch.from_numpy(
                rng.uniform(-300, 300, (h + 2 * R, w)).astype(np.float32)))[0].numpy()).double()
            whole = torch.from_numpy(cp.col_conv_matrix(yt[k:k + 1], h, h + 2 * R)[0])
            whole = cp.bf16_split(whole.float())[which].double() @ rows
            tiled = torch.zeros_like(whole)
            for y0 in range(0, h, TH):
                band = torch.full((KP, w), 1e30, dtype=torch.float64)  # past the image: finite garbage
                avail = min(KP, h + 2 * R - y0)
                band[:avail] = rows[y0:y0 + avail]
                out = torch.from_numpy(C).double() @ band
                tiled[y0:y0 + TH] = out[:min(TH, h - y0)]
            assert torch.equal(tiled, whole), (k, which)


def _stage(image, y0, x0):
    """stage_async: the tile's IH x IW window, 16-byte copies where the window
    lies inside an image whose width is a multiple of 4, reflected addresses
    elsewhere; returns (window, took the 16-byte path)."""
    h, w = image.shape
    ys, xs = y0 - R, x0 - R
    if ys >= 0 and ys + IH <= h and xs >= 0 and xs + IW <= w and w % 4 == 0:
        win = torch.zeros((IH, IW))
        for r in range(IH):
            for c in range(0, IW, 4):
                win[r, c:c + 4] = image[ys + r, xs + c:xs + c + 4]
        return win, True
    ry = reflect_indices(ys, ys + IH, h, image.device)
    rx = reflect_indices(xs, xs + IW, w, image.device)
    return image[ry][:, rx], False


def test_torch_probe_mma_rehearsal_staging_reflects_at_borders():
    """Every tile's staged window equals the REFLECT_101-padded image's
    window at the tile (pad wide enough for any tile), on a ragged image, on
    one with interior tiles and on one smaller than the halo; border tiles
    hold the reflected pixels, tiles inside an image of width 4k take the
    16-byte copies, and the stage stride keeps a 16-byte row alignment."""
    for h, w in ((61, 83), (200, 136), (5, 3)):
        image = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
        pad_y = reflect_indices(-R, -(-h // TH) * TH + R, h, image.device)
        pad_x = reflect_indices(-R, -(-w // TW) * TW + R, w, image.device)
        padded = image[pad_y][:, pad_x]
        paths = set()
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                win, fast = _stage(image, y0, x0)
                paths.add(fast)
                assert torch.equal(win, padded[y0:y0 + IH, x0:x0 + IW]), (h, w, y0, x0)
                if y0 == 0:  # the row above the image is row 1 reflected
                    cols = min(TW, w - x0)
                    assert torch.equal(win[R - 1, R:R + cols], image[min(1, h - 1), x0:x0 + cols])
        assert paths == ({True, False} if (h, w) == (200, 136) else {False}), (h, w)
    assert (LD * 4) % 16 == 0 and (LD // 4) % 2 == 1 and LD >= IW


def _rehearse(image, xt, yt, stage, col):
    """Kernel M's walk tile by tile with maps_mma_plain's arithmetic: staged
    window, fp32 row pass in the plain order, bf16 parts stored through the
    plane map, each warpgroup's B read back through its descriptors, the
    band from the A registers, the stage's tail."""
    n, h, w = image.shape
    K = xt.shape[0]
    distinct = []
    row_of = []
    for k in range(K):
        key = xt[k].tobytes()
        if key not in [d.tobytes() for d in distinct]:
            distinct.append(xt[k])
        row_of.append([d.tobytes() for d in distinct].index(key))
    C = {(k, which): torch.from_numpy(_band_from_registers(_fragments(yt[k], which))) for k in range(K)
         for which in (0, 1)}
    kk, nn = np.meshgrid(np.arange(16), np.arange(N), indexing="ij")
    views = [torch.cat([torch.from_numpy(desc_read(2 * ks * LBO + g * (N // 8) * SBO, LBO, SBO, kk, nn) // 2)
                        for ks in range(KP // 16)]) for g in range(2)]  # [KP, N] slots of each warpgroup
    outs = [torch.zeros_like(image) for _ in range(3)]
    ky, kx = np.meshgrid(np.arange(KP), np.arange(TW), indexing="ij")
    slots = torch.from_numpy(row_at(ky, kx) // 2)
    for z in range(n):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                win, _ = _stage(image[z], y0, x0)
                planes = []
                for d in distinct:
                    rows = win[:, 0:TW] * float(d[0])
                    for t in range(1, len(d)):
                        rows = rows + win[:, t:t + TW] * float(d[t])
                    parts = []
                    for part in cp.bf16_split(rows):
                        flat = torch.zeros(PLANE // 2)
                        flat[slots[:IH].reshape(-1)] = part.reshape(-1)
                        parts.append(flat)
                    planes.append(parts)
                th, tw = min(TH, h - y0), min(TW, w - x0)
                if stage == "row":
                    at = slots[R:R + TH]
                    hi = torch.stack([planes[row_of[k]][0][at] for k in range(K)])
                    lo = torch.stack([planes[row_of[k]][1][at] for k in range(K)])
                    got = cp.row_split_outputs(hi, lo)
                else:
                    basis = torch.zeros((K, TH, TW))
                    for k in range(K):
                        for g in range(2):
                            bh = planes[row_of[k]][0][views[g]]
                            acc = C[k, 0] @ bh
                            if col == "bf16x3":
                                acc = acc + C[k, 0] @ planes[row_of[k]][1][views[g]] + C[k, 1] @ bh
                            basis[k, :, g * N:(g + 1) * N] = acc
                    if stage == "col":
                        got = cp.col_outputs(basis, "v2")
                    elif stage == "coeff":
                        got = cp.coeff_outputs(basis, "v2")
                    else:
                        got = cp.g2_sqrt_maps(basis, *cp.g2_harmonic(basis))
                for o, gmap in zip(outs, got):
                    o[z, y0:y0 + th, x0:x0 + tw] = gmap[:th, :tw]
    return tuple(outs)


def test_torch_probe_mma_rehearsal_tiles_match_plain(bank, record_property):
    """The by-tiles rehearsal against the whole-image plain version on a
    ragged batch and on a 3 x 3 grid of tiles: the row stage bit for bit, col
    (bf16x3 and bf16x1) and coeff within MMA_TOL (the products' sums run in
    another order), the full maps within the full stage's tolerance."""
    xt, yt = bank
    for shape in ((2, 61, 83), (1, 130, 150)):
        img = torch.from_numpy(np.random.default_rng(8).uniform(0, 255, shape).astype(np.float32))
        for stage, col in (("row", "bf16x3"), ("col", "bf16x3"), ("col", "bf16x1"), ("coeff", "bf16x3"),
                           ("full", "bf16x3")):
            got = _rehearse(img, xt, yt, stage, col)
            want = cp.maps_mma_plain(img, xt, yt, stage, "fp32", col)
            c3 = cp.maps_mma_plain(img, xt, yt, "coeff", "fp32", col)[1] if stage == "full" else None
            res = cp.mma_agreement(got, want, stage, "fp32", c3)
            record_property(f"{shape} {stage}/{col}", res["max_rel"])
            assert res["ok"], (shape, stage, col, res)

"""CPU rehearsals of kernels B and F's tile decompositions.

CUDA kernels cannot run on the CPU, so their index arithmetic is rehearsed
here in PyTorch, block by block, with the tile constants read from the
kernels' sources (``kernels/csrc/pyr_down.cu``, ``filter_bank_adj.cu``):

- B (one launch per pyramid): every block builds levels 1 .. M of its tile
  from its own REFLECT_101-staged level-0 patch, recomputing its neighbours'
  halo and filling the positions past a level's edge from their reflected
  positions; blocks run in a shuffled order, each takes a ticket, and the
  block that draws its image's last ticket builds the remaining levels from
  what the others stored (it must find them all written).
- F (the bank's adjoint, one launch): every block computes gP on its tile,
  extended by r toward each border whose pad folds into it, and folds that
  border itself (rows first, then columns, pads in ascending position).

Each output must be stored exactly once and equal the plain version bit for
bit: every sum below runs in the kernels' (and the plain versions') order.
"""

import os
import re

import numpy as np
import pytest
import torch

from cvsteer_tpu_torch.filters import taps
from cvsteer_tpu_torch.ops import cuda_frontend as cf
from cvsteer_tpu_torch.ops.sepconv import reflect_indices

CSRC = os.path.join(os.path.dirname(cf.__file__), "..", "kernels", "csrc")
BINOMIAL = [float(t) for t in cf._BINOMIAL5]


def _constants(source: str) -> dict:
    """The source's default ``#define CVS_*`` values and ``constexpr int k*``."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    out = {m[0]: int(m[1]) for m in re.findall(r"#define (CVS_\w+) (\d+)", text)}
    out.update({m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", text)})
    return out


B = _constants("pyr_down.cu")
F_ = _constants("filter_bank_adj.cu")


def _texture(shape, seed):
    return torch.from_numpy((np.random.default_rng(seed).random(shape) * 255).astype(np.float32))


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------


def _region(n, down):
    for _ in range(down):
        n = 2 * n + 3
    return n


def _step(src, nh, nw):
    """One pyramid step of a staged region: the row pass at the even
    columns, then the column pass at the even rows, taps in order."""
    a = src[:, 0 : 2 * nw - 1 : 2] * BINOMIAL[0]
    for t in range(1, 5):
        a = a + src[:, t : t + 2 * nw - 1 : 2] * BINOMIAL[t]
    b = a[0 : 2 * nh - 1 : 2] * BINOMIAL[0]
    for t in range(1, 5):
        b = b + a[t : t + 2 * nh - 1 : 2] * BINOMIAL[t]
    return b


def _stage(plane, y0, x0, nh, nw):
    """REFLECT_101 staging of rows [y0, y0 + nh) x columns [x0, x0 + nw)."""
    h, w = plane.shape
    return plane[reflect_indices(y0, y0 + nh, h)][:, reflect_indices(x0, x0 + nw, w)]


def rehearse_pyramid(image: torch.Tensor, levels: int, seed: int = 0):
    """Kernel B's launch over ``image [n, h, w]``, block by block."""
    n, h, w = image.shape
    max_m = B["CVS_B_LEVELS"]
    M = min(levels - 1, max_m)
    th, tw = B["CVS_B_TILE_H"] << (max_m - M), B["CVS_B_TILE_W"] << (max_m - M)
    dims = [(h, w)]
    for _ in range(levels - 1):
        dims.append((-(-dims[-1][0] // 2), -(-dims[-1][1] // 2)))
    out = [None] + [torch.full((n,) + d, float("nan")) for d in dims[1:]]
    writes = [None] + [torch.zeros((n,) + d, dtype=torch.int32) for d in dims[1:]]
    hm, wm = dims[M]
    grid = [(z, by, bx) for z in range(n) for by in range(-(-hm // th)) for bx in range(-(-wm // tw))]
    per_image = len(grid) // n
    tickets = [0] * n
    order = np.random.default_rng(seed).permutation(len(grid))

    def store(level, img, y0, x0, vals, cy, cx):
        """Store the owned part [cy0, cy1) x [cx0, cx1) of a region at (y0, x0)."""
        (cy0, cy1), (cx0, cx1) = cy, cx
        out[level][img, cy0:cy1, cx0:cx1] = vals[cy0 - y0 : cy1 - y0, cx0 - x0 : cx1 - x0]
        writes[level][img, cy0:cy1, cx0:cx1] += 1

    for g in order:
        img, by, bx = grid[g]
        ry, rx = [0] * (M + 1), [0] * (M + 1)
        ry[M], rx[M] = by * th, bx * tw
        for m in range(M - 1, -1, -1):
            ry[m], rx[m] = 2 * ry[m + 1] - 2, 2 * rx[m + 1] - 2
        src = _stage(image[img], ry[0], rx[0], _region(th, M), _region(tw, M))
        for m in range(1, M + 1):
            nh, nw = _region(th, M - m), _region(tw, M - m)
            assert src.shape == (2 * nh + 3, 2 * nw + 3)
            vals = _step(src, nh, nw)
            s = 1 << (M - m)
            hl, wl = dims[m]
            store(m, img, ry[m], rx[m], vals,
                  (by * th * s, min((by + 1) * th * s, hl)), (bx * tw * s, min((bx + 1) * tw * s, wl)))
            # positions past the level's edge: their reflected position's value
            rmap = reflect_indices(ry[m], ry[m] + nh, hl) - ry[m]
            cmap = reflect_indices(rx[m], rx[m] + nw, wl) - rx[m]
            valid_r = (torch.arange(ry[m], ry[m] + nh) >= 0) & (torch.arange(ry[m], ry[m] + nh) < hl)
            valid_c = (torch.arange(rx[m], rx[m] + nw) >= 0) & (torch.arange(rx[m], rx[m] + nw) < wl)
            rmap = torch.where(valid_r, torch.arange(nh), rmap.clamp(0, nh - 1))
            cmap = torch.where(valid_c, torch.arange(nw), cmap.clamp(0, nw - 1))
            src = vals[rmap][:, cmap]
        if levels - 1 == M:
            continue
        ticket = tickets[img]
        tickets[img] += 1
        if ticket != per_image - 1:
            continue
        tickets[img] = 0  # the last block resets its image's counter
        th_t, tw_t = B["kTailH"], B["kTailW"]
        for m in range(M + 1, levels):
            hd, wd = dims[m]
            for y0 in range(0, hd, th_t):
                for x0 in range(0, wd, tw_t):
                    nh, nw = min(th_t, hd - y0), min(tw_t, wd - x0)
                    src = _stage(out[m - 1][img], 2 * y0 - 2, 2 * x0 - 2, 2 * nh + 3, 2 * nw + 3)
                    assert not torch.isnan(src).any(), "the tail read a level another block had not stored"
                    store(m, img, y0, x0, _step(src, nh, nw), (y0, y0 + nh), (x0, x0 + nw))
    assert tickets == [0] * n
    for wr in writes[1:]:
        assert torch.equal(wr, torch.ones_like(wr)), "an output stored other than once"
    return (image,) + tuple(out[1:])


@pytest.mark.parametrize("shape,levels", [
    ((1, 480, 640), 5), ((2, 61, 83), 5), ((3, 2), 5), ((1, 1), 5), ((2, 5, 9), 5),
    ((1, 185, 256), 5), ((2, 61, 83), 1), ((2, 61, 83), 2), ((2, 61, 83), 7),
    ((1, 600, 900), 7),  # a tail level over 2 x 2 tail tiles
])
def test_torch_pyramid_tiles_rehearsal_bit_equal(shape, levels):
    img = _texture(shape, 7)
    x = img.reshape((-1,) + shape[-2:])
    want = cf.pyr_down_levels(img, levels)
    if levels == 1:
        assert len(want) == 1 and want[0] is img
        return
    got = rehearse_pyramid(x, levels, seed=levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.reshape(w.shape), w)


# ---------------------------------------------------------------------------
# Kernel F
# ---------------------------------------------------------------------------


def _fold_rows(gp, p0, a_lo, a_hi, h, r):
    """Rows a in [a_lo, a_hi) of the rows' fold of a gP region from row p0:
    0, + each lower pad row reflecting to a (ascending), + row a, + each
    upper pad row reflecting to a."""
    lower = reflect_indices(-r, 0, h).tolist()
    upper = reflect_indices(h, h + r, h).tolist()
    out = []
    for a in range(a_lo, a_hi):
        s = torch.zeros_like(gp[0])
        for j, t in enumerate(lower):
            if t == a:
                assert 0 <= j - r - p0 < gp.shape[0]
                s = s + gp[j - r - p0]
        s = s + gp[a - p0]
        for j, t in enumerate(upper):
            if t == a:
                assert 0 <= h + j - p0 < gp.shape[0]
                s = s + gp[h + j - p0]
        out.append(s)
    return torch.stack(out)


def rehearse_adjoint(grad: torch.Tensor, xtaps, ytaps):
    """Kernel F's launch over ``grad [n, K, h, w]``, block by block."""
    n, K, h, w = grad.shape
    xt = torch.from_numpy(np.asarray(xtaps, np.float32))
    yt = torch.from_numpy(np.asarray(ytaps, np.float32))
    T = xt.shape[1]
    R = (T - 1) // 2
    TH, TW = F_["CVS_F_TILE_H"], F_["CVS_F_TILE_W"]
    PR, PC = F_["CVS_F_ROW_STRIP"], F_["CVS_F_COL_STRIP"]
    gh, gw = TH + 3 * R, TW + 3 * R  # AdjLayout's largest region
    out = torch.full((n, h, w), float("nan"))
    writes = torch.zeros((n, h, w), dtype=torch.int32)
    for by in range(-(-h // TH)):
        for bx in range(-(-w // TW)):
            y0, x0 = by * TH, bx * TW
            y1, x1 = min(y0 + TH, h), min(x0 + TW, w)
            p0, p1 = (-R if y0 <= R else y0), (h + R if y1 + R >= h else y1)
            q0, q1 = (-R if x0 <= R else x0), (w + R if x1 + R >= w else x1)
            nh, nw = p1 - p0, q1 - q0
            assert nh <= gh and nw <= gw
            border = (p0, p1, q0, q1) != (y0, y1, x0, x1)
            n_rows = -(-nh // PC) * PC + 2 * R  # row-pass rows from p0 - R
            n_cols = -(-nw // PR) * PR + 2 * R  # staged columns from q0 - R
            ys = torch.arange(p0 - R, p0 - R + n_rows)
            xs = torch.arange(q0 - R, q0 - R + n_cols)
            in_y, in_x = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
            staged = torch.zeros((n, K, n_rows, n_cols))
            staged[:, :, in_y[:, None] & in_x[None, :]] = grad[:, :, ys[in_y]][:, :, :, xs[in_x]].reshape(n, K, -1)
            acc = None
            for k in range(K):
                cw = n_cols - 2 * R  # row-pass outputs, whole strips
                rows = staged[:, k, :, 2 * R : 2 * R + cw] * xt[k, 0]
                for u in range(1, T):
                    rows = rows + staged[:, k, :, 2 * R - u : 2 * R - u + cw] * xt[k, u]
                rows = torch.where(in_y[None, :, None], rows, 0.0)
                ch = n_rows - 2 * R
                col = rows[:, 2 * R : 2 * R + ch] * yt[k, 0]
                for v in range(1, T):
                    col = col + rows[:, 2 * R - v : 2 * R - v + ch] * yt[k, v]
                acc = col if acc is None else acc + col
            gp = acc[:, :nh, :nw]
            if not border:
                out[:, y0:y1, x0:x1] = 0.0 + gp
            else:
                rf = _fold_rows(gp.permute(1, 0, 2), p0, y0, y1, h, R)  # [rows, n, nw]
                cf_ = _fold_rows(rf.permute(2, 1, 0), q0, x0, x1, w, R)  # [cols, n, rows]
                out[:, y0:y1, x0:x1] = cf_.permute(1, 2, 0)
            writes[:, y0:y1, x0:x1] += 1
    assert torch.equal(writes, torch.ones_like(writes)), "an output stored other than once"
    return out


def _random_bank(K, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, 2 * R + 1)).astype(np.float32),
            rng.standard_normal((K, 2 * R + 1)).astype(np.float32))


def _check_adjoint(shape, xt, yt, seed):
    K = xt.shape[0]
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(shape[:-2]) + (K,) + tuple(shape[-2:])).astype(np.float32))
    want = cf.filter_bank_adjoint_plain(g, xt, yt)
    got = rehearse_adjoint(g.reshape((-1, K) + tuple(shape[-2:])), xt, yt)
    assert torch.equal(got.reshape(want.shape), want)


F_SHAPES = [(16, 512, 512), (1, 480, 640), (1, 185, 256), (2, 2), (1, 1), (3, 5), (13, 7), (7, 13)]


@pytest.mark.parametrize("shape", F_SHAPES)
def test_torch_adjoint_tiles_rehearsal_bit_equal(shape):
    """The G2/H2 and G4/H4 banks at the card test's shapes."""
    for i, bank in enumerate((taps.g2h2_bank(), taps.g4h4_bank())):
        _check_adjoint(shape, bank.xtaps, bank.ytaps, seed=i)


@pytest.mark.parametrize("R", range(7))
def test_torch_adjoint_tiles_rehearsal_every_radius(R):
    """Random banks at every odd T = 1..13, at the small and ragged shapes
    (a level up to r longer than one tile, whose first tile folds both
    pads, among them)."""
    xt, yt = _random_bank(3, R, seed=R)
    for shape in [(2, 2), (1, 1), (3, 5), (13, 7), (7, 13), (2, 37, 45), (1, 38, 36)]:
        _check_adjoint(shape, xt, yt, seed=R)

"""The least work of one front-end call, from shapes alone, and the card's peaks.

Frozen from the port's chip_smoke.py (``Bound``, ``pass_flops``,
``distinct_rows``, ``bank_flops`` and the phase 4 / 10 byte counts), and
extended to the whole ``extract_features`` call: the count stays fixed when
a later change moves work between plain PyTorch and a kernel.

- **bytes**: the input frames read once (their dtype as uploaded), the
  pyramid levels 1.. written once in float32, and the Features written
  once (yx, score, theta, level, desc, valid).
- **flops**: the pyramid's separable binomial blur at the decimated
  outputs; the steerable bank at every level (one row pass per distinct
  x-tap vector, one column pass per filter, mirrored equal taps sharing a
  multiply); the energy coefficients and the corner score per pixel; the
  descriptors' bilinear samples and steering per keypoint. Selection (NMS,
  top-k) is data-dependent and left out.

The least time is max(bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S):
the published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
sheet; float32 outside the tensor cores).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def pass_flops(taps) -> int:
    """Least flops per output of one 1-D correlation pass: one multiply per
    non-zero tap, but one per mirrored pair of equal magnitude, and one add
    per non-zero tap but the first."""
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
    """Indices of the tap vectors not proportional to an earlier one."""
    unit = [v / v[np.argmax(np.abs(v))] for v in np.asarray(taps, np.float64)]
    keep = []
    for k, u in enumerate(unit):
        if not any(np.allclose(u, unit[j], rtol=1e-6, atol=1e-9) for j in keep):
            keep.append(k)
    return keep


def bank_flops(px: int, xtaps, ytaps) -> int:
    rows = sum(pass_flops(xtaps[k]) for k in distinct_rows(xtaps))
    return px * (rows + sum(pass_flops(y) for y in ytaps))


def level_shapes(h: int, w: int, levels: int):
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out


#: flops per pixel of the corner score c1 - |(c2, c3)|: two squares, a
#: sum, a root, a difference
SCORE_FLOPS = 5
#: G2's (c1, c2, c3): 16 distinct basis products, then per coefficient its
#: table's weights and sums (6 + 9, 4 + 7, 3 + 6)
G2_ENERGY_FLOPS = 16 + 15 + 11 + 9


def energy_flops(order: int) -> int:
    """Flops per pixel of (c1, c2, c3) and the score. G4: the 36 distinct
    products b_i b_j (i <= j, within the G and the H block), then for each
    quadratic form a weight and a sum per non-zero term."""
    if order == 2:
        return G2_ENERGY_FLOPS + SCORE_FLOPS
    from benchmark.reference import _g4_tables

    terms = 0
    for M in _g4_tables():
        sym = (M + M.T).triu()
        terms += int((sym.abs() > 1e-7).sum())
    return 36 + 2 * terms + SCORE_FLOPS


#: flops of one bilinear sample of C channels (3 lerps of C values) and
#: of steering one sample (G: 5 or 3 weights, H: 6 or 4; weights and sums)
SAMPLE_FLOPS = {2: 7 * 3 * 3, 4: 11 * 3 * 3}
STEER_FLOPS = {2: 2 * 3 + 2 * 4, 4: 2 * 5 + 2 * 6}


def frontend_work(batch: int, hw, fcfg: dict, in_bytes: int = 1) -> dict:
    """{bytes, flops, least_s, bound_by} of one extract_features call on
    ``batch`` frames of ``hw`` with the configuration's front-end
    settings (``in_bytes`` per input pixel as uploaded)."""
    from benchmark.reference import _BINOMIAL, bank_taps

    order = int(fcfg.get("order", 2))
    levels = int(fcfg.get("levels", 5))
    k = int(fcfg.get("keypoints_per_level", 256))
    grid = int(fcfg.get("descriptor_grid", 4))
    D = 2 * grid * grid
    shapes = level_shapes(int(hw[0]), int(hw[1]), levels)
    xt, yt = bank_taps(order)
    n_kp = k * levels
    nbytes = batch * shapes[0][0] * shapes[0][1] * in_bytes
    nbytes += batch * sum(h * w for h, w in shapes[1:]) * 4
    nbytes += batch * n_kp * (8 + 4 + 4 + 4 + 4 * D + 1)
    blur = pass_flops(_BINOMIAL[0])
    flops = 0
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        flops += batch * (h0 * w1 + h1 * w1) * blur
    for h, w in shapes:
        flops += batch * (bank_flops(h * w, xt, yt) + h * w * energy_flops(order))
    S = grid * grid
    flops += batch * n_kp * (S * (SAMPLE_FLOPS[order] + STEER_FLOPS[order]) + 3 * D)
    b_s, f_s = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(bytes=float(nbytes), flops=float(flops), least_s=max(b_s, f_s),
                bound_by="bytes" if b_s >= f_s else "operations")


"""The measurement probes' kernels G, S, V and M with their plain PyTorch versions.

The port's counterparts of the Pallas kernels in the reference's
``scripts/`` (probe_dma_gather.py, profile_v2_stages.py,
profile_frontend.py, probe_r3_variants.py, profile_variants.py), which
cvsteer_tpu_torch.probes drives:

- :func:`gather_rows` / :func:`gather_patches` (kernel G,
  ``kernels/csrc/probe_gather.cu``) — the gathers of the descriptor stage's
  rate probe;
- :func:`maps_stage` (kernel S, ``probe_maps_stages.cu``) — kernel E's
  template cut at a stage (load, row, col, coeff, full) with the outputs of
  profile_v2_stages.py ("v2") or profile_frontend.py ("frontend");
- :func:`maps_variant` (kernel V, ``probe_maps_variants.cu``) — CUDA-core
  variants of E's maps: another algebra (``TAILS``) or the ``carry`` of the
  row passes' overlap rows down a column of tiles;
- :func:`maps_mma` (kernel M, ``probe_maps_mma.cu``) — the matrix-unit
  variants on the tensor cores: the column pass (and in ``row="mma"`` the
  row pass) as bf16 products with fp32 sums.

The maps probes take the G2/H2 bank at width 4 (7 filters of 9 taps), as
the scripts ran it. Each wrapper takes its plain version only for a tensor
on the CPU; for a CUDA tensor it launches its kernel or raises (there is no
fallback), and it adds one to its launch count
(cvsteer_tpu_torch.kernels.launch_counts) where it launches. G, S and V
equal their plain versions bit for bit; M sums on the tensor cores in an
order of its own and agrees with its plain version to rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops.cuda_frontend import (
    _host, _maps_out, _on_cpu, _require, _unit_harmonic, g2_harmonic_sd, g2_steer_maps,
)
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain, reflect_indices
from cvsteer_tpu_torch.utils.precision import precise

STAGES = ("load", "row", "col", "coeff", "full")
OUTPUTS = ("v2", "frontend")
TAILS = ("base", "sd", "tail16", "sd_tail16", "sqrt", "factored")
#: (tail, carry, tile_h) that kernel V is built for: every tail at tile
#: height 64, and carry with base at 64 and with sd_tail16 at the scripts'
#: four tile heights
VARIANT_CASES = frozenset(
    [(t, False, 64) for t in TAILS] + [("base", True, 64)]
    + [("sd_tail16", True, th) for th in (32, 64, 96, 128)]
)
MMA_STAGES = ("row", "col", "coeff", "full")
#: (stage, row pass, column pass) that kernel M is built for
MMA_CASES = frozenset(
    [(s, "fp32", "bf16x3") for s in MMA_STAGES]
    + [(s, "fp32", "bf16x1") for s in ("col", "full")]
    + [(s, "mma", "bf16x3") for s in ("col", "full")]
)

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# Kernel G: gathers
# ---------------------------------------------------------------------------


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = tbl[idx[i]]`` with the indices clamped to the table."""
    return tbl[idx.long().clamp(0, tbl.shape[0] - 1)]


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``tbl [n, ...]`` at ``idx [m]`` (int32; clamped to ``[0, n)``,
    as jnp's gather clamps) -> ``[m, ...]`` (kernel G, rows)."""
    if _on_cpu(tbl) and _on_cpu(idx):
        return gather_rows_plain(tbl, idx)
    if idx.dtype != torch.int32 or idx.dim() != 1 or tbl.dim() < 1 or tbl.shape[0] < 1:
        raise ValueError(f"gather_rows: tbl {tuple(tbl.shape)}, idx {idx.dtype} {tuple(idx.shape)}")
    if not (tbl.is_contiguous() and idx.is_contiguous()) or tbl.device != idx.device:
        raise ValueError("gather_rows: expected contiguous tensors on one device")
    out = torch.empty((idx.shape[0],) + tuple(tbl.shape[1:]), dtype=tbl.dtype, device=tbl.device)
    row_bytes = tbl[0].numel() * tbl.element_size()
    if out.numel() == 0:
        return out
    lib = kernels.library()
    kernels.count_launch("probe_gather_rows")
    err = lib.cvs_gather_rows(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), tbl.shape[0],
                              idx.shape[0], row_bytes, kernels.stream_handle(tbl.device))
    kernels.check(err, "probe_gather_rows")
    return out


def gather_patches_plain(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                         ph: int = 16, pw: int = 256) -> torch.Tensor:
    """``out[k] = img[y_k : y_k + ph, x_k : x_k + pw]``, the starts clamped
    so the window fits (lax.dynamic_slice's rule): one slice per patch."""
    h, w = img.shape
    y, x = ys.long().clamp(0, h - ph), xs.long().clamp(0, w - pw)
    if y.numel() == 0:
        return img.new_empty((0, ph, pw))
    return torch.stack([img[a:a + ph, b:b + pw] for a, b in zip(y.tolist(), x.tolist())])


def gather_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   ph: int = 16, pw: int = 256) -> torch.Tensor:
    """``ph x pw`` windows of ``img [h, w]`` at ``(ys, xs)`` (int32 ``[k]``)
    -> ``[k, ph, pw]`` (kernel G, patches)."""
    if _on_cpu(img) and _on_cpu(ys) and _on_cpu(xs):
        return gather_patches_plain(img, ys, xs, ph, pw)
    h, w = img.shape
    if not (1 <= ph <= h and 1 <= pw <= w) or img.element_size() not in (1, 2, 4):
        raise ValueError(f"gather_patches: {ph}x{pw} patches of {img.dtype} {tuple(img.shape)}")
    for t in (ys, xs):
        if t.dtype != torch.int32 or t.shape != ys.shape or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("gather_patches: ys, xs must be contiguous int32 [k]")
    if not img.is_contiguous() or not (img.device == ys.device == xs.device):
        raise ValueError("gather_patches: expected contiguous tensors on one device")
    out = torch.empty((ys.shape[0], ph, pw), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    kernels.count_launch("probe_gather_patches")
    err = lib.cvs_gather_patches(img.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                                 ys.shape[0], h, w, ph, pw, img.element_size(),
                                 kernels.stream_handle(img.device))
    kernels.check(err, "probe_gather_patches")
    return out


# ---------------------------------------------------------------------------
# The plain pieces of the maps probes
# ---------------------------------------------------------------------------


def bf16_split(x: torch.Tensor):
    """(hi, lo) as float32: hi = bf16(x), lo = bf16(x - hi), round to nearest
    even (the reference's _row_pass_split and _kernel_presplit split)."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def col_conv_matrix(ytaps, tile_h: int, band_h: int) -> np.ndarray:
    """Banded ``[K, tile_h, band_h]`` matrix with ``C[k, i, i + t] =
    ytaps[k, t]`` (the reference's pallas_frontend._col_conv_matrix)."""
    yt = np.asarray(ytaps, np.float32)
    K, T = yt.shape
    C = np.zeros((K, tile_h, band_h), np.float32)
    for k in range(K):
        for i in range(tile_h):
            C[k, i, i:i + T] = yt[k]
    return C


def row_pass_plain(image: torch.Tensor, xtaps) -> torch.Tensor:
    """The bank's row passes at every image row: ``[..., H, W]`` ->
    ``[..., K, H, W]``, REFLECT_101 columns, taps in order (kernel E's
    strip_pass and filter_bank_plain's order)."""
    xt = torch.as_tensor(np.asarray(xtaps, np.float32), device=image.device)
    K, T = xt.shape
    r = (T - 1) // 2
    w = image.shape[-1]
    cols = reflect_indices(-r, w + r, w, image.device)
    padded = image.to(torch.float32).index_select(-1, cols).unsqueeze(-3)
    xk = xt[:, :, None, None]
    row = padded[..., 0:w] * xk[:, 0]
    for t in range(1, T):
        row = row + padded[..., t:t + w] * xk[:, t]
    return row


def _basis7(basis):
    return [basis[..., k, :, :] for k in range(7)]


def g2_harmonic(basis: torch.Tensor):
    """(c2, c3) without reuse of g2a +- g2c: every probe script's form."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = _basis7(basis)
    c2 = (
        0.5 * (g2a * g2a - g2c * g2c)
        + 0.46875 * (h2a * h2a - h2d * h2d)
        + 0.28125 * (h2b * h2b - h2c * h2c)
        + 0.1875 * (h2a * h2c - h2b * h2d)
    )
    c3 = (
        -(g2a * g2b) - g2b * g2c - 0.9375 * (h2c * h2d + h2a * h2b)
        - 1.6875 * h2b * h2c - 0.1875 * h2a * h2d
    )
    return c2, c3


def g2_harmonic_factored(basis: torch.Tensor):
    """(c2, c3) by the harmonic factorization (profile_variants.py's
    _kernel_factored): G2(t) = A + X cos 2t - Y sin 2t, H2(t) = P cos t +
    Q sin t + R cos 3t + S sin 3t."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = _basis7(basis)
    A = 0.5 * (g2a + g2c)
    X = 0.5 * (g2a - g2c)
    Y = g2b
    P = 0.75 * (h2a + h2c)
    Q = -0.75 * (h2b + h2d)
    Rc = 0.25 * h2a - 0.75 * h2c
    S = 0.25 * h2d - 0.75 * h2b
    c2 = 2.0 * A * X + 0.5 * (P - Q) * (P + Q) + P * Rc + Q * S
    c3 = -2.0 * A * Y + P * Q + P * S - Q * Rc
    return c2, c3


def g2_sqrt_maps(basis: torch.Tensor, c2, c3):
    """(edges, dark, bright) by the sqrt / cos / sin steering
    (profile_variants.py's _maps_from_coeffs, profile_frontend.py:119-134)."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = _basis7(basis)
    rho = torch.sqrt(c2 * c2 + c3 * c3)
    pos = rho > 0.0
    inv_rho = torch.where(pos, 1.0 / rho, 0.0)
    cos2t = torch.where(pos, c2 * inv_rho, 1.0)
    ct = torch.sqrt(torch.clamp_min(0.5 * (1.0 + cos2t), 0.0))
    st_mag = torch.sqrt(torch.clamp_min(0.5 * (1.0 - cos2t), 0.0))
    st = torch.where(c3 >= 0.0, st_mag, -st_mag)
    ct2, st2 = ct * ct, st * st
    ct3, st3 = ct2 * ct, st2 * st
    g2v = ct2 * g2a - 2.0 * ct * st * g2b + st2 * g2c
    h2v = ct3 * h2a - 3.0 * ct2 * st * h2b + 3.0 * ct * st2 * h2c - st3 * h2d
    return _maps_out(g2v, g2v * g2v, h2v * h2v, torch.float32)


def g2_tail16_maps(basis: torch.Tensor, c2, c3):
    """The sqrt-free steering with its multiply/add chains in bf16, each op
    an fp32 op rounded to bf16 (probe_r3_variants.py's tail16); (u, v) and
    what follows the chains stay fp32."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = _basis7(basis)
    u, v = _unit_harmonic(c2, c3)
    ub, vb, g2bb = u.to(BF16), v.to(BF16), g2b.to(BF16)
    h2ab, h2bb, h2cb, h2db = h2a.to(BF16), h2b.to(BF16), h2c.to(BF16), h2d.to(BF16)
    sb, db = (g2a + g2c).to(BF16), (g2a - g2c).to(BF16)
    g2v = 0.5 * (sb + ub * db) - vb * g2bb
    P = 0.5 * ((h2ab + 3.0 * h2cb) + ub * (h2ab - 3.0 * h2cb))
    Q = 0.5 * ((3.0 * h2bb + h2db) + ub * (3.0 * h2bb - h2db))
    PP, QQ = P * P, Q * Q
    h2sq_b = 0.5 * ((PP + QQ) + ub * (PP - QQ)) - vb * (P * Q)
    g2sq_b = g2v * g2v
    return _maps_out(g2v.float(), g2sq_b.float(), torch.clamp_min(h2sq_b.float(), 0.0),
                     torch.float32)


def _sum(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def row_split_outputs(hi: torch.Tensor, lo: torch.Tensor):
    """The v2 row stage from the bf16 parts ``[..., 7, H, W]`` of the 7
    filters' row-pass values: (sum of hi, sum of lo, their sum)."""
    th, tl = _sum(_basis7(hi)), _sum(_basis7(lo))
    return th, tl, th + tl


def col_outputs(basis: torch.Tensor, outputs: str):
    b = _basis7(basis)
    if outputs == "v2":
        return _sum(b), b[0] - b[1], b[2] - b[3]
    return b[0].clone(), b[1].clone(), b[3].clone()


def coeff_outputs(basis: torch.Tensor, outputs: str):
    c2, c3 = g2_harmonic(basis)
    return c2, c3, (c2 + c3 if outputs == "v2" else basis[..., 0, :, :].clone())


# ---------------------------------------------------------------------------
# Kernel S: kernel E cut at each stage
# ---------------------------------------------------------------------------


def maps_stage_plain(image: torch.Tensor, xtaps, ytaps, stage: str, outputs: str = "v2"):
    """Three float32 maps of kernel E's ``stage`` (STAGES) with the
    ``outputs`` convention (OUTPUTS); see kernels/csrc/probe_maps_stages.cu."""
    image = image.to(torch.float32)
    if stage == "load":
        return image.clone(), 2.0 * image, 3.0 * image
    if stage == "row":
        rows = row_pass_plain(image, xtaps)
        if outputs == "v2":
            return row_split_outputs(*bf16_split(rows))
        return tuple(rows[..., k, :, :].clone() for k in range(3))
    basis = filter_bank_plain(image, xtaps, ytaps)
    if stage == "col":
        return col_outputs(basis, outputs)
    if stage == "coeff":
        return coeff_outputs(basis, outputs)
    c2, c3 = g2_harmonic(basis)
    if outputs == "v2":
        return g2_steer_maps(basis, c2, c3)
    return g2_sqrt_maps(basis, c2, c3)


def _check_g2(xtaps, ytaps, name):
    xt = np.ascontiguousarray(xtaps, np.float32)
    yt = np.ascontiguousarray(ytaps, np.float32)
    if xt.shape != (7, 9) or yt.shape != (7, 9):
        raise ValueError(f"{name}: needs the G2/H2 bank at width 4 (7 x 9 taps), got "
                         f"{xt.shape}/{yt.shape}")
    return xt, yt


def _maps3(image, name, entry, xt, yt, *extra):
    """Launch one of S, V, M: three float32 maps like ``image``."""
    _require(image, "image", 2)
    *batch, h, w = image.shape
    n = int(np.prod(batch)) if batch else 1
    maps = tuple(torch.empty_like(image) for _ in range(3))
    if n == 0 or h == 0 or w == 0:
        return maps
    lib = kernels.library()
    kernels.count_launch(name)
    err = getattr(lib, entry)(
        image.data_ptr(), *(m.data_ptr() for m in maps), n, h, w, xt.shape[1],
        _host(xt), _host(yt), *extra, kernels.stream_handle(image.device),
    )
    kernels.check(err, name)
    return maps


def maps_stage(image: torch.Tensor, xtaps, ytaps, stage: str,
               outputs: str = "v2") -> Tuple[torch.Tensor, ...]:
    """Kernel S: ``image [..., H, W]`` float32 -> the three float32 maps of
    kernel E's ``stage`` (load, row, col, coeff, full), ``outputs`` "v2"
    (profile_v2_stages.py) or "frontend" (profile_frontend.py)."""
    if stage not in STAGES or outputs not in OUTPUTS:
        raise ValueError(f"maps_stage: stage {stage!r}, outputs {outputs!r}")
    xt, yt = _check_g2(xtaps, ytaps, "maps_stage")
    if _on_cpu(image):
        return maps_stage_plain(image, xt, yt, stage, outputs)
    return _maps3(image, "probe_maps_stages", "cvs_probe_stages", xt, yt,
                  STAGES.index(stage), OUTPUTS.index(outputs))


# ---------------------------------------------------------------------------
# Kernel V: CUDA-core variants of E
# ---------------------------------------------------------------------------


def maps_variant_plain(image: torch.Tensor, xtaps, ytaps, tail: str):
    """(edges, dark, bright) float32 by the variant ``tail`` (TAILS); the
    carry and the tile height change how the kernel gets there, not what."""
    basis = filter_bank_plain(image, xtaps, ytaps)
    if tail in ("sd", "sd_tail16"):
        c2, c3 = g2_harmonic_sd(basis)
    elif tail == "factored":
        c2, c3 = g2_harmonic_factored(basis)
    else:
        c2, c3 = g2_harmonic(basis)
    if tail in ("tail16", "sd_tail16"):
        return g2_tail16_maps(basis, c2, c3)
    if tail in ("sqrt", "factored"):
        return g2_sqrt_maps(basis, c2, c3)
    return g2_steer_maps(basis, c2, c3)


def maps_variant(image: torch.Tensor, xtaps, ytaps, tail: str = "base", *, carry: bool = False,
                 tile_h: int = 64) -> Tuple[torch.Tensor, ...]:
    """Kernel V: ``image [..., H, W]`` float32 -> (edges, dark, bright)
    float32 by ``tail`` (TAILS), at tile height ``tile_h``; with ``carry``
    one block walks a column of tiles keeping the row passes' overlap rows.
    VARIANT_CASES lists what the kernel is built for."""
    if (tail, bool(carry), int(tile_h)) not in VARIANT_CASES:
        raise ValueError(f"maps_variant: no kernel for tail {tail!r}, carry {carry}, tile {tile_h}")
    xt, yt = _check_g2(xtaps, ytaps, "maps_variant")
    if _on_cpu(image):
        return maps_variant_plain(image, xt, yt, tail)
    return _maps3(image, "probe_maps_variants", "cvs_probe_variants", xt, yt,
                  TAILS.index(tail), int(bool(carry)), int(tile_h))


# ---------------------------------------------------------------------------
# Kernel M: the tensor-core variants
# ---------------------------------------------------------------------------


def maps_mma_plain(image: torch.Tensor, xtaps, ytaps, stage: str = "full", row: str = "fp32",
                   col: str = "bf16x3"):
    """Kernel M's function in plain PyTorch: the row passes (fp32 in order,
    or ``row="mma"``: taps split hi/lo times the image rounded to bf16, two
    fp32 products), split hi/lo; then the column pass as the banded product
    through torch.matmul in fp32 (bf16x3: C_hi R_hi + C_hi R_lo + C_lo R_hi;
    bf16x1: C_hi R_hi), then the stage's v2 outputs (full: the sqrt
    steering)."""
    xt = np.asarray(xtaps, np.float32)
    yt = np.asarray(ytaps, np.float32)
    K, T = xt.shape
    r = (T - 1) // 2
    image = image.to(torch.float32)
    *batch, h, w = image.shape
    rows_idx = reflect_indices(-r, h + r, h, image.device)
    tall = image.index_select(-2, rows_idx)  # [..., h + 2r, w]
    with precise():
        if row == "mma":
            cols = reflect_indices(-r, w + r, w, image.device)
            padded = tall.index_select(-1, cols).to(BF16).float()
            S = torch.stack([padded[..., t:t + w] for t in range(T)])  # [T, ..., h + 2r, w]
            xh, xl = bf16_split(torch.from_numpy(xt).to(image.device))
            flat = S.reshape(T, -1)
            rows = (xh @ flat + xl @ flat).reshape((K,) + tuple(S.shape[1:])).movedim(0, -3)
        else:
            rows = row_pass_plain(tall, xt)  # [..., K, h + 2r, w]
        hi, lo = bf16_split(rows)
        if stage == "row":
            return row_split_outputs(hi[..., r:r + h, :], lo[..., r:r + h, :])
        C = torch.from_numpy(col_conv_matrix(yt, h, h + 2 * r)).to(image.device)
        ch, cl = bf16_split(C)
        basis = []
        for k in range(K):
            b = ch[k] @ hi[..., k, :, :]
            if col == "bf16x3":
                b = b + ch[k] @ lo[..., k, :, :] + cl[k] @ hi[..., k, :, :]
            basis.append(b)
        basis = torch.stack(basis, -3)
    if stage == "col":
        return col_outputs(basis, "v2")
    if stage == "coeff":
        return coeff_outputs(basis, "v2")
    return g2_sqrt_maps(basis, *g2_harmonic(basis))


#: Kernel M against its plain version. The tensor cores sum in an order of
#: their own, a basis value within ~2^-20 of the sum of its terms' sizes.
#: The col and coeff stages (linear and quadratic in the basis) hold to 1e-5
#: of each output's scale; after the rowmxu row pass to 1e-4 (its fp32 row
#: values may split into bf16 parts ~2^-17 apart). The row stage runs on the
#: CUDA cores in the plain order: bit for bit. The full maps steer by the
#: basis's orientation, which is ill-conditioned where the energy is nearly
#: isotropic and at the half-angle's singular point (c3 ~ 0, c2 < 0): they
#: hold to MMA_FULL_MAX of scale everywhere, to 1e-5 of scale at all but
#: MMA_FULL_FRACTION of the pixels, and to MMA_FULL_FIRM of scale where the
#: orientation is firm (|c3| > 1e-2 max |c3|).
MMA_TOL, MMA_TOL_ROW_MMA = 1e-5, 1e-4
MMA_FULL_MAX, MMA_FULL_FRACTION, MMA_FULL_FIRM = 1e-2, 2e-2, 1e-3


def mma_agreement(got, want, stage: str, row: str, c3=None) -> dict:
    """How kernel M's maps ``got`` agree with its plain version's ``want``:
    per-output maxima relative to scale, and for the full stage the share of
    pixels beyond 1e-5 of scale and the maximum on firm pixels (``c3``: the
    plain version's coefficient). ``ok`` applies the tolerance above."""
    rel = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for g, w in zip(got, want)]
    res = dict(max_rel=max(rel), finite=all(bool(torch.isfinite(g).all()) for g in got))
    if stage == "row":
        res["ok"] = res["finite"] and all(torch.equal(g, w) for g, w in zip(got, want))
    elif stage == "full":
        firm = c3.abs() > 1e-2 * c3.abs().max()
        res["beyond_1e-5"] = max(((g - w).abs() > 1e-5 * w.abs().max()).float().mean().item()
                                 for g, w in zip(got, want))
        res["firm_max_rel"] = max(((g - w).abs()[firm].max().item() if bool(firm.any()) else 0.0)
                                  / max(w.abs().max().item(), 1e-30) for g, w in zip(got, want))
        res["ok"] = (res["finite"] and res["max_rel"] <= MMA_FULL_MAX
                     and res["beyond_1e-5"] <= MMA_FULL_FRACTION and res["firm_max_rel"] <= MMA_FULL_FIRM)
    else:
        res["ok"] = res["finite"] and res["max_rel"] <= (MMA_TOL_ROW_MMA if row == "mma" else MMA_TOL)
    return res


def maps_mma(image: torch.Tensor, xtaps, ytaps, stage: str = "full", row: str = "fp32",
             col: str = "bf16x3") -> Tuple[torch.Tensor, ...]:
    """Kernel M: ``image [..., H, W]`` float32 -> the three float32 maps of
    ``stage`` (row, col, coeff, full) with the column pass on the tensor
    cores (``col`` "bf16x3" or "bf16x1") and the row pass in fp32 on the
    CUDA cores or, ``row="mma"``, on the tensor cores. MMA_CASES lists what
    the kernel is built for."""
    if (stage, row, col) not in MMA_CASES:
        raise ValueError(f"maps_mma: no kernel for stage {stage!r}, row {row!r}, col {col!r}")
    xt, yt = _check_g2(xtaps, ytaps, "maps_mma")
    if _on_cpu(image):
        return maps_mma_plain(image, xt, yt, stage, row, col)
    return _maps3(image, "probe_maps_mma", "cvs_probe_mma", xt, yt, MMA_STAGES.index(stage),
                  int(row == "mma"), int(col == "bf16x3"))

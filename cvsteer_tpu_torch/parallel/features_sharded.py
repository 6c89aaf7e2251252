"""Batch- and row-sharded feature extraction over a mesh (the twin of
cvsteer_tpu.parallel.features_sharded): pyramid, detection and
descriptors with image rows sharded over ``space`` and the batch over
``data``, equal bit for bit to the single-device generic path
(features.frontend._extract_features_generic) on the same device.

Per pyramid level, with rows sharded over ``space``:

  halo      one halo exchange of ``conv_r + desc_r`` rows (REFLECT_101 at
            the global borders, as the bank's padding).
  basis     the bank on the haloed slab with the rows unpadded
            (ops.sepconv.filter_bank_xla): valid on the slab +- desc_r
            rows, the descriptor support.
  detect    NMS over the true haloed neighbourhood; ``row_range`` lets only
            the rows this rank owns (within the global border) select, so
            every keypoint of the level is found by exactly one rank.
  merge     an all_gather of every rank's candidates (each keeps the full
            level capacity, so no global winner is lost) and a re-selection
            by (score desc, flat index asc): a stable sort by score after
            one by index.
  desc      each rank samples the keypoints it found, the others' ``valid``
            cleared, and one all_reduce sums the table (the others add
            zeros). The sampler sees only the basis rows inside the image
            (the first rank's top halo and the last rank's bottom halo are
            left out) and coordinates made in image rows, so its edge clamp
            is the single-device one.
  next      the next level's slab: the 5-tap binomial blur on the slab +- 2
            halo rows with the rows unpadded, then even rows and columns
            (cv2.pyrDown's sums in pyr_down_plain's order, which kernel B
            keeps too).

Levels too small to shard (a slab no taller than the halo, or an odd slab
that would break the stride-2 phase) are gathered once and run replicated
on every rank through the single-device level code (features.frontend.
_level_features: kernel A for the basis and kernel B for the next level on
the card); levels only shrink, so the pipeline never re-shards. On every
level kernel D samples the descriptors.

Collectives per sharded level: one halo exchange, one all_gather (the
candidates, one packed tensor), one all_reduce (the descriptors).
"""

from __future__ import annotations

import math

import torch

from cvsteer_tpu_torch.features.descriptors import (
    phase_descriptors_batch,
    phase_descriptors_g4_batch,
)
from cvsteer_tpu_torch.features.frontend import (
    Features,
    FrontendConfig,
    _level_features,
    _score_maps,
)
from cvsteer_tpu_torch.features.keypoints import Keypoints, _detect_core
from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.filters import g4 as fg4
from cvsteer_tpu_torch.ops.cuda_frontend import _BINOMIAL5
from cvsteer_tpu_torch.ops.pyramid import pyr_down
from cvsteer_tpu_torch.ops.sepconv import filter_bank_xla
from cvsteer_tpu_torch.parallel import halo
from cvsteer_tpu_torch.parallel.mesh import mesh_axis


def _desc_radius(cfg: FrontendConfig) -> int:
    """Rows of basis needed beyond an owned keypoint's row for sampling:
    max rotated grid offset + 1 bilinear row, rounded up."""
    span = (cfg.descriptor_grid - 1) / 2.0 * cfg.descriptor_spacing
    return int(math.ceil(span * math.sqrt(2.0))) + 2


def _order_fns(cfg: FrontendConfig, bank):
    """(bank, basis_fn, coeff_fn, desc_batch_fn) of the filter order."""
    if cfg.order == 4:
        bank = fg4.g4_bank() if bank is None else bank
        return bank, lambda im: fg4.g4_basis(im, bank), fg4.energy_coefficients, phase_descriptors_g4_batch
    bank = fg2.g2_bank() if bank is None else bank
    return bank, lambda im: fg2.g2_basis(im, bank), fg2.energy_coefficients, phase_descriptors_batch


def _merge_candidates(pool: torch.Tensor, k: int) -> torch.Tensor:
    """The best ``k`` rows of a gathered candidate pool ``[B, S*K, F]``
    (fields score, flat index, y, x, theta, valid, shard): score
    descending among the valid, ties and the invalid by flat index
    ascending, as the single-device top-k over the flat masked map."""
    key = torch.where(pool[..., 5] > 0, pool[..., 0], float("-inf"))
    by_flat = torch.sort(pool[..., 1], dim=-1, stable=True).indices
    by_score = torch.sort(key.gather(1, by_flat), dim=-1, descending=True, stable=True).indices
    order = by_flat.gather(1, by_score)[:, :k]
    return pool.gather(1, order[..., None].expand(-1, -1, pool.shape[-1]))


def _detect_slab(score, ct, st, *, k, cfg, lo, hi, off) -> torch.Tensor:
    """Candidates of one haloed score slab ``[b, hloc, w]`` whose row i is
    image row ``off + i``: ``[b, k, 6]`` float32 rows (score, flat index,
    y, x, theta, valid), the coordinates in image rows (all exact: the flat
    index stays below 2**24)."""
    hloc, w = score.shape[-2:]
    dev = score.device
    row = (torch.arange(hloc, device=dev) + off).to(torch.float32)[:, None].expand_as(score)
    col = torch.arange(w, device=dev).to(torch.float32).expand_as(score)
    yx, s, valid, aux = _detect_core(
        score, [ct, st, row, col], k, cfg.nms_radius, cfg.threshold, None, False,
        row_range=(lo, hi), row_offset=off,
    )
    theta = torch.atan2(aux[..., 1], aux[..., 0])
    flat = aux[..., 2] * float(w) + aux[..., 3]
    return torch.stack([s, flat, yx[..., 0], yx[..., 1], theta, valid.to(torch.float32)], -1)


def sharded_extract_features(
    block: torch.Tensor,
    mesh,
    cfg: FrontendConfig = FrontendConfig(),
    bank=None,
    *,
    data_axis: str = "data",
    space_axis: str = "space",
) -> Features:
    """The generic feature path of this rank's block (parallel.shard_batch)
    of a batch ``[B, H, W]`` over a ``(data, space)`` mesh.

    H and W must halve exactly through the pyramid (divisible by
    2**(levels-1)). Returns the Features of this rank's ``data`` block,
    the same on every rank of its ``space`` group."""
    S, idx, group = mesh_axis(mesh, space_axis)
    b, hs0, W = block.shape
    H = hs0 * S
    if H % (1 << (cfg.levels - 1)) or W % (1 << (cfg.levels - 1)):
        raise ValueError("H, W must halve exactly through the pyramid")
    if H * W > 2**24:
        raise ValueError(f"{H} x {W} pixels: flat indices must stay below 2**24")
    if cfg.order not in (2, 4):
        raise ValueError(f"order must be 2 or 4, got {cfg.order}")

    bank, basis_fn, coeff_fn, desc_fn = _order_fns(cfg, bank)
    conv_r = bank.radius
    # slab margin: the descriptor support and the NMS window both see true
    # neighbour rows beyond the owned slab
    desc_r = max(_desc_radius(cfg), cfg.nms_radius)
    halo_r = conv_r + desc_r
    nms_b = cfg.nms_radius + 1  # the detector's border (features.keypoints)
    bin_taps = _BINOMIAL5.reshape(1, -1)

    # static per-level plan: shard while the slabs stay taller than the
    # halo (REFLECT_101 reads radius + 1 rows) and even (the stride-2
    # phase); replicate from then on
    plan, shardable = [], True
    for lvl in range(cfg.levels):
        h_l = H >> lvl
        hs = h_l // S
        shardable = shardable and h_l % S == 0 and hs >= max(halo_r + 1, 2 * nms_b)
        plan.append(shardable)
        shardable = shardable and hs % 2 == 0

    def gather_rows(slab):
        return torch.cat(halo.all_gather(slab.contiguous(), group), dim=-2)

    parts = []
    slab, full = block.to(torch.float32), None
    for lvl in range(cfg.levels):
        if not plan[lvl]:
            if full is None:
                full = gather_rows(slab)
            parts.append(_level_features(full, lvl, cfg, basis_fn=basis_fn, coeff_fn=coeff_fn,
                                         desc_batch_fn=desc_fn))
            if lvl + 1 < cfg.levels:
                full = pyr_down(full)
            continue

        h_l, w_l = H >> lvl, W >> lvl
        hs = h_l // S
        k_l = cfg.level_capacity(lvl)
        g0 = idx * hs  # this rank's first image row at this level
        hal = halo.halo_exchange_rows(slab, halo_r, group)
        # basis valid on the slab +- desc_r rows: local row i is image row off + i
        basis, score, ctm, stm = _score_maps(
            hal,
            basis_fn=lambda im: filter_bank_xla(im, bank.xtaps, bank.ytaps, pad_axes=(False, True)),
            coeff_fn=coeff_fn, score=cfg.score,
        )
        off = g0 - desc_r
        lo = max(nms_b - off, desc_r)
        hi = min(h_l - nms_b - off, desc_r + hs)
        cand = _detect_slab(score, ctm, stm, k=k_l, cfg=cfg, lo=lo, hi=hi, off=off)
        shard = torch.full(cand.shape[:-1] + (1,), float(idx), device=cand.device)
        pool = torch.cat(halo.all_gather(torch.cat([cand, shard], -1), group), dim=1)
        merged = _merge_candidates(pool, k_l)
        ms, myx, mth = merged[..., 0], merged[..., 2:4], merged[..., 4]
        mv = merged[..., 5] > 0
        own = mv & (merged[..., 6] == float(idx))

        # the sampler's rows: the image's only (its edge clamp is then the
        # single-device one), coordinates in image rows moved by the origin
        first = desc_r if idx == 0 else 0
        last = desc_r + hs if idx == S - 1 else basis.shape[-2]
        kp = Keypoints(yx=myx, score=ms,
                       theta=torch.zeros_like(mth) if cfg.upright_desc else mth, valid=own)
        desc = desc_fn(basis[..., first:last, :], kp, grid=cfg.descriptor_grid,
                       spacing=cfg.descriptor_spacing, pi_invariant=cfg.desc_pi_invariant,
                       row_origin=off + first)
        desc = halo.all_reduce_sum(desc, group)
        parts.append(Features(
            yx=torch.where(mv[..., None], myx, 0.0) * float(2**lvl),
            score=torch.where(mv, ms, 0.0),
            theta=torch.where(mv, mth, 0.0),
            level=torch.full(ms.shape, lvl, dtype=torch.int32, device=ms.device),
            desc=desc,
            valid=mv,
        ))

        if lvl + 1 < cfg.levels:
            if plan[lvl + 1]:  # even local rows are even image rows: hs is even
                blurred = filter_bank_xla(hal[..., halo_r - 2: halo_r + hs + 2, :], bin_taps,
                                          bin_taps, pad_axes=(False, True))[..., 0, :, :]
                slab = blurred[..., ::2, ::2].contiguous()
            else:
                full = pyr_down(gather_rows(slab))
    return Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))

"""Device-resident monocular VO: the whole map on the device, each frame two
captured CUDA graphs (twin of cvsteer_tpu.slam.vo_device, one stream).

The host engine (slam.vo) keeps the map in host numpy and runs each frame
as thousands of eager launches and several fetches. Here the whole mutable
VO state is a :class:`DeviceMap` of tensors that stay on the device:

- a landmark store ``X [Lmax, 3]`` + ``lm_valid [Lmax]`` whose culled slots
  are reused (prefix-sum free-slot compaction);
- a keyframe ring ``[W, ...]``: each window keyframe's normalized pixels,
  feature validity, observation table (feature -> landmark slot) and pose,
  plus the newest keyframe's descriptors for matching.

The reference runs a frame as one jitted step with a ``lax.cond`` around
the promotion. A CUDA graph has no such branch, so the step is two halves,
each captured once as a CUDA graph over static buffers:

- **T** (every frame): the keyframe match (or the landmark-store match in
  ``track_local_map`` mode), PnP with the projective rescue, the flow rule,
  the forced gap from the carried ``since_kf`` and the promotion decision.
  It updates ``since_kf`` and writes the pose, the counts and the flags into
  one small int32 buffer, which the host fetches with one copy.
- **P** (only when the fetched flag says so): inheritance, DLT
  triangulation and its gate, eviction under capacity pressure, slot
  allocation, the landmark descriptor refresh, the ring shift, then the
  windowed Schur BA over the ring's landmark union and culling, all in
  place on the map's buffers; the new keyframe's poses and observation row
  come home with one more copy.

The map's tensors are static buffers: uploads write into them with
``copy_`` and never rebind them, and every shape is fixed by the config
(N, D, W, Lmax), so the two graphs are captured once and never again
(:attr:`DeviceVO.captures`). On the CPU the same two halves run eagerly.

With ``VOConfig.loop_closure`` T also computes the frame's keyframe
signature and its closure candidates against the signature store
(``sig``, ``sig_n``), and P appends the signature on promotion; with
``ground_height_m > 0`` T observes the ground height and P runs the ground
controller (``ground_hist``) and rescales the window and the live map
about the newest camera center. Both are static structure fixed at
capture.

Rare events stay on the host: two-view bootstrap, relocalization after
tracking loss, a speed-prior clamp and a loop-closure event sync the
device state down, run the host engine's logic (slam.vo, slam.loopclosure
on this engine's device) and write the result back into the same buffers.

Waiting for the serving port (ROADMAP.md): the fleets' host ground path
(the reference's ``_ground_prior`` / ``_ground_rescale_jit``), chunked
stepping and closure deferral inside a chunk (``_defer_closure``,
``_pending_closure``).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from cvsteer_tpu_torch.features.frontend import Features
from cvsteer_tpu_torch.features.matching import match_descriptors
from cvsteer_tpu_torch.geometry.camera import normalize_pixels
from cvsteer_tpu_torch.geometry.pose import triangulate
from cvsteer_tpu_torch.slam import vo as hostvo
from cvsteer_tpu_torch.slam import vo_core
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust
from cvsteer_tpu_torch.slam.vo import Keyframe, VOConfig, VOState, init_vo
from cvsteer_tpu_torch.utils.precision import precise


class DeviceMap(NamedTuple):
    """The device-resident VO state, carried frame to frame.

    X        [Lmax, 3]   landmark positions (slot-indexed; slots are the
                         host mirror's landmark ids), float32.
    lm_valid [Lmax]      slot occupancy (culled slots are reused).
    lm_gen   [Lmax]      slot generation (int32), bumped when the slot's
                         landmark is culled or evicted: an observation
                         stamped with an older generation refers to a
                         previous tenant of the slot.
    kf_uv    [W, N, 2]   window keyframes' normalized (undistorted) pixels.
    kf_fvalid[W, N]      feature validity per window keyframe.
    kf_obs   [W, N]      feature -> landmark slot (-1 = none), int32.
    kf_R     [W, 3, 3]   window keyframe rotations (world->camera).
    kf_t     [W, 3]      window keyframe translations.
    kf_live  [W]         ring slot holds a real keyframe (reals are
                         contiguous at the end of the ring; newest = W-1).
    kf_desc  [N, D]      newest keyframe's descriptors (matching target);
                         a copy, never the keyframe's own tensor.
    lm_desc  [Lmax, D]   per-landmark descriptor (the newest keyframe
                         observation wins): the matching target of
                         ``VOConfig.track_local_map``.
    sig      [Kcap, D]   every keyframe's signature (VOConfig.loop_closure;
                         None otherwise), Kcap = loop_sig_capacity.
    sig_n    []          int32 keyframes indexed (== the next row).
    since_kf []          int32 frames since the last promotion: the step
                         computes the forced promotion gap itself.
    ground_hist [3]      the ground controller's last height observations
                         (ground_height_m > 0; None otherwise).
    """

    X: torch.Tensor
    lm_valid: torch.Tensor
    lm_gen: torch.Tensor
    kf_uv: torch.Tensor
    kf_fvalid: torch.Tensor
    kf_obs: torch.Tensor
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    kf_live: torch.Tensor
    kf_desc: torch.Tensor
    lm_desc: torch.Tensor
    sig: Optional[torch.Tensor] = None
    sig_n: Optional[torch.Tensor] = None
    since_kf: Optional[torch.Tensor] = None
    ground_hist: Optional[torch.Tensor] = None


class StepOut(NamedTuple):
    """One frame's fetch, on the host: what the host needs every frame, and
    on a promotion the refined ring poses and the new keyframe's
    observation row (None on other frames: P did not run)."""

    R: np.ndarray  # [3, 3] tracked pose of this frame
    t: np.ndarray  # [3]
    n_tracked: int  # PnP inlier count
    n_valid: int  # feature count of the frame
    promoted: bool  # a keyframe was created on the device
    lost: bool  # tracking lost -> the host relocalizes
    kf_R: Optional[np.ndarray] = None  # [W, 3, 3] (BA-refined)
    kf_t: Optional[np.ndarray] = None  # [W, 3]
    obs_new: Optional[np.ndarray] = None  # [N] the new keyframe's obs table
    obs_gen: Optional[np.ndarray] = None  # [N] generation stamps of obs_new
    lm_count: Optional[int] = None  # occupied landmark slots
    ground_h: float = 0.0  # ground-height observation (0 = off / too few)
    ground_r: Optional[float] = None  # the controller's ratio (P ran, prior on)
    cand_idx: Optional[np.ndarray] = None  # [M] closure candidates (store on)
    cand_score: Optional[np.ndarray] = None  # [M] their cosines (-inf masked)


def _free_slots(lm_valid):
    """(free_slots [Lmax] int32, n_free): the r-th entry is the slot id of
    the r-th free slot, Lmax beyond them. Prefix-sum compaction: no sort,
    no dynamic shapes."""
    Lmax = lm_valid.shape[0]
    free = ~lm_valid
    rank = torch.cumsum(free, 0, dtype=torch.int32) - 1
    slots = torch.full((Lmax + 1,), Lmax, dtype=torch.int32, device=lm_valid.device)
    slots = slots.index_put_(
        (torch.where(free, rank, Lmax).long(),),
        torch.arange(Lmax, dtype=torch.int32, device=lm_valid.device),
    )[:Lmax]
    return slots, free.sum(dtype=torch.int32)


def _last_wins(tgt, n_cols):
    """Per column of ``[..., n_cols + 1)`` (the last one is the dump), the
    highest position along the last axis of ``tgt`` that targets it, -1
    where none does: the explicit winner of a scatter whose indices may
    repeat (CUDA's index_put_ leaves that winner undefined)."""
    pos = torch.arange(tgt.shape[-1], device=tgt.device).expand(tgt.shape).contiguous()
    win = torch.full((*tgt.shape[:-1], n_cols + 1), -1, dtype=torch.int64, device=tgt.device)
    return win.scatter_reduce_(-1, tgt, pos, "amax")[..., :n_cols]


def _window_ba(m: DeviceMap, *, iterations, huber_delta) -> DeviceMap:
    """Windowed Schur BA over the ring's landmark-slot union.

    The union comes from sorting the flattened observation tables ([W*N]
    entries, invalid -> the Lmax sentinel) and keeping first occurrences,
    compacted to the front by prefix-sum rank: the grid is static at
    [W, min(W*N, Lmax)] columns. Gauge: padding ring slots and the two
    oldest real keyframes are held fixed. Columns whose mean reprojection
    error exceeds vo_core.cull_bar are culled (their slot generation
    bumps, their observations clear). Returns the updated map."""
    W, N = m.kf_obs.shape
    Lmax = m.X.shape[0]
    L_cap = min(W * N, Lmax)
    dev = m.X.device

    obs_ok = m.kf_live[:, None] & m.kf_fvalid & (m.kf_obs >= 0)
    flat = torch.where(obs_ok, m.kf_obs, Lmax).reshape(-1)
    sorted_slots = torch.sort(flat).values
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev), sorted_slots[1:] != sorted_slots[:-1]
    ])
    uniq = first & (sorted_slots < Lmax)
    rank = torch.cumsum(uniq, 0, dtype=torch.int32) - 1  # [W*N], < Lmax always

    # compacted column -> slot id (Lmax sentinel for dead columns)
    comp = torch.full((L_cap + 1,), Lmax, dtype=torch.int32, device=dev)
    comp = comp.index_put_((torch.where(uniq, rank, L_cap).long(),), sorted_slots)[:L_cap]
    col_ok = comp < Lmax

    # per-observation compacted column: first-occurrence rank of its slot
    p = torch.searchsorted(sorted_slots, m.kf_obs.contiguous()).clamp_max(W * N - 1)
    tgt = torch.where(obs_ok, rank[p], L_cap).long()  # L_cap = dump column
    win = _last_wins(tgt, L_cap)  # [W, L_cap] feature observing each column
    hit = win >= 0
    uv_grid = torch.where(
        hit[..., None],
        torch.gather(m.kf_uv, 1, win.clamp_min(0)[..., None].expand(W, L_cap, 2)),
        0.0,
    )
    mask = hit & col_ok[None, :]

    X_cols = torch.where(col_ok[:, None], m.X[comp.clamp_max(Lmax - 1).long()], 0.0)

    # Gauge: padding ring slots held fixed; the two oldest real keyframes
    # pin rotation/translation and monocular scale (as slam.vo does).
    first_real = W - m.kf_live.sum()
    fixed = (~m.kf_live) | (torch.arange(W, device=dev) < first_real + 2)

    problem = BAProblem(uv=uv_grid, mask=mask, fixed_cameras=fixed, huber_delta=huber_delta)
    final, _ = bundle_adjust(BAState(R=m.kf_R, t=m.kf_t, X=X_cols), problem, iterations=iterations)

    # Under-constrained window (< 8 landmark columns): keep the raw state,
    # as the host twin declines such solves.
    ba_ok = col_ok.sum() >= 8
    kf_R = torch.where(ba_ok, final.R, m.kf_R)
    kf_t = torch.where(ba_ok, final.t, m.kf_t)
    wb = ba_ok & col_ok
    X = torch.cat([m.X, m.X.new_zeros(1, 3)]).index_put_(
        (torch.where(wb, comp, Lmax).long(),), torch.where(wb[:, None], final.X, 0.0)
    )[:Lmax]

    mean_err = vo_core.masked_mean_reproj(final, problem)
    nobs = mask.to(mean_err.dtype).sum(0)
    bad = ba_ok & col_ok & (nobs > 0) & (mean_err > vo_core.cull_bar(huber_delta))
    culled = torch.zeros(Lmax + 1, dtype=torch.bool, device=dev)
    culled = culled.index_put_((torch.where(bad, comp, Lmax).long(),), bad)[:Lmax]

    lm_valid = m.lm_valid & ~culled
    lm_gen = m.lm_gen + culled.to(m.lm_gen.dtype)
    obs_culled = (m.kf_obs >= 0) & culled[m.kf_obs.clamp_min(0).long()]
    kf_obs = torch.where(obs_culled, -1, m.kf_obs)
    return m._replace(X=X, lm_valid=lm_valid, lm_gen=lm_gen, kf_obs=kf_obs, kf_R=kf_R, kf_t=kf_t)


def _promote(m: DeviceMap, uv_new, desc, fvalid, idx, obs_pre, R, t, sig_new=None,
             *, iterations, huber_delta, tri_angle=1.0) -> DeviceMap:
    """Keyframe promotion on the device: inheritance, triangulation, gate,
    eviction, slot allocation, descriptor refresh, ring shift, signature
    append, windowed BA, culling.

    ``obs_pre [N]``: the new frame's inherited landmark associations (from
    the keyframe match, or the landmark-store match in local-map mode).
    ``idx [N]`` is always the keyframe match: a fresh landmark needs the
    previous view. ``sig_new [D]``: the frame's signature, written to the
    store's next row (dropped past the store's capacity)."""
    N = uv_new.shape[0]
    W = m.kf_obs.shape[0]
    Lmax = m.X.shape[0]
    dev = m.X.device
    obs_last = m.kf_obs[-1]
    matched = idx >= 0
    idx0 = idx.clamp_min(0)

    # fresh candidates: matched keyframe features with no landmark on either
    # side (obs_pre may carry local-map associations the keyframe table
    # lacks: never triangulate a duplicate)
    fresh = (
        matched & (obs_last < 0) & m.kf_fvalid[-1] & fvalid[idx0] & (obs_pre[idx0] < 0)
    )
    enough = fresh.sum() >= 8  # the host's skip_tri rule
    P1 = torch.cat([m.kf_R[-1], m.kf_t[-1][:, None]], 1)
    P2 = torch.cat([R, t[:, None]], 1)
    Xc = triangulate(P1, P2, m.kf_uv[-1], uv_new[idx0])  # [N, 3]
    ok = fresh & enough & vo_core.triangulation_gate(Xc, P1, P2, tri_angle)

    # capacity pressure: when the free slots cannot take the gated
    # candidates, evict landmarks no window keyframe observes
    obs_ok_w = m.kf_live[:, None] & m.kf_fvalid & (m.kf_obs >= 0)
    window_live = torch.zeros(Lmax + 1, dtype=torch.bool, device=dev).index_put_(
        (torch.where(obs_ok_w, m.kf_obs, Lmax).reshape(-1).long(),),
        torch.ones(W * N, dtype=torch.bool, device=dev),
    )[:Lmax]
    evict = (ok.sum() > (~m.lm_valid).sum()) & m.lm_valid & ~window_live
    lm_valid = m.lm_valid & ~evict
    lm_gen = m.lm_gen + evict.to(m.lm_gen.dtype)

    # capacity + slot allocation: ring reuse of culled/free slots
    free, n_free = _free_slots(lm_valid)
    ok = ok & (torch.cumsum(ok, 0) <= n_free)
    rank = torch.cumsum(ok, 0) - 1
    slot = torch.where(ok, free[rank.clamp(0, Lmax - 1)], -1)  # int32
    dump = torch.where(ok, slot, Lmax).long()
    X = torch.cat([m.X, m.X.new_zeros(1, 3)]).index_put_(
        (dump,), torch.where(ok[:, None], Xc, 0.0)
    )[:Lmax]
    lm_valid = torch.cat([lm_valid, lm_valid.new_zeros(1)]).index_put_((dump,), ok)[:Lmax]

    # the previous keyframe observes the new landmarks too, and the new
    # frame's features pick them up
    obs_prev = torch.where(ok, slot, obs_last)
    obs_new = torch.cat([obs_pre, obs_pre.new_full((1,), -1)]).index_put_(
        (torch.where(ok, idx0, N),), torch.where(ok, slot, -1)
    )[:N]

    # landmark descriptor store: the new keyframe's descriptor becomes each
    # observed landmark's matching target
    win = _last_wins(torch.where(obs_new >= 0, obs_new, Lmax).long(), Lmax)
    lm_desc = torch.where((win >= 0)[:, None], desc[win.clamp_min(0)], m.lm_desc)

    def shift(a, new_row):  # drop the oldest ring slot, append at W-1
        return torch.cat([a[1:], new_row[None]])

    if m.sig is not None:
        fits = m.sig_n < m.sig.shape[0]
        row = torch.where(fits, m.sig_n, 0).long().reshape(1)
        keep = m.sig.index_select(0, row)[0]
        m = m._replace(
            sig=m.sig.index_copy(0, row, torch.where(fits, sig_new, keep)[None]),
            sig_n=m.sig_n + 1,
        )
    m = m._replace(
        X=X,
        lm_valid=lm_valid,
        lm_gen=lm_gen,
        kf_uv=shift(m.kf_uv, uv_new),
        kf_fvalid=shift(m.kf_fvalid, fvalid),
        kf_obs=shift(torch.cat([m.kf_obs[:-1], obs_prev[None]]), obs_new),
        kf_R=shift(m.kf_R, R),
        kf_t=shift(m.kf_t, t),
        kf_live=shift(m.kf_live, torch.ones((), dtype=torch.bool, device=dev)),
        kf_desc=desc,
        lm_desc=lm_desc,
    )
    return _window_ba(m, iterations=iterations, huber_delta=huber_delta)


class _TrackOut(NamedTuple):
    """Track-phase results that the promotion consumes, and the frame's
    flags."""

    uv_new: torch.Tensor  # [N, 2] normalized pixels of this frame
    idx: torch.Tensor  # [N] keyframe match (triangulation pairs), int64
    obs_pre: torch.Tensor  # [N] inherited landmark associations, int32
    R: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor  # PnP inlier count
    n_valid: torch.Tensor
    lost: torch.Tensor
    promote: torch.Tensor
    ground_h: torch.Tensor  # ground-height observation (0 when off)


def _inherit(N, use, feat, ids):
    """[N] int32: ``ids[i]`` at new-frame feature ``feat[i]`` where
    ``use[i]``, else -1 (``feat`` is a match, so its used entries are
    distinct)."""
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=ids.device)
    return out.index_put_(
        (torch.where(use, feat, N).long(),), torch.where(use, ids, -1).to(torch.int32)
    )[:N]


def _track_phase(
    m: DeviceMap, yx, desc, fvalid, Rp, tp, force_kf,
    *, K, ratio, track_iters, huber_delta, min_track, dual_init,
    local_map=False, rescue_radius=0.0, rescue_min_cos=0.6, kf_min_flow=0.0,
    ground_prior=False,
) -> _TrackOut:
    """Match + PnP tracking + the keyframe decision, and with
    ``ground_prior`` the ground-height observation of the mode's tracked
    associations. Reads ``m`` only."""
    N = yx.shape[0]
    Lmax = m.X.shape[0]
    uv_new = normalize_pixels(yx, K)

    # the keyframe match: fresh-landmark triangulation at promotion needs
    # associations to the previous view
    idx = match_descriptors(m.kf_desc, m.kf_fvalid[-1], desc, fvalid, ratio=ratio).index
    obs_last = m.kf_obs[-1]
    has_lm = obs_last >= 0

    if local_map:  # match the frame against the landmark store
        idx_lm = match_descriptors(m.lm_desc, m.lm_valid, desc, fvalid, ratio=ratio).index
        use = idx_lm >= 0
        X_t = m.X
        uv_t = torch.where(use[:, None], uv_new[idx_lm.clamp_min(0)], 0.0)
        obs_pre = _inherit(N, use, idx_lm, torch.arange(Lmax, device=yx.device))
    else:
        use = (idx >= 0) & has_lm
        X_t = torch.where(has_lm[:, None], m.X[obs_last.clamp_min(0).long()], 0.0)
        uv_t = torch.where(use[:, None], uv_new[idx.clamp_min(0)], 0.0)
        obs_pre = _inherit(N, use, idx, obs_last)

    R, t, n = vo_core.pnp_dual_refine(
        X_t, uv_t, use, Rp, tp, m.kf_R[-1], m.kf_t[-1],
        iterations=track_iters, huber_delta=huber_delta,
        min_track=min_track, dual_init=dual_init,
    )

    if not local_map and float(rescue_radius) > 0.0:
        # projective rescue of associations the ratio test dropped, then a
        # short re-refine with the merged set
        idx = vo_core.guided_rescue(
            m.kf_desc, m.kf_fvalid[-1], X_t, has_lm, desc, fvalid, uv_new, idx, R, t,
            radius_norm=rescue_radius, min_sim=rescue_min_cos,
        )
        use = (idx >= 0) & has_lm
        uv_t = torch.where(use[:, None], uv_new[idx.clamp_min(0)], 0.0)
        obs_pre = _inherit(N, use, idx, obs_last)
        R, t, n = vo_core.pnp_dual_refine(
            X_t, uv_t, use, R, t, m.kf_R[-1], m.kf_t[-1],
            iterations=max(track_iters // 2, 4), huber_delta=huber_delta,
            min_track=min_track, dual_init=False,
        )

    n_valid = fvalid.sum()
    lost = n < 8
    # flow-driven promotion: the median displacement of the matched
    # keyframe features against VOConfig.kf_min_flow_norm (0 = off)
    if float(kf_min_flow) > 0.0:
        flow_kf = vo_core.median_flow(m.kf_uv[-1], m.kf_fvalid[-1], uv_new, idx) > kf_min_flow
    else:
        flow_kf = torch.zeros((), dtype=torch.bool, device=yx.device)
    promote = (~lost) & ((n < min_track) | force_kf | flow_kf) & (n_valid >= 16)
    if ground_prior:
        v_of = idx_lm if local_map else idx  # the mode's match table
        ground_h = vo_core.ground_height_obs(
            X_t, use, yx[v_of.clamp_min(0), 0], R, t, float(K.cy)
        )
    else:
        ground_h = torch.zeros((), dtype=R.dtype, device=R.device)
    return _TrackOut(
        uv_new=uv_new, idx=idx, obs_pre=obs_pre, R=R, t=t,
        n=n, n_valid=n_valid, lost=lost, promote=promote, ground_h=ground_h,
    )


def _sig_phase(m: DeviceMap, desc, fvalid, *, loop_min_gap, loop_cands):
    """The frame's signature and its closure candidates against the store:
    (sig_new [D], cand_idx [M], cand_score [M]). Runs every frame (a
    [Kcap, D] matvec and a top-k) so that T's fetch has one shape."""
    sig_new = vo_core.signature_device(desc, fvalid)
    cand_idx, cand_score = vo_core.closure_candidates(
        m.sig, sig_new, m.sig_n, min_gap=loop_min_gap, top=loop_cands
    )
    return sig_new, cand_idx, cand_score


def _ground_step(m: DeviceMap, ground_h, *, target):
    """The in-step ground controller after a promotion
    (vo_core.ground_controller): record the observation, and rescale the
    live landmarks and the live ring poses about the newest camera center
    by its ratio, a gauge-exact similarity. Returns (map, ratio)."""
    hist, r = vo_core.ground_controller(ground_h, ground_h > 0, m.ground_hist, target=target)
    c0 = -m.kf_R[-1].T @ m.kf_t[-1]
    X = torch.where(m.lm_valid[:, None], c0 + (m.X - c0) * r, m.X)
    C = -torch.einsum("wij,wi->wj", m.kf_R, m.kf_t)
    Cs = c0 + (C - c0) * r
    kf_t = torch.where(m.kf_live[:, None], -torch.einsum("wij,wj->wi", m.kf_R, Cs), m.kf_t)
    return m._replace(X=X, kf_t=kf_t, ground_hist=hist), r


class _IO(NamedTuple):
    """The steps' static input and output buffers (see DeviceVO)."""

    yx: torch.Tensor  # [N, 2] in: the frame's features
    desc: torch.Tensor  # [N, D]
    fvalid: torch.Tensor  # [N]
    pose: torch.Tensor  # [12] in: the PnP prediction, R (9) then t (3)
    uv_new: torch.Tensor  # [N, 2] T -> P
    idx: torch.Tensor  # [N] int64
    obs_pre: torch.Tensor  # [N] int32
    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    sig_new: torch.Tensor  # [D] T -> P: the frame's signature (loop closure)
    ground_h: torch.Tensor  # [] T -> P: the ground-height observation
    # [17 + 2 M] int32: R, t (float32 bits), n, n_valid, promote, lost,
    # ground_h (bits), cand_idx [M], cand_score [M] (bits); M = 0 without
    # loop closure
    t_out: torch.Tensor
    # [12 W + 2 N + 3] int32: kf_R, kf_t (bits), obs_new, obs_gen,
    # lm_count, ground_h, ground_r (bits)
    p_out: torch.Tensor


def _bits(a):
    return a.reshape(-1).view(torch.int32)


def _track_half(m: DeviceMap, io: _IO, *, kf_max_gap, loop_min_gap, loop_cands,
                **track) -> None:
    """T: the track phase on the frame in ``io``, the forced gap counted
    from ``since_kf``, and the signature phase when the store is carried;
    updates ``m.since_kf`` and T's outputs in ``io``."""
    if kf_max_gap:
        force = m.since_kf + 1 >= kf_max_gap
    else:
        force = torch.zeros((), dtype=torch.bool, device=m.X.device)
    tr = _track_phase(
        m, io.yx, io.desc, io.fvalid, io.pose[:9].view(3, 3), io.pose[9:], force, **track
    )
    m.since_kf.copy_(torch.where(tr.promote, 0, m.since_kf + 1))
    for dst, src in ((io.uv_new, tr.uv_new), (io.idx, tr.idx), (io.obs_pre, tr.obs_pre),
                     (io.R, tr.R), (io.t, tr.t)):
        dst.copy_(src)
    io.ground_h.copy_(tr.ground_h)
    flags = torch.stack([a.to(torch.int32) for a in (tr.n, tr.n_valid, tr.promote, tr.lost)])
    parts = [_bits(tr.R), _bits(tr.t), flags, _bits(tr.ground_h)]
    if m.sig is not None:
        sig_new, cand_idx, cand_score = _sig_phase(
            m, io.desc, io.fvalid, loop_min_gap=loop_min_gap, loop_cands=loop_cands
        )
        io.sig_new.copy_(sig_new)
        parts += [cand_idx.to(torch.int32), _bits(cand_score)]
    io.t_out.copy_(torch.cat(parts))


def _promote_half(m: DeviceMap, io: _IO, *, iterations, huber_delta, tri_angle,
                  ground_target) -> None:
    """P: the promotion of the frame in ``io`` with T's outputs, then the
    ground controller when the map carries one, written in place into
    ``m``'s buffers; the fetch row into ``io.p_out``."""
    m2 = _promote(
        m, io.uv_new, io.desc, io.fvalid, io.idx, io.obs_pre, io.R, io.t,
        io.sig_new if m.sig is not None else None,
        iterations=iterations, huber_delta=huber_delta, tri_angle=tri_angle,
    )
    if m.ground_hist is not None:
        m2, g_r = _ground_step(m2, io.ground_h, target=ground_target)
    else:
        g_r = torch.ones((), dtype=io.R.dtype, device=io.R.device)
    for dst, src in zip(m, m2):
        if dst is not None and src is not dst:
            dst.copy_(src)
    obs_new = m.kf_obs[-1]
    io.p_out.copy_(torch.cat([
        _bits(m.kf_R), _bits(m.kf_t), obs_new, m.lm_gen[obs_new.clamp_min(0).long()],
        m.lm_valid.sum(dtype=torch.int32)[None], _bits(io.ground_h), _bits(g_r),
    ]))


@contextlib.contextmanager
def _capture_math():
    """TF32 off (a graph keeps the math mode it was captured under) and
    cuSOLVER for the factorizations (MAGMA can synchronize the host)."""
    lib = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        with precise():
            yield
    finally:
        torch.backends.cuda.preferred_linalg_library(lib)


class DeviceVO:
    """Host wrapper around the device-resident VO step (one stream).

    Keeps a host :class:`~cvsteer_tpu_torch.slam.vo.VOState` mirror in sync
    from each frame's small fetch (poses, observation rows, occupancy), so
    relocalization and evaluation reuse the host engine; landmark positions
    are synced only at event cadence (:meth:`sync_host`). Two-view
    bootstrap runs on the host; once initialized the state uploads, the two
    step graphs are captured (on a CUDA device), and every later frame is
    T's replay and one fetch, plus P's replay and one more fetch on a
    keyframe.

    ``device="cuda"`` (the default) needs a CUDA device and raises without
    one; ``device="cpu"`` runs the same two halves eagerly.
    """

    def __init__(self, config: VOConfig = VOConfig(), device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceVO(device='cuda') needs a CUDA device; pass device='cpu' to run on the CPU"
            )
        self.device = device
        self.state: VOState = init_vo(config, device=device)
        self.map: Optional[DeviceMap] = None  # None while the host bootstraps
        self.captures = 0  # CUDA graphs captured (2 after the first upload)
        self._bufs: Optional[DeviceMap] = None  # the map's static buffers
        self._io: Optional[_IO] = None
        self._graphs = None
        self._host_dirty = False  # the device holds newer landmark positions
        # host mirror of the slot generations (zeros before the first upload)
        self._lm_gen = np.zeros(config.max_landmarks, np.int32)
        self.closures_accepted = 0
        self._closure_cooldown = 0  # promotions until the next closure event

    @property
    def initialized(self) -> bool:
        return self.state.initialized

    # ------------------------------------------------------------------
    # the step

    def _step_kwargs(self):
        cfg = self.state.config
        track = dict(
            kf_max_gap=cfg.kf_max_gap, K=cfg.intrinsics, ratio=cfg.match_ratio,
            track_iters=10, huber_delta=cfg.huber_delta, min_track=cfg.track_min_landmarks,
            # with the motion model both PnP starts always run: where the
            # prediction is the keyframe pose they are equal, so the pick is
            # the single refinement's
            dual_init=cfg.motion_model, local_map=cfg.track_local_map,
            rescue_radius=cfg.rescue_radius_norm, rescue_min_cos=cfg.rescue_min_cos,
            kf_min_flow=cfg.kf_min_flow_norm, ground_prior=cfg.ground_height_m > 0,
            loop_min_gap=cfg.loop_min_gap, loop_cands=cfg.loop_max_candidates,
        )
        promote = dict(
            iterations=cfg.ba_iterations, huber_delta=cfg.huber_delta,
            tri_angle=cfg.tri_min_ray_angle_deg, ground_target=float(cfg.ground_height_m),
        )
        return track, promote

    def _run_half(self, k: int, *, eager: bool = False) -> None:
        """Run half ``k`` (0 = T, 1 = P) on the static buffers: its graph's
        replay, or eagerly where there is no graph (or when asked)."""
        if self._graphs is not None and not eager:
            self._graphs[k].replay()
            return
        half = (_track_half, _promote_half)[k]
        with precise():
            half(self.map, self._io, **self._step_kwargs()[k])

    def _capture(self) -> None:
        """Capture T and P once, after a warm-up (library handles and
        workspaces) on a clone of the map and buffers, so the warm-up
        advances no real state. A capture that fails raises."""
        track, promote = self._step_kwargs()
        m_w = DeviceMap(*(None if a is None else a.clone() for a in self.map))
        io_w = _IO(*(a.clone() for a in self._io))
        feats = self.state.keyframes[-1].features
        io_w.yx.copy_(feats.yx)
        io_w.desc.copy_(feats.desc)
        io_w.fvalid.copy_(feats.valid)
        io_w.pose.copy_(torch.cat([m_w.kf_R[-1].reshape(9), m_w.kf_t[-1]]))
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with hostvo._span(self.state, "capture"):
            with torch.cuda.stream(side), _capture_math():
                for _ in range(2):
                    _track_half(m_w, io_w, **track)
                    _promote_half(m_w, io_w, **promote)
            main.wait_stream(side)
            graphs = []
            for half, kw in ((_track_half, track), (_promote_half, promote)):
                g = torch.cuda.CUDAGraph()
                with _capture_math(), torch.cuda.graph(g):
                    half(self.map, self._io, **kw)
                graphs.append(g)
                self.captures += 1
        self._graphs = tuple(graphs)

    def _fetch(self, src: torch.Tensor, host: torch.Tensor) -> np.ndarray:
        """One device-to-host copy of ``src`` into ``host`` (pinned on a
        card), waited for."""
        host.copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host.numpy()

    # ------------------------------------------------------------------
    # host <-> device state transfer (event cadence only)

    def _allocate(self, N: int, D: int) -> None:
        cfg = self.state.config
        W, Lmax = cfg.window, cfg.max_landmarks
        f32, i32, b = torch.float32, torch.int32, torch.bool

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        loop = cfg.loop_closure
        M = cfg.loop_max_candidates if loop else 0
        self._bufs = DeviceMap(
            X=z((Lmax, 3), f32), lm_valid=z(Lmax, b), lm_gen=z(Lmax, i32),
            kf_uv=z((W, N, 2), f32), kf_fvalid=z((W, N), b), kf_obs=z((W, N), i32),
            kf_R=z((W, 3, 3), f32), kf_t=z((W, 3), f32), kf_live=z(W, b),
            kf_desc=z((N, D), f32), lm_desc=z((Lmax, D), f32),
            sig=z((cfg.loop_sig_capacity, D), f32) if loop else None,
            sig_n=z((), i32) if loop else None, since_kf=z((), i32),
            ground_hist=z(3, f32) if cfg.ground_height_m > 0 else None,
        )
        n_t, n_p = 17 + 2 * M, 12 * W + 2 * N + 3
        self._io = _IO(
            yx=z((N, 2), f32), desc=z((N, D), f32), fvalid=z(N, b), pose=z(12, f32),
            uv_new=z((N, 2), f32), idx=z(N, torch.int64), obs_pre=z(N, i32),
            R=z((3, 3), f32), t=z(3, f32), sig_new=z(D, f32), ground_h=z((), f32),
            t_out=z(n_t, i32), p_out=z(n_p, i32),
        )
        pin = self.device.type == "cuda"
        self._t_host = torch.zeros(n_t, dtype=i32, pin_memory=pin)
        self._p_host = torch.zeros(n_p, dtype=i32, pin_memory=pin)
        self._pose_host = torch.zeros(12, dtype=f32, pin_memory=pin)

    def _upload(self) -> None:
        """Write the host mirror into the map's static buffers (allocated
        at the first upload; later uploads never rebind them) and capture
        the step graphs the first time."""
        st = self.state
        cfg = st.config
        W = cfg.window
        kf_last = st.keyframes[-1]
        N, D = (int(s) for s in kf_last.features.desc.shape)
        live = st.keyframes[-min(len(st.keyframes), W):]
        uv = np.zeros((W, N, 2), np.float32)
        fv = np.zeros((W, N), bool)
        obs = np.full((W, N), -1, np.int32)
        Rw = np.broadcast_to(np.eye(3, dtype=np.float32), (W, 3, 3)).copy()
        tw = np.zeros((W, 3), np.float32)
        lv = np.zeros((W,), bool)
        lm_desc = np.zeros((cfg.max_landmarks, D), np.float32)
        for w, kf in zip(range(W - len(live), W), live):
            x, v = hostvo._kf_host_cache(st, kf)
            uv[w], fv[w] = x, v
            obs[w] = kf.landmark_ids.astype(np.int32)
            Rw[w], tw[w] = kf.R, kf.t
            lv[w] = True
            # landmark descriptor store: the newest window observation wins
            # (iteration runs oldest -> newest)
            ids = kf.landmark_ids
            sel = ids >= 0
            if sel.any():
                lm_desc[ids[sel]] = hostvo._host(kf.features.desc)[sel]
        # host-path keyframes (bootstrap, relocalization) carry no stamps
        # yet; their ids are live right now, so the mirror's generations
        # are the right stamps
        for kf in st.keyframes:
            if kf.landmark_gens is None:
                ids = kf.landmark_ids
                kf.landmark_gens = np.where(
                    ids >= 0, self._lm_gen[np.maximum(ids, 0)], 0
                ).astype(np.int32)
        if self._bufs is None:
            self._allocate(N, D)
        elif self._bufs.kf_desc.shape != (N, D):
            raise ValueError(
                f"features of shape {(N, D)} after the map was built for "
                f"{tuple(self._bufs.kf_desc.shape)}: the device map's shapes are fixed"
            )
        m = self._bufs
        host = dict(
            X=st.landmarks, lm_valid=st.landmark_valid, lm_gen=self._lm_gen, kf_uv=uv,
            kf_fvalid=fv, kf_obs=obs, kf_R=Rw, kf_t=tw, kf_live=lv, lm_desc=lm_desc,
            since_kf=np.asarray(max(st.frame_count - 1 - kf_last.index, 0), np.int32),
        )
        if m.sig is not None:
            # every keyframe's signature (cached on the keyframe), up to the
            # store's capacity
            sig = np.zeros(tuple(m.sig.shape), np.float32)
            for k, kf in enumerate(st.keyframes[: sig.shape[0]]):
                if kf.signature is None:
                    kf.signature = hostvo.keyframe_signature(kf.features)
                sig[k] = kf.signature
            host.update(sig=sig, sig_n=np.asarray(len(st.keyframes), np.int32))
        if m.ground_hist is not None:
            host["ground_hist"] = np.asarray((list(st.ground_hist[-3:]) + [0.0] * 3)[:3], np.float32)
        for name, a in host.items():
            getattr(m, name).copy_(torch.as_tensor(a))
        m.kf_desc.copy_(kf_last.features.desc)  # a copy: the keyframe keeps its own
        self.map = m
        self._host_dirty = False
        if self.device.type == "cuda" and self._graphs is None:
            self._capture()

    def sync_host(self) -> VOState:
        """Pull the device state into the host mirror (event cadence):
        landmark positions, occupancy and generations, the window's refined
        poses and post-culling observation tables, and, by the generation
        stamps, the invalidation of any out-of-window keyframe observation
        whose slot was culled (and maybe reused) since it left the ring."""
        if self.map is not None and self._host_dirty:
            m = self.map
            X, lm_valid, lm_gen, kf_R, kf_t, kf_obs = (
                hostvo._host(a) for a in (m.X, m.lm_valid, m.lm_gen, m.kf_R, m.kf_t, m.kf_obs)
            )
            self.state.landmarks[:] = X
            self.state.landmark_valid[:] = lm_valid
            self.state.num_landmarks = int(lm_valid.sum())
            self._lm_gen = lm_gen
            for kf in self.state.keyframes:
                ids = kf.landmark_ids
                live = ids >= 0
                if not live.any():
                    continue
                ids0 = np.maximum(ids, 0)
                stale = live & ~lm_valid[ids0]
                if kf.landmark_gens is not None:
                    stale |= live & (lm_gen[ids0] != kf.landmark_gens)
                if stale.any():
                    kf.landmark_ids = np.where(stale, -1, ids)
                    kf.track_cache = None
            self._mirror_window(kf_R, kf_t, kf_obs)
            self._host_dirty = False
        return self.state

    def _mirror_window(self, kf_R, kf_t, kf_obs=None) -> None:
        st = self.state
        W = st.config.window
        live = st.keyframes[-min(len(st.keyframes), W):]
        for w, kf in zip(range(W - len(live), W), live):
            kf.R, kf.t = kf_R[w].copy(), kf_t[w].copy()
            if kf_obs is not None:
                ids = kf_obs[w].astype(np.int64)
                kf.landmark_ids = ids
                # ring tables are authoritative (culls already cleared):
                # restamp with the current generations
                kf.landmark_gens = np.where(
                    ids >= 0, self._lm_gen[np.maximum(ids, 0)], 0
                ).astype(np.int32)
            kf.track_cache = None  # poses/ids moved
        st.track_version += 1

    # ------------------------------------------------------------------

    def process_frame(self, feats: Features) -> None:
        if self.map is None:
            st = self.state
            hostvo.process_frame(st, feats)
            if st.initialized:
                self._upload()
            return
        self.complete(feats, self.issue(feats))

    def issue(self, feats: Features) -> StepOut:
        """Run the step on ``feats`` and fetch it: T's replay and one fetch;
        on a promotion P's replay and one more. (The reference's issue only
        dispatches; here the host reads T's flag to decide on P.) Requires
        an initialized engine (``self.map is not None``)."""
        st = self.state
        cfg = st.config
        kf = st.keyframes[-1]
        Rp, tp = hostvo._predict_pose(st) if cfg.motion_model else (kf.R, kf.t)
        io = self._io
        with hostvo._span(st, "track"):
            io.yx.copy_(feats.yx)
            io.desc.copy_(feats.desc)
            io.fvalid.copy_(feats.valid)
            pose = self._pose_host.numpy()
            pose[:9], pose[9:] = np.reshape(Rp, 9), tp
            io.pose.copy_(self._pose_host, non_blocking=True)
            self._run_half(0)
            h = self._fetch(io.t_out, self._t_host)
            M = (h.shape[0] - 17) // 2
            out = StepOut(
                R=h[:9].view(np.float32).reshape(3, 3).copy(), t=h[9:12].view(np.float32).copy(),
                n_tracked=int(h[12]), n_valid=int(h[13]), promoted=bool(h[14]), lost=bool(h[15]),
                ground_h=float(h[16:17].view(np.float32)[0]),
                cand_idx=h[17:17 + M].copy() if M else None,
                cand_score=h[17 + M:].view(np.float32).copy() if M else None,
            )
        self._host_dirty = True
        if not out.promoted:
            return out
        W = cfg.window
        N = io.idx.shape[0]
        with hostvo._span(st, "keyframe"):
            self._run_half(1)
            h = self._fetch(io.p_out, self._p_host)
            return out._replace(
                kf_R=h[: 9 * W].view(np.float32).reshape(W, 3, 3).copy(),
                kf_t=h[9 * W: 12 * W].view(np.float32).reshape(W, 3).copy(),
                obs_new=h[12 * W: 12 * W + N].copy(),
                obs_gen=h[12 * W + N: 12 * W + 2 * N].copy(),
                lm_count=int(h[-3]),
                ground_r=(
                    float(h[-1:].view(np.float32)[0]) if cfg.ground_height_m > 0 else None
                ),
            )

    def complete(self, feats: Features, fetched: StepOut) -> None:
        """Host-mirror tail of the step from a fetched result."""
        st = self.state
        cfg = st.config
        if fetched.lost or not (np.isfinite(fetched.R).all() and np.isfinite(fetched.t).all()):
            self._handle_lost(feats)
            return
        hostvo._append_traj(st, fetched.R, fetched.t)

        if fetched.promoted:
            kf_R, kf_t = fetched.kf_R, fetched.kf_t
            st.num_landmarks = fetched.lm_count
            obs_new = fetched.obs_new.astype(np.int64)
            obs_gen = np.where(obs_new >= 0, fetched.obs_gen, 0).astype(np.int32)
            # fresh triangulations of this promotion: (id, gen) pairs of
            # obs_new absent from every window keyframe's host mirror (valid
            # here, before a sync refreshes the previous keyframe's table)
            sel = obs_new >= 0
            key_new = obs_new[sel] << 32 | obs_gen[sel].astype(np.int64)
            seen = [np.empty(0, np.int64)]
            for kf in st.keyframes[-(cfg.window - 1):]:
                ids = kf.landmark_ids
                ksel = ids >= 0
                gens = (
                    kf.landmark_gens if kf.landmark_gens is not None
                    else np.zeros(ids.shape[0], np.int32)
                )
                seen.append(ids[ksel] << 32 | gens[ksel].astype(np.int64))
            fresh = obs_new[sel][~np.isin(key_new, np.concatenate(seen))]
            st.keyframes.append(
                Keyframe(
                    st.frame_count, feats, kf_R[-1].copy(), kf_t[-1].copy(), obs_new,
                    landmark_gens=obs_gen, fresh_ids=fresh,
                )
            )
            # poses refresh every promotion; the older window keyframes'
            # observation tables refresh lazily at the next sync_host
            self._mirror_window(kf_R, kf_t)
            st.trajectory[-1] = (st.frame_count, kf_R[-1].copy(), kf_t[-1].copy())
            st.traj_ref[-1] = None  # keyframe entry: anchored to itself
            if fetched.ground_r is not None:
                # P's controller already corrected the device state: mirror
                # the bookkeeping (the ring poses came home corrected)
                if fetched.ground_h > 0:
                    hostvo.smoothed_ground(st, fetched.ground_h)
                if abs(fetched.ground_r - 1.0) > 1e-9:
                    st.track_version += 1
                    hostvo._diag(st, ev="ground", h=fetched.ground_h, r=fetched.ground_r)
            self._speed_prior()  # record only when the band is off
            if st.diag is not None and len(st.keyframes) >= 2:
                kf, prev = st.keyframes[-1], st.keyframes[-2]
                hostvo._diag(
                    st, ev="kf", n_kf=len(st.keyframes),
                    b=float(np.linalg.norm(-kf.R.T @ kf.t + prev.R.T @ prev.t)),
                    gap=int(kf.index - prev.index), n_tracked=fetched.n_tracked,
                    reason="track" if fetched.n_tracked < cfg.track_min_landmarks else "gap",
                )
            if cfg.loop_closure:
                self._closure_event(fetched)
        st.frame_count += 1

    def _closure_event(self, fetched: StepOut) -> None:
        """After a promotion: the store-capacity warning, the cooldown, then
        the gate on T's candidates (loopclosure.closure_gate, no device
        work) and, when it passes, the closure event."""
        from cvsteer_tpu_torch.slam.loopclosure import closure_gate

        st = self.state
        cfg = st.config
        if len(st.keyframes) == cfg.loop_sig_capacity + 1:
            warnings.warn(
                f"device signature store full: keyframe {len(st.keyframes)} > "
                f"loop_sig_capacity {cfg.loop_sig_capacity}; later keyframes are not "
                "indexed for closure detection. Raise VOConfig.loop_sig_capacity.",
                RuntimeWarning,
                stacklevel=3,
            )
        cand = (fetched.cand_idx, fetched.cand_score)
        if self._closure_cooldown > 0:
            self._closure_cooldown -= 1
        elif closure_gate(st, *cand, min_gap=cfg.loop_min_gap,
                          threshold=cfg.loop_signature_threshold):
            self._closure(cand)

    def _closure(self, candidates=None) -> None:
        """A closure event: sync the device state down, run close_loops (or
        close_loops_sim3) on this engine's device, and write the corrected
        poses and landmarks back into the captured buffers."""
        from cvsteer_tpu_torch.slam.loopclosure import close_loops, close_loops_sim3

        t0 = time.perf_counter()
        st = self.sync_host()
        t_sync = time.perf_counter()
        cfg = st.config
        closer = close_loops_sim3 if cfg.loop_closure_sim3 else close_loops
        n = closer(
            st, min_gap=cfg.loop_min_gap, min_inliers=cfg.loop_min_inliers,
            huber_delta=cfg.loop_robust_delta, candidates=candidates,
            signature_threshold=cfg.loop_signature_threshold,
        )
        if n:
            self.closures_accepted += n
            self._closure_cooldown = cfg.loop_cooldown
        elif cfg.loop_reject_cooldown:
            # engine-wide breather after a rejected event
            self._closure_cooldown = max(self._closure_cooldown, cfg.loop_reject_cooldown // 3)
        hostvo._diag(
            st, ev="closure", accepted=int(n), K=len(st.keyframes),
            sync_ms=round((t_sync - t0) * 1e3, 2),
            solve_ms=round((time.perf_counter() - t_sync) * 1e3, 2),
        )
        if not n:
            return  # rejected: nothing changed
        st.track_version += 1
        kf = st.keyframes[-1]
        st.trajectory[-1] = (st.frame_count, kf.R.copy(), kf.t.copy())
        self._upload_poses_landmarks()

    def _upload_poses_landmarks(self) -> None:
        """Write back what a closure moved: landmark positions and occupancy
        and the ring poses, by ``copy_`` into the captured buffers (never
        rebinding them); descriptors, signatures, observation tables and
        generations are untouched by a closure. The ring's membership has
        not changed since the preceding sync."""
        st = self.state
        m = self.map
        W = int(m.kf_R.shape[0])
        live = st.keyframes[-min(len(st.keyframes), W):]
        Rw = np.broadcast_to(np.eye(3, dtype=np.float32), (W, 3, 3)).copy()
        tw = np.zeros((W, 3), np.float32)
        for w, kf in zip(range(W - len(live), W), live):
            Rw[w], tw[w] = kf.R, kf.t
        for dst, a in ((m.X, st.landmarks), (m.lm_valid, st.landmark_valid),
                       (m.kf_R, Rw), (m.kf_t, tw)):
            dst.copy_(torch.as_tensor(a))
        self._host_dirty = False

    def _speed_prior(self) -> None:
        """The kinematic clamp of the newest keyframe's baseline
        (vo.apply_speed_prior): the check runs on the host pose mirrors;
        only a violation pays a sync, the host correction of the pose and
        this promotion's fresh landmarks, and an upload into the buffers."""
        st = self.state
        cfg = st.config
        if len(st.keyframes) < 2:
            return
        kf, prev = st.keyframes[-1], st.keyframes[-2]
        gap = max(kf.index - prev.index, 1)
        b = float(np.linalg.norm(-kf.R.T @ kf.t + prev.R.T @ prev.t))
        med = hostvo.median_speed(st)
        lo, hi = cfg.speed_prior_band
        if cfg.ground_height_m > 0:
            hi = 0.0  # the absolute ground reference wins (vo.apply_speed_prior)
        if hi > 0 and med is not None and not (lo * med * gap <= b <= hi * med * gap):
            self.sync_host()
            hostvo.apply_speed_prior(st, fresh_ids=hostvo._fresh_ids_of_last_kf(st))
            self._upload()
            return
        hostvo.apply_speed_prior(st)  # in band: record the speed only

    def _handle_lost(self, feats: Features) -> None:
        """Tracking loss: sync down, run the host relocalize/track path for
        this frame, upload the (maybe corrected) state back. When the host
        path re-bootstrapped (persistent loss, vo.REBOOT_AFTER_LOST), the
        engine drops to the host bootstrap (map None) until the fresh
        two-view init completes, then uploads into the same buffers."""
        st = self.sync_host()
        res = hostvo._track(st, feats)
        hostvo._post_track(st, feats, *res)
        if not st.initialized:
            self.map = None
            return
        self._upload()

    def process_image(self, image) -> None:
        """Extract features from ``image [H, W]`` (numpy or tensor, 0..255
        scale) on the engine's device, then step."""
        self.process_frame(hostvo.image_features(self.state, image))

    def adopt(self, state: VOState) -> None:
        """Take over a host VOState (e.g. a restored one) as the mirror;
        uploads it if it is past bootstrap. Generation history does not
        survive: every surviving id is live at adoption, so stamps restart
        from zero."""
        self.state = state
        self.map = None
        self._host_dirty = False
        self._lm_gen = np.zeros(state.config.max_landmarks, np.int32)
        for kf in state.keyframes:
            kf.landmark_gens = None  # restamped by _upload
        if state.initialized and state.keyframes:
            self._upload()

    def finalize(self) -> VOState:
        """Sync, then propagate the final keyframe refinements into the
        trajectory."""
        return hostvo.finalize(self.sync_host())

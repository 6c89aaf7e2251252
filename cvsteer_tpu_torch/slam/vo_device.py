"""Device-resident monocular VO: the whole map on the device, each frame two
captured CUDA graphs (twin of cvsteer_tpu.slam.vo_device), and its serving
fleets: DeviceVOServer (one DeviceVO per stream) and DeviceVOFleet (every
stream's map stacked, two graphs for all streams a tick).

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

The fleet stacks S maps into one ``[S, ...]`` DeviceMap of static buffers
and runs the same phases over the stream axis (``torch.func.vmap``), as
two graphs captured once: **FT**, every stream's T and signature phases,
and **FP**, the promotion of the streams that ask for one (all S masked,
or compacted to ``promote_cap`` streams). Its engines capture nothing;
they run the event paths above on their own buffers, into which the
fleet copies a stream's row and from which it copies it back. A fleet row
has no in-step ground controller: it takes the host ground path
(:meth:`DeviceVO._ground_prior`), as in the reference.

Chunked stepping (:meth:`DeviceVO.issue_chunk`, :meth:`DeviceVO.
complete_chunk`) runs N frames in one replay of a third graph, **C**, and
one fetch. The reference's chunk is a ``lax.scan`` of its step, with a
``lax.cond`` around each frame's promotion. C unrolls the N frames: each
is T, then P with every write masked by T's promotion flag (the fleet's
masked promotion at S = 1), so P's device time is paid on every frame.
Each frame's PnP starts from the ring's newest pose, which is the
sequential engine's start with the motion model off. A frame that loses
tracking, and every frame after it, leaves the map as it was (the host
stops there and steps those frames one at a time); with the speed clamp
on (``speed_prior_band`` hi > 0, no ground prior) so does every frame
after the chunk's first promotion, whose host event may rewrite the map
before the next frame may read it. Closure events found
inside the chunk run at its end (``_defer_closure``,
``_pending_closure``).
"""
from __future__ import annotations

import contextlib
import functools
import time
import warnings
from typing import NamedTuple, Optional, Tuple

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
from cvsteer_tpu_torch.utils.profiling import annotate


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
    slots = slots.index_put(
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
    return win.scatter_reduce(-1, tgt, pos, "amax")[..., :n_cols]


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
    comp = comp.index_put((torch.where(uniq, rank, L_cap).long(),), sorted_slots)[:L_cap]
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
    culled = culled.index_put((torch.where(bad, comp, Lmax).long(),), bad)[:Lmax]

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
    window_live = torch.zeros(Lmax + 1, dtype=torch.bool, device=dev).index_put(
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
    return out.index_put(
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
    return _ground_rescale(m, r, c0)._replace(ground_hist=hist), r


def _ground_rescale(m: DeviceMap, r, c0) -> DeviceMap:
    """A gauge-exact similarity about the point ``c0``: the live landmarks
    and the live ring keyframes' camera centers scale by ``r`` (rotations
    unchanged), so every reprojection residual is invariant and the window
    BA cannot revert it (slam.vo.apply_ground_prior is the host twin).
    Padding ring rows and free landmark slots stay."""
    X = torch.where(m.lm_valid[:, None], c0 + (m.X - c0) * r, m.X)
    C = -torch.einsum("wij,wi->wj", m.kf_R, m.kf_t)
    Cs = c0 + (C - c0) * r
    kf_t = torch.where(m.kf_live[:, None], -torch.einsum("wij,wj->wi", m.kf_R, Cs), m.kf_t)
    return m._replace(X=X, kf_t=kf_t)


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
                  ground_target, when=None) -> None:
    """P: the promotion of the frame in ``io`` with T's outputs, then the
    ground controller when the map carries one, written in place into
    ``m``'s buffers; the fetch row into ``io.p_out``. ``when`` (a 0-dim
    bool tensor): keep the writes to the map only where it is true (C's
    masked P; the fetch row is then read only where it is true)."""
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
            dst.copy_(src if when is None else torch.where(when, src, dst))
    obs_new = m.kf_obs[-1]
    io.p_out.copy_(torch.cat([
        _bits(m.kf_R), _bits(m.kf_t), obs_new, m.lm_gen[obs_new.clamp_min(0).long()],
        m.lm_valid.sum(dtype=torch.int32)[None], _bits(io.ground_h), _bits(g_r),
    ]))


class _ChunkIO(NamedTuple):
    """C's static buffers for a chunk of n frames (n leads every shape)."""

    yx: torch.Tensor  # [n, N, 2] in
    desc: torch.Tensor  # [n, N, D]
    fvalid: torch.Tensor  # [n, N]
    t_out: torch.Tensor  # [n, 17 + 2 M] int32: each frame's T row
    p_out: torch.Tensor  # [n, 12 W + 2 N + 3] int32: each frame's P row (read where promoted)


def _chunk_half(m: DeviceMap, io: _IO, ch: _ChunkIO, *, track, promote,
                stop_at_keyframe: bool = False) -> None:
    """C: the chunk's frames one after the other, each T then P masked by
    T's promotion flag, the PnP start the ring's newest pose. From the
    first frame that loses tracking (the lost flag, or a pose that is not
    finite: the host's test) on, a frame changes nothing in the map: its
    ``since_kf`` count is put back and its P is masked out. With
    ``stop_at_keyframe`` the frames after the first promotion change
    nothing either (the speed clamp's host event may rewrite that
    promotion before the next frame may use it)."""
    alive = torch.ones((), dtype=torch.bool, device=m.X.device)
    for i in range(ch.yx.shape[0]):
        f = io._replace(yx=ch.yx[i], desc=ch.desc[i], fvalid=ch.fvalid[i], t_out=ch.t_out[i],
                        p_out=ch.p_out[i])
        f.pose.copy_(torch.cat([m.kf_R[-1].reshape(9), m.kf_t[-1]]))
        since = m.since_kf.clone()
        _track_half(m, f, **track)
        ok = ~f.t_out[15].to(torch.bool) & torch.isfinite(f.R).all() & torch.isfinite(f.t).all()
        alive = alive & ok
        m.since_kf.copy_(torch.where(alive, m.since_kf, since))
        promoted = alive & f.t_out[14].to(torch.bool)
        _promote_half(m, f, **promote, when=promoted)
        if stop_at_keyframe:
            alive = alive & ~promoted


def _track_row(h) -> StepOut:
    """A fetched T row (``_IO.t_out``'s layout) as a StepOut."""
    M = (h.shape[0] - 17) // 2
    return StepOut(
        R=h[:9].view(np.float32).reshape(3, 3).copy(), t=h[9:12].view(np.float32).copy(),
        n_tracked=int(h[12]), n_valid=int(h[13]), promoted=bool(h[14]), lost=bool(h[15]),
        ground_h=float(h[16:17].view(np.float32)[0]),
        cand_idx=h[17:17 + M].copy() if M else None,
        cand_score=h[17 + M:].view(np.float32).copy() if M else None,
    )


def _promote_row(out: StepOut, h, W: int, N: int) -> StepOut:
    """``out`` with a fetched P row's ring poses, new observation row, its
    stamps and the landmark count (``_IO.p_out``'s and ``_FleetIO.p_out``'s
    common head)."""
    return out._replace(
        kf_R=h[: 9 * W].view(np.float32).reshape(W, 3, 3).copy(),
        kf_t=h[9 * W: 12 * W].view(np.float32).reshape(W, 3).copy(),
        obs_new=h[12 * W: 12 * W + N].copy(), obs_gen=h[12 * W + N: 12 * W + 2 * N].copy(),
        lm_count=int(h[12 * W + 2 * N]),
    )


def _speed_clamp_on(cfg: VOConfig) -> bool:
    """The kinematic band can correct a promotion on the host
    (vo.apply_speed_prior): hi > 0 and no ground prior, which wins."""
    return cfg.speed_prior_band[1] > 0 and cfg.ground_height_m <= 0


def _step_kwargs(cfg: VOConfig):
    """The static keyword arguments of the two halves: (T's, P's)."""
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


@functools.lru_cache(maxsize=None)
def _warm_stream(device) -> "torch.cuda.Stream":
    """The one side stream of every warm-up on ``device``: cuBLAS keeps a
    workspace (32 MiB on Hopper) for each stream it has run on, so a new
    stream per engine would leave one behind per engine."""
    return torch.cuda.Stream(device)


def _capture_graphs(device, warm, halves) -> tuple:
    """Run ``warm()`` twice on a side stream (library handles and
    workspaces; it must advance no real state), then capture each of
    ``halves`` (callables on the static buffers) as one CUDA graph, in
    order. A capture that fails raises."""
    main = torch.cuda.current_stream(device)
    side = _warm_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side), _capture_math():
        for _ in range(2):
            warm()
    main.wait_stream(side)
    graphs = []
    for half in halves:
        g = torch.cuda.CUDAGraph()
        with _capture_math(), torch.cuda.graph(g):
            half()
        graphs.append(g)
    return tuple(graphs)


def _step_math(device):
    """The math mode of an eager half: the captured graphs' on a card (so
    that an eager run takes the same factorization routines), TF32 off
    elsewhere."""
    return _capture_math() if device.type == "cuda" else precise()


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
    one; ``device="cpu"`` runs the same two halves eagerly. ``capture=False``
    is for an engine a :class:`DeviceVOFleet` owns: the fleet steps its map
    in the fleet's own graphs, and the engine runs only its event paths
    (bootstrap, relocalization, closure, the speed clamp, the ground
    prior), eagerly on its own buffers, so it captures nothing.
    """

    def __init__(self, config: VOConfig = VOConfig(), device="cuda", capture: bool = True):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceVO(device='cuda') needs a CUDA device; pass device='cpu' to run on the CPU"
            )
        self.device = device
        self.state: VOState = init_vo(config, device=device)
        self.map: Optional[DeviceMap] = None  # None while the host bootstraps
        self.capture = capture
        self.captures = 0  # CUDA graphs captured (2 after the first upload)
        self._bufs: Optional[DeviceMap] = None  # the map's static buffers
        self._io: Optional[_IO] = None
        self._graphs = None
        self._host_dirty = False  # the device holds newer landmark positions
        # host mirror of the slot generations (zeros before the first upload)
        self._lm_gen = np.zeros(config.max_landmarks, np.int32)
        self.closures_accepted = 0
        self._closure_cooldown = 0  # promotions until the next closure event
        # chunks (complete_chunk) run closure events at their end
        self._defer_closure = False
        self._pending_closure = None
        self._chunks = {}  # chunk length -> (_ChunkIO, C's graph or None, host rows)

    @property
    def initialized(self) -> bool:
        return self.state.initialized

    # ------------------------------------------------------------------
    # the step

    def _run_half(self, k: int, *, eager: bool = False) -> None:
        """Run half ``k`` (0 = T, 1 = P) on the static buffers: its graph's
        replay, or eagerly where there is no graph (or when asked)."""
        if self._graphs is not None and not eager:
            self._graphs[k].replay()
            return
        half = (_track_half, _promote_half)[k]
        with _step_math(self.device):
            half(self.map, self._io, **_step_kwargs(self.state.config)[k])

    def _capture(self) -> None:
        """Capture T and P once, after a warm-up (library handles and
        workspaces) on a clone of the map and buffers, so the warm-up
        advances no real state. A capture that fails raises."""
        track, promote = _step_kwargs(self.state.config)
        m_w = DeviceMap(*(None if a is None else a.clone() for a in self.map))
        io_w = _IO(*(a.clone() for a in self._io))
        feats = self.state.keyframes[-1].features
        io_w.yx.copy_(feats.yx)
        io_w.desc.copy_(feats.desc)
        io_w.fvalid.copy_(feats.valid)
        io_w.pose.copy_(torch.cat([m_w.kf_R[-1].reshape(9), m_w.kf_t[-1]]))

        def warm():
            _track_half(m_w, io_w, **track)
            _promote_half(m_w, io_w, **promote)

        with hostvo._span(self.state, "capture"):
            self._graphs = _capture_graphs(self.device, warm, (
                lambda: _track_half(self.map, self._io, **track),
                lambda: _promote_half(self.map, self._io, **promote),
            ))
        self.captures += len(self._graphs)

    def _start_fetch(self, src: torch.Tensor, host: torch.Tensor) -> None:
        """Start one device-to-host copy of ``src`` into ``host`` (pinned on
        a card); :meth:`_wait_fetch` waits for it."""
        host.copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            self._fetched.record()

    def _wait_fetch(self, host: torch.Tensor) -> np.ndarray:
        if self.device.type == "cuda":
            self._fetched.synchronize()
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
        self._fetched = torch.cuda.Event() if pin else None
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
        if self.device.type == "cuda" and self.capture and self._graphs is None:
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
        launches; here the host reads T's flag to decide on P.) Requires
        an initialized engine (``self.map is not None``)."""
        st = self.state
        with hostvo._span(st, "track"):
            self.dispatch_track(feats)
            out = self.fetch_track()
        if not out.promoted:
            return out
        with hostvo._span(st, "keyframe"):
            self.dispatch_promote()
            return self.fetch_promote(out)

    def dispatch_track(self, feats: Features) -> None:
        """T's half of :meth:`issue` without the wait: write ``feats`` and
        the PnP prediction into the input buffers, replay T and start
        fetching its output; :meth:`fetch_track` waits for it. A server
        launches every stream's T before one wait (DeviceVOServer)."""
        st = self.state
        kf = st.keyframes[-1]
        Rp, tp = hostvo._predict_pose(st) if st.config.motion_model else (kf.R, kf.t)
        io = self._io
        io.yx.copy_(feats.yx)
        io.desc.copy_(feats.desc)
        io.fvalid.copy_(feats.valid)
        pose = self._pose_host.numpy()
        pose[:9], pose[9:] = np.reshape(Rp, 9), tp
        io.pose.copy_(self._pose_host, non_blocking=True)
        self._run_half(0)
        self._start_fetch(io.t_out, self._t_host)
        self._host_dirty = True

    def fetch_track(self) -> StepOut:
        """T's fetched output (waits for :meth:`dispatch_track`'s copy)."""
        return _track_row(self._wait_fetch(self._t_host))

    def dispatch_promote(self) -> None:
        """P's replay on T's outputs and the start of its fetch."""
        self._run_half(1)
        self._start_fetch(self._io.p_out, self._p_host)

    def fetch_promote(self, out: StepOut) -> StepOut:
        """``out`` with P's fetched results (waits for the copy)."""
        return self._promoted(out, self._wait_fetch(self._p_host))

    def _promoted(self, out: StepOut, h) -> StepOut:
        """``out`` with a fetched P row ``h`` (``_IO.p_out``'s layout)."""
        cfg = self.state.config
        return _promote_row(out, h, cfg.window, self._io.idx.shape[0])._replace(
            ground_r=float(h[-1:].view(np.float32)[0]) if cfg.ground_height_m > 0 else None,
        )

    # ------------------------------------------------------------------
    # chunked stepping

    def _chunk(self, n: int, N: int, D: int):
        """C's buffers and host rows for chunks of ``n`` frames, made (and
        on a card C captured, after a warm-up on clones) at the first chunk
        of that length."""
        if n in self._chunks:
            return self._chunks[n]
        dev, io = self.device, self._io
        i32, pin = torch.int32, dev.type == "cuda"
        ch = _ChunkIO(
            yx=torch.zeros((n, N, 2), device=dev), desc=torch.zeros((n, N, D), device=dev),
            fvalid=torch.zeros((n, N), dtype=torch.bool, device=dev),
            t_out=torch.zeros((n,) + tuple(io.t_out.shape), dtype=i32, device=dev),
            p_out=torch.zeros((n,) + tuple(io.p_out.shape), dtype=i32, device=dev),
        )
        hosts = (torch.zeros(tuple(ch.t_out.shape), dtype=i32, pin_memory=pin),
                 torch.zeros(tuple(ch.p_out.shape), dtype=i32, pin_memory=pin))
        graph = None
        if pin and self.capture:
            track, promote = _step_kwargs(self.state.config)
            stop = _speed_clamp_on(self.state.config)
            m_w = DeviceMap(*(None if a is None else a.clone() for a in self.map))
            io_w = _IO(*(a.clone() for a in io))
            ch_w = _ChunkIO(*(a.clone() for a in ch))
            for dst, f in zip(ch_w[:3], (self.state.keyframes[-1].features.yx,
                                          self.state.keyframes[-1].features.desc,
                                          self.state.keyframes[-1].features.valid)):
                dst.copy_(f.expand_as(dst))
            with hostvo._span(self.state, "capture"):
                (graph,) = _capture_graphs(
                    dev, lambda: _chunk_half(m_w, io_w, ch_w, track=track, promote=promote,
                                             stop_at_keyframe=stop),
                    (lambda: _chunk_half(self.map, io, ch, track=track, promote=promote,
                                         stop_at_keyframe=stop),),
                )
            self.captures += 1
        self._chunks[n] = (ch, graph, hosts)
        return self._chunks[n]

    def issue_chunk(self, yx, desc, fvalid) -> list:
        """Step ``n`` frames at once: ``yx [n, N, 2]``, ``desc [n, N, D]``,
        ``fvalid [n, N]`` (a leading chunk axis, on the engine's device),
        in one replay of graph C (eagerly on the CPU) and one fetch; returns
        the n frames' fetched StepOut rows for :meth:`complete_chunk`.

        The map advances at once; each frame's PnP starts from the ring's
        newest pose, so the chunk is the sequential engine step for step
        with the motion model off, which it requires. Needs an initialized
        engine (``self.map`` not None). C is captured once per chunk length
        (:attr:`captures`)."""
        st = self.state
        cfg = st.config
        if cfg.motion_model:
            raise ValueError("chunked stepping needs motion_model off: the chunk cannot read "
                             "the host trajectory a prediction needs")
        if self.map is None:
            raise ValueError("issue_chunk needs an initialized engine: bootstrap through "
                             "process_frame")
        n = int(yx.shape[0])
        ch, graph, (t_host, p_host) = self._chunk(n, *self._bufs.kf_desc.shape)
        for dst, src in zip(ch[:3], (yx, desc, fvalid)):
            dst.copy_(src)
        with hostvo._span(st, "chunk"):
            if graph is not None:
                graph.replay()
            else:
                track, promote = _step_kwargs(cfg)
                with _step_math(self.device):
                    _chunk_half(self.map, self._io, ch, track=track, promote=promote,
                                stop_at_keyframe=_speed_clamp_on(cfg))
            t_host.copy_(ch.t_out, non_blocking=True)
            self._start_fetch(ch.p_out, p_host)
            p_rows = self._wait_fetch(p_host)
            t_rows = t_host.numpy()
        self._host_dirty = True
        rows = []
        for t_row, p_row in zip(t_rows, p_rows):
            r = _track_row(t_row)
            rows.append(self._promoted(r, p_row) if r.promoted else r)
        return rows

    def complete_chunk(self, frames, fetched) -> int:
        """The host mirrors' tail of a fetched chunk: :meth:`complete` on
        each row in order; returns the number of rows consumed, after which
        the caller steps ``frames[done:]`` one at a time (process_frame).
        ``frames`` indexes the chunk's per-frame Features, or materializes
        the rows it is asked for (``materialize``, as _LazyFeatureRows):
        only promoted rows need theirs.

        It stops before a row that lost tracking (C left the map as it was
        from that row on) and, with the speed clamp on, after the first
        promoted row (C left the map as it was after that row, whose host
        event may rewrite it). A closure event found inside the chunk runs
        at its end, on a settled state (the reference's _pending_closure;
        here also when the chunk stops early)."""
        need = [i for i, r in enumerate(fetched) if r.promoted]
        mat = (frames.materialize(need) if hasattr(frames, "materialize")
               else {i: frames[i] for i in need})
        stop = _speed_clamp_on(self.state.config)
        done = len(fetched)
        self._defer_closure = True
        try:
            for i, row in enumerate(fetched):
                lost = row.lost or not (np.isfinite(row.R).all() and np.isfinite(row.t).all())
                if self.map is None or lost:
                    done = i
                    break
                self.complete(mat.get(i), row)
                if stop and row.promoted:
                    done = i + 1
                    break
        finally:
            self._defer_closure = False
        pend, self._pending_closure = self._pending_closure, None
        if pend is not None and self.map is not None:
            self._closure(pend)
        return done

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
            elif cfg.ground_height_m > 0:  # a fleet row: the host event path
                self._ground_prior(fetched.ground_h)
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
            if self._defer_closure:  # inside a chunk: at its end, on a settled state
                self._pending_closure = cand
            else:
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

    def _ground_prior(self, h_obs: float) -> None:
        """The ground-plane scale hold of a fleet row (vo.apply_ground_prior):
        record the observation and, outside the deadband, rescale the device
        map about the newest camera center (_ground_rescale, in place) and
        the ring keyframes' host poses the same way; no sync, no fetch. The
        fleet hands the row over first when :func:`_ground_corrects` says a
        correction applies."""
        st = self.state
        if h_obs <= 1e-9:
            return
        r = hostvo.ground_correction_ratio(st.config, hostvo.smoothed_ground(st, h_obs))
        if r is None:
            return
        if self.map is None:
            raise RuntimeError("a ground-prior correction needs the engine's device map")
        kf = st.keyframes[-1]
        c0 = -kf.R.T @ kf.t
        m = self.map
        with precise():
            m2 = _ground_rescale(m, r, torch.as_tensor(c0, dtype=torch.float32).to(self.device))
        m.X.copy_(m2.X)
        m.kf_t.copy_(m2.kf_t)
        # the ring keyframes' host poses only, as the device rescale does;
        # older keyframes keep their poses (corrections rewrite no history)
        for k in st.keyframes[-st.config.window:]:
            c = c0 + ((-k.R.T @ k.t) - c0) * r
            k.t = (-k.R @ c).astype(np.float32)
        self._host_dirty = True  # the landmark mirror refreshes at the next sync
        st.track_version += 1
        st.trajectory[-1] = (st.frame_count, kf.R.copy(), kf.t.copy())
        hostvo._diag(st, ev="ground", h=float(h_obs), r=r)

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
        if _speed_clamp_on(cfg) and med is not None and not (lo * med * gap <= b <= hi * med * gap):
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


def _wait(device) -> None:
    """One wait for everything launched on ``device``'s current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class DeviceVOServer:
    """Fleet of :class:`DeviceVO` engines, each with its own two graphs,
    stepped with two waits per tick: every stream's T is replayed with its
    fetch started, then one wait; P is replayed for the streams that
    promote, then one more wait; then each stream's host tail runs.
    Bootstrap and the rare events run per stream, exactly as in DeviceVO,
    so a 1-stream server equals DeviceVO."""

    def __init__(self, config: VOConfig = VOConfig(), n_streams: int = 8, device="cuda"):
        self.engines = [DeviceVO(config, device=device) for _ in range(n_streams)]
        self.device = self.engines[0].device if self.engines else torch.device(device)

    @property
    def states(self):
        return [e.state for e in self.engines]

    def sync_host(self, i: int) -> VOState:
        return self.engines[i].sync_host()

    def finalize(self, i: int) -> VOState:
        return self.engines[i].finalize()

    def step(self, frames) -> None:
        """Advance every stream by one frame (``frames[i]`` may be None)."""
        if len(frames) != len(self.engines):
            raise ValueError(f"{len(frames)} frames for {len(self.engines)} streams")
        pending = []
        for i, (eng, feats) in enumerate(zip(self.engines, frames)):
            if feats is None:
                continue
            if eng.map is None:
                eng.process_frame(feats)  # bootstrap: the host path (rare)
                continue
            eng.dispatch_track(feats)
            pending.append(i)
        if not pending:
            return
        _wait(self.device)  # wait 1: every stream's T
        outs = {i: self.engines[i].fetch_track() for i in pending}
        promoted = [i for i in pending if outs[i].promoted]
        for i in promoted:
            self.engines[i].dispatch_promote()
        if promoted:
            _wait(self.device)  # wait 2: the promoters' P
        for i in promoted:
            outs[i] = self.engines[i].fetch_promote(outs[i])
        for i in pending:
            self.engines[i].complete(frames[i], outs[i])


# ---------------------------------------------------------------------------
# the stacked fleet: two graphs over [S, ...] stacked maps
# ---------------------------------------------------------------------------


class _FleetAux(NamedTuple):
    """Per-stream control state of the pipelined fleet, on the device.

    The classic tick reads host mirrors (the constant-velocity prediction,
    the keyframe-gap flag) before every step, so tick k cannot start before
    tick k-1's fetch is home. With this state on the device a tick depends
    only on its own features, and the host fetches one tick late.

    R1/t1    [S, 3, 3] / [S, 3]  pose at the last tracked frame.
    R0/t0                        pose one frame before that.
    traj_n   [S] int32           how many of those are real (0..2).
    since_kf [S] int32           frames since the last keyframe (the host's
                                 frame_count - kf.index).
    block    [S] bool            the previous tick promoted or lost: no
                                 promotion this tick, so a ring change never
                                 outruns the host mirror, which processes
                                 tick k-1 after tick k was launched.
    """

    R1: torch.Tensor
    t1: torch.Tensor
    R0: torch.Tensor
    t0: torch.Tensor
    traj_n: torch.Tensor
    since_kf: torch.Tensor
    block: torch.Tensor


class _FleetIO(NamedTuple):
    """The fleet graphs' static input and output buffers (S streams)."""

    active: torch.Tensor  # [S] in: the streams stepped this tick
    yx: torch.Tensor  # [S, N, 2] in: the tick's features
    desc: torch.Tensor  # [S, N, D]
    fvalid: torch.Tensor  # [S, N]
    pose: torch.Tensor  # [S, 12] in (classic): the PnP predictions, R then t
    force: torch.Tensor  # [S] in (classic): forced promotions
    prio: torch.Tensor  # [] in: the fair-serve origin of promote_cap
    uv_new: torch.Tensor  # [S, N, 2] FT -> FP
    idx: torch.Tensor  # [S, N] int64
    obs_pre: torch.Tensor  # [S, N] int32
    R: torch.Tensor  # [S, 3, 3]
    t: torch.Tensor  # [S, 3]
    promote: torch.Tensor  # [S]
    lost: torch.Tensor  # [S]
    sig_new: torch.Tensor  # [S, D]
    ground_h: torch.Tensor  # [S]
    t_out: torch.Tensor  # [S, 17 + 2 M] int32: T's row layout per stream
    # [S, 12 W + 2 N + 2] int32: kf_R, kf_t (bits), obs_new, obs_gen,
    # lm_count, served
    p_out: torch.Tensor
    # pipelined: t_out, p_out, then the promoted-row payload: row_stream
    # [PB], row_yx [PB, N, 2] (bits), row_desc [PB, N, D] (bits),
    # row_valid [PB, N]; PB = promote_cap, or S uncapped. Empty (classic).
    pipe_out: torch.Tensor


def _bits_rows(a):
    return a.reshape(a.shape[0], -1).view(torch.int32)


def _carried(m: DeviceMap) -> tuple:
    """The names of a map's carried (not None) fields."""
    return tuple(f for f, a in zip(m._fields, m) if a is not None)


def _stacked(fn, names):
    """``fn(map, *args)`` vmapped over a leading stream axis of the map's
    carried fields ``names`` and of ``args``; the map goes in and out of
    the vmapped function as the tuple of those fields."""
    def one(fields, *args):
        return fn(DeviceMap(**dict(zip(names, fields))), *args)

    return torch.func.vmap(one)


def _fleet_promote(ms: DeviceMap, do_promote, io: _FleetIO, prio_offset, *, iterations,
                   huber_delta, tri_angle, promote_cap, gdo=None, lo=0):
    """The batched promotion, optionally compacted to a sub-batch:
    (carried fields of the promoted stack, served [S], comp).

    Uncapped, the promotion runs over all S streams, each stream's result
    kept where it promotes (``torch.where``), and ``comp [S]`` is each
    promoting stream's id (-1 elsewhere). With ``promote_cap`` = PB < S the
    first PB promoting streams in a rotated order, whose origin
    ``prio_offset`` advances by PB each tick, are compacted by prefix sum
    into a [PB] sub-batch, promoted there and put back (each served stream
    takes its row of the sub-batch: no scatter, no colliding index);
    ``comp [PB]`` is the sub-batch's stream ids (-1 pads). Streams beyond
    the cap are deferred: their promotion conditions persist, and every
    requesting stream is served within ceil(S / PB) ticks. ``served``, not
    the raw flag, says whose promotion ran.

    A sharded fleet's rank passes ``gdo`` [S_all], the requests of the whole
    fleet (gathered between FT and FP), and ``lo``, its first stream: the
    cap and the rotated order stay the whole fleet's (a stream is served
    when fewer than PB requests come before it), and the rank compacts its
    served streams into a sub-batch of min(PB, S) rows."""
    S = do_promote.shape[0]
    names = _carried(ms)
    dev = do_promote.device
    args = (io.uv_new, io.desc, io.fvalid, io.idx, io.obs_pre, io.R, io.t)
    if ms.sig is not None:
        args += (io.sig_new,)

    def one(m, p, uv, d, fv, ix, ob, R, t, *sig):
        m2 = _promote(m, uv, d, fv, ix, ob, R, t, sig[0] if sig else None,
                      iterations=iterations, huber_delta=huber_delta, tri_angle=tri_angle)
        return tuple(torch.where(p, getattr(m2, f), getattr(m, f)) for f in names)

    fields = tuple(getattr(ms, f) for f in names)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    if gdo is None:
        if not promote_cap or promote_cap >= S:
            out = _stacked(one, names)(fields, do_promote, *args)
            return out, do_promote, torch.where(do_promote, ids, -1)
        PB = int(promote_cap)
        order = torch.remainder(ids - prio_offset, S)
        rank = (do_promote[None, :] & (order[None, :] < order[:, None])).sum(1, dtype=torch.int32)
        served = do_promote & (rank < PB)
    else:
        S_all = gdo.shape[0]
        order_all = torch.remainder(torch.arange(S_all, dtype=torch.int32, device=dev) - prio_offset,
                                    S_all)
        order = order_all[lo: lo + S]
        before = (gdo[None, :] & (order_all[None, :] < order[:, None])).sum(1, dtype=torch.int32)
        served = do_promote & (before < promote_cap)
        PB = min(int(promote_cap), S)
        rank = (served[None, :] & (order[None, :] < order[:, None])).sum(1, dtype=torch.int32)
    slots = torch.full((S + 1,), S, dtype=torch.int32, device=dev).index_put(
        (torch.where(served, rank, S).long(),), ids
    )
    idx = slots[:PB]  # the r-th served stream; S on pads
    gidx = idx.clamp_max(S - 1).long()
    psub = served[gidx] & (idx < S)
    sub = _stacked(one, names)(tuple(a[gidx] for a in fields), psub, *(a[gidx] for a in args))
    pos = rank.clamp(0, PB - 1).long()
    out = tuple(
        torch.where(served.view((S,) + (1,) * (a.dim() - 1)), b[pos], a)
        for a, b in zip(fields, sub)
    )
    return out, served, torch.where(idx < S, idx, -1)


def _fleet_track_half(ms: DeviceMap, io: _FleetIO, aux: Optional[_FleetAux], *, kf_max_gap,
                      loop_min_gap, loop_cands, **track) -> None:
    """FT: the track phase (and the signature phase when the stacks carry
    the store) of every stream over the stacked maps, in one batched pass.
    Classic (``aux`` None): the PnP predictions and forced promotions come
    from the host in ``io``; pipelined: from ``aux`` (the constant-velocity
    prediction with the motion model, the keyframe pose otherwise, and the
    gap counter). Reads ``ms``; writes FT's outputs into ``io``."""
    S = io.active.shape[0]
    if aux is None:
        Rp, tp, force = io.pose[:, :9].reshape(S, 3, 3), io.pose[:, 9:], io.force
    else:
        kfR, kft = ms.kf_R[:, -1], ms.kf_t[:, -1]
        if track["dual_init"]:  # the motion model
            Rp, tp = torch.func.vmap(vo_core.predict_const_velocity)(
                aux.R1, aux.t1, aux.R0, aux.t0, aux.traj_n, kfR, kft
            )
        else:
            Rp, tp = kfR, kft
        force = aux.since_kf >= kf_max_gap
    names = _carried(ms)
    fields = tuple(getattr(ms, f) for f in names)
    tr = _TrackOut(*_stacked(lambda m, *a: tuple(_track_phase(m, *a, **track)), names)(
        fields, io.yx, io.desc, io.fvalid, Rp, tp, force
    ))
    for dst, src in ((io.uv_new, tr.uv_new), (io.idx, tr.idx), (io.obs_pre, tr.obs_pre),
                     (io.R, tr.R), (io.t, tr.t), (io.promote, tr.promote), (io.lost, tr.lost),
                     (io.ground_h, tr.ground_h)):
        dst.copy_(src)
    flags = torch.stack([a.to(torch.int32) for a in (tr.n, tr.n_valid, tr.promote, tr.lost)], 1)
    parts = [_bits_rows(tr.R), _bits_rows(tr.t), flags, _bits_rows(tr.ground_h)]
    if ms.sig is not None:
        sig_new, cand_idx, cand_score = _stacked(
            lambda m, d, v: _sig_phase(m, d, v, loop_min_gap=loop_min_gap, loop_cands=loop_cands),
            names,
        )(fields, io.desc, io.fvalid)
        io.sig_new.copy_(sig_new)
        parts += [cand_idx.to(torch.int32), _bits_rows(cand_score)]
    io.t_out.copy_(torch.cat(parts, 1))


def _promote_requests(io: _FleetIO, aux: Optional[_FleetAux]) -> torch.Tensor:
    """[S] the streams whose FT asked for a promotion that FP may run: the
    stepped ones, and pipelined, not held off by the previous tick."""
    do = io.promote & io.active
    return do if aux is None else do & ~aux.block


def _fleet_promote_half(ms: DeviceMap, io: _FleetIO, aux: Optional[_FleetAux], *, iterations,
                        huber_delta, tri_angle, promote_cap, ground_target=0.0, gdo=None,
                        lo=0) -> None:
    """FP: the batched (or capped) promotion of the streams whose FT asked
    for one, written in place into the stacked buffers, and the fetch rows
    into ``io.p_out``. Pipelined (``aux`` given): promotion is held off for
    a stream whose previous tick promoted or lost (``aux.block``), then the
    promoted rows' features, the control state's update and the tick's
    whole fetch (``io.pipe_out``). As in the reference's fleet there is no
    in-step ground controller (``ground_target`` unused): a fleet row takes
    the host's ground path. ``gdo``, ``lo``: a sharded fleet's global
    requests and first stream (_fleet_promote)."""
    S = io.active.shape[0]
    do = _promote_requests(io, aux)
    out, served, comp = _fleet_promote(
        ms, do, io, io.prio, iterations=iterations, huber_delta=huber_delta,
        tri_angle=tri_angle, promote_cap=promote_cap, gdo=gdo, lo=lo,
    )
    for f, src in zip(_carried(ms), out):
        getattr(ms, f).copy_(src)
    obs_new = ms.kf_obs[:, -1]
    io.p_out.copy_(torch.cat([
        _bits_rows(ms.kf_R), _bits_rows(ms.kf_t), obs_new,
        torch.gather(ms.lm_gen, 1, obs_new.clamp_min(0).long()),
        ms.lm_valid.sum(1, dtype=torch.int32)[:, None], served.to(torch.int32)[:, None],
    ], 1))
    if aux is None:
        return
    # the promoted rows' features ride home with the tick's fetch
    g = comp.clamp_min(0).long()
    row_valid = io.fvalid[g] & (comp >= 0)[:, None]
    # the control state: a tracked frame appends its pose, a promoted
    # frame's entry is the BA-refined keyframe pose (the host trajectory's)
    fin = torch.isfinite(io.R).flatten(1).all(1) & torch.isfinite(io.t).all(1)
    upd = ~io.lost & fin & io.active
    newR = torch.where(served[:, None, None], ms.kf_R[:, -1], io.R)
    newt = torch.where(served[:, None], ms.kf_t[:, -1], io.t)
    nxt = _FleetAux(
        R1=torch.where(upd[:, None, None], newR, aux.R1),
        t1=torch.where(upd[:, None], newt, aux.t1),
        R0=torch.where(upd[:, None, None], aux.R1, aux.R0),
        t0=torch.where(upd[:, None], aux.t1, aux.t0),
        traj_n=torch.where(upd, torch.clamp_max(aux.traj_n + 1, 2), aux.traj_n),
        since_kf=torch.where(io.active, torch.where(served, 1, aux.since_kf + 1), aux.since_kf),
        block=torch.where(io.active, served | io.lost, aux.block),
    )
    for dst, src in zip(aux, nxt):
        dst.copy_(src)
    io.pipe_out.copy_(torch.cat([
        io.t_out.reshape(-1), io.p_out.reshape(-1), comp.to(torch.int32),
        io.yx[g].reshape(-1).view(torch.int32), io.desc[g].reshape(-1).view(torch.int32),
        row_valid.reshape(-1).to(torch.int32),
    ]))


class _LazyFeatureRows:
    """The frames of a :meth:`DeviceVOFleet.step_batched` tick: stream i's
    Features row (a copy of the batch's row on its device) is made only
    when the host mirror needs it, on a loss (a promotion's row comes with
    the tick's fetch), a few streams a tick. score, theta and level are not in the serving
    input and are zero (matching, signatures, relocalization and closure
    verification read yx, desc and valid only)."""

    def __init__(self, yx, desc, fvalid):
        self.yx, self.desc, self.fvalid = yx, desc, fvalid

    def materialize(self, idxs) -> dict:
        """{i: Features} for the requested streams, each row copied out of
        the batch on its device (no host round trip)."""
        return {int(i): _row_features(self.yx[i].clone(), self.desc[i].clone(),
                                      self.fvalid[i].clone()) for i in idxs}


def _row_features(yx, desc, valid) -> Features:
    z = torch.zeros(yx.shape[0], dtype=torch.float32, device=yx.device)
    return Features(yx=yx, score=z, theta=z, level=z.to(torch.int32), desc=desc, valid=valid)


def _stack_features(frames, tick, N, D, device):
    """The tick's features as [S, N, 2], [S, N, D], [S, N] on ``device``,
    zeros for the streams not stepped."""
    zero = (torch.zeros((N, 2), device=device), torch.zeros((N, D), device=device),
            torch.zeros(N, dtype=torch.bool, device=device))
    rows = [(f.yx, f.desc, f.valid) if tick[i] else zero for i, f in enumerate(frames)]
    return tuple(torch.stack([r[k].to(device) for r in rows]) for k in range(3))


def _ground_corrects(state: VOState, h_obs: float) -> bool:
    """Would DeviceVO._ground_prior(h_obs) rescale the map: is the
    smoothed observation it would record outside the deadband?"""
    if h_obs <= 1e-9 or state.config.ground_height_m <= 0:
        return False
    h_sm = float(np.median((state.ground_hist + [float(h_obs)])[-3:]))
    return hostvo.ground_correction_ratio(state.config, h_sm) is not None


class DeviceVOFleet:
    """The stacked fleet: every stream's map in one ``[S, ...]`` stack, and
    each tick two graphs over it for all streams at once (twin of the
    reference's vmapped fleet).

    - **FT** (every tick): the track and signature phases of every stream,
      batched over the stream axis (``torch.func.vmap`` of DeviceVO's
      phases).
    - **FP**: the promotion of the streams that ask for one, batched over
      all S streams (each stream's result kept where it promotes) or, with
      ``promote_cap``, compacted to a sub-batch of that many streams.

    The classic tick replays FT, fetches ``[S, 17 + 2 M]`` int32 in one
    copy and replays FP only when some stepped stream promotes, then
    fetches once more. The pipelined tick (``pipeline=True``) replays FT
    and FP back to back with no host read between them: the predictions
    and the keyframe gap live on the device (:class:`_FleetAux`), and the
    tick's fetch is one asynchronous copy into a ring of
    ``pipeline_depth + 1`` pinned host buffers, which the host reads one
    tick (``step``) or ``pipeline_depth`` ticks (``step_batched``) later.
    The stack and buffers are static: the graphs are captured once, when
    the first stream enters (``captures`` 2, and its engines 0). On the
    CPU the same halves run eagerly. All streams share one VOConfig.

    Stream lifecycle: an engine bootstraps on the host; once initialized
    its map is copied into row i of the stack (``active[i]``). Rare events
    (loss, closure, the speed clamp, a ground correction) copy the row out
    into the engine's own buffers, run the host path there and copy it
    back.

    The mesh (``mesh``, ``mesh_axis``): the stream axis sharded over the n
    ranks of a mesh axis, one process a rank. Rank r owns streams
    ``[r S/n, (r + 1) S/n)``: its ``engines``, ``active`` and ``stack``
    hold those S/n streams on its device, with FT and FP of its own (2
    captures a rank), and only its engines bootstrap or take host paths.
    The step has no cross-stream dataflow, so an uncapped tick needs no
    collective. With ``promote_cap`` the cap and the rotating origin stay
    the whole fleet's: each tick every rank's requests are all-gathered
    between FT and FP (on the card: under NCCL queued on the stream with
    no host wait; under gloo staged through the host, one wait a tick
    before FP), and every rank ranks the same [S] requests.
    :meth:`step` takes all S frames on every rank, :meth:`step_batched`
    only the rank's S/n rows; :meth:`sync_host`, :meth:`finalize` and
    :attr:`states` keep their meaning for every stream (the owner sends the
    state), so they are collectives: every rank calls them, and step, in
    the same order.

    Spans (utils/profiling.py): each :meth:`step` and :meth:`step_batched`
    is one ``fleet.step`` with the counts ``tick`` (the call's number),
    ``stepped`` (streams on the stack this tick), ``bootstrapped`` (streams
    whose frame the host path took), ``fp_rows`` (the rows FP's replay
    computed: S, or the cap; 0 when FP did not run), ``promoted`` (streams
    whose fetched P row says they promoted) and ``event_paths`` (streams
    whose completion took a host event path). The classic tick's children
    are ``fleet.enter``, ``fleet.stage``, ``fleet.ft``, ``fleet.wait``
    (attr ``fetch`` 1 or 2), ``fleet.fp``, ``fleet.complete`` and, inside
    it, one ``fleet.event`` per event path (attr ``stream``, the row);
    the pipelined tick's ``fleet.enter``, ``fleet.launch`` and
    ``fleet.process`` (a ``fleet.wait`` inside), whose ``promoted`` and
    ``event_paths`` go on the step that processes the fetched tick.
    """

    def __init__(self, config: VOConfig = VOConfig(), n_streams: int = 8, mesh=None,
                 mesh_axis: str = "data", pipeline: bool = False, promote_cap: int = 0,
                 pipeline_depth: int = 1, device="cuda"):
        """``pipeline``: fetch one tick late (see the class docstring); the
        host mirrors, and loss and closure events, lag a tick, and on an
        event the in-flight tick of that stream is dropped and counted as
        a skipped frame. ``promote_cap``: promote at most this many streams
        a tick (0: uncapped); the rest defer a tick. ``pipeline_depth``
        (step_batched): ticks in flight before the host reads results.
        ``mesh``: a parallel.make_mesh mesh whose axis ``mesh_axis`` shards
        the streams (see the class docstring); the fleet then runs on this
        rank's device, and ``device`` is not read."""
        self.config = config
        self.promote_cap = int(promote_cap)
        self.n_streams = int(n_streams)
        # the mesh: (ranks, this rank's first stream, the axis's group)
        self._shard = None
        n_local = self.n_streams
        if mesh is not None:
            from cvsteer_tpu_torch.parallel.mesh import rank_device, sharded_axis

            n, r, group = sharded_axis(mesh, mesh_axis)
            if n_streams % n != 0:
                raise ValueError(
                    f"n_streams={n_streams} must divide over "
                    f"mesh axis {mesh_axis}={n}"
                )
            n_local = n_streams // n
            self._shard = (n, r * n_local, group)
            device = rank_device(mesh)
        # the capped promotion of a sharded fleet ranks the whole fleet's
        # requests, gathered each tick (_share_requests)
        self._share = self._shard is not None and 0 < self.promote_cap < self.n_streams
        # rotating fair-serve origin of the capped promotion
        self._promote_rr = 0
        # calls of step and step_batched: the fleet.step span's ``tick``
        self._ticks = 0
        self.engines = [DeviceVO(config, device=device, capture=False) for _ in range(n_local)]
        self.device = self.engines[0].device if self.engines else torch.device(device)
        if self._share:
            # the gathered requests FP ranks, and the origin kept on the
            # device (a rank with no stream stepped still joins the gather)
            self._gdo = torch.zeros(self.n_streams, dtype=torch.bool, device=self.device)
            self._rr_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.stack: Optional[DeviceMap] = None
        self.aux: Optional[_FleetAux] = None
        self.active = np.zeros(n_local, bool)
        self._pipeline = bool(pipeline)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.captures = 0
        self._io: Optional[_FleetIO] = None
        self._graphs = None
        # in-flight ticks, oldest first: [frames, tick mask, ring slot,
        # drop set, event]
        self._queue = []
        self._slot = 0

    def _advance_rr(self, S: int) -> int:
        """The current fair-serve origin; advances by promote_cap a tick."""
        o = self._promote_rr
        if self.promote_cap:
            self._promote_rr = (o + self.promote_cap) % max(S, 1)
        return o

    @property
    def states(self):
        """Every stream's VOState (on a mesh: a collective, each rank
        sending its own streams')."""
        own = [e.state for e in self.engines]
        if self._shard is None:
            return own
        from cvsteer_tpu_torch.parallel.halo import all_gather_object

        return [st for part in all_gather_object(own, self._shard[2]) for st in part]

    def _owned(self, i: int) -> Optional[int]:
        """Stream i's index among this rank's engines (None: another rank's)."""
        if self._shard is None:
            return i
        if not -self.n_streams <= i < self.n_streams:
            raise IndexError(f"stream {i} of {self.n_streams}")
        k = i % self.n_streams - self._shard[1]
        return k if 0 <= k < len(self.engines) else None

    def _from_owner(self, i: int, fn) -> VOState:
        """``fn(local index)`` on stream i's rank, its result on every rank
        (a collective on a mesh)."""
        k = self._owned(i)
        if self._shard is None:
            return fn(k)
        from cvsteer_tpu_torch.parallel.halo import all_gather_object

        got = all_gather_object(None if k is None else fn(k), self._shard[2])
        return got[i % self.n_streams // len(self.engines)]

    # -- the stack and its buffers ------------------------------------------

    def _kwargs(self):
        track, promote = _step_kwargs(self.config)
        promote = dict(promote, promote_cap=self.promote_cap)
        if self._share:
            promote.update(gdo=self._gdo, lo=self._shard[1])
        return track, promote

    def _ensure_stack(self, template: DeviceMap) -> None:
        """Allocate the stack, the buffers and the host rings at the first
        stream's entry, and capture FT and FP on a card."""
        if self.stack is not None:
            return
        S, dev, cfg = len(self.engines), self.device, self.config
        N, D = (int(n) for n in template.kf_desc.shape)
        W = cfg.window
        M = cfg.loop_max_candidates if cfg.loop_closure else 0
        PB = min(self.promote_cap, S) if 0 < self.promote_cap < self.n_streams else S

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.stack = DeviceMap(*(
            None if a is None else z((S,) + tuple(a.shape), a.dtype) for a in template
        ))
        n_t, n_p = 17 + 2 * M, 12 * W + 2 * N + 2
        n_pipe = S * (n_t + n_p) + PB * (1 + 3 * N + N * D) if self._pipeline else 0
        i32, b = torch.int32, torch.bool
        self._io = _FleetIO(
            active=z(S, b), yx=z((S, N, 2)), desc=z((S, N, D)), fvalid=z((S, N), b),
            pose=z((S, 12)), force=z(S, b), prio=z((), i32), uv_new=z((S, N, 2)),
            idx=z((S, N), torch.int64), obs_pre=z((S, N), i32), R=z((S, 3, 3)), t=z((S, 3)),
            promote=z(S, b), lost=z(S, b), sig_new=z((S, D)), ground_h=z(S),
            t_out=z((S, n_t), i32), p_out=z((S, n_p), i32), pipe_out=z(n_pipe, i32),
        )
        if self._pipeline:
            eye = torch.eye(3, device=dev).expand(S, 3, 3).contiguous()
            self.aux = _FleetAux(R1=eye, t1=z((S, 3)), R0=eye.clone(), t0=z((S, 3)),
                                 traj_n=z(S, i32), since_kf=z(S, i32), block=z(S, b))
        pin = dev.type == "cuda"
        self._t_host = torch.zeros((S, n_t), dtype=i32, pin_memory=pin)
        self._p_host = torch.zeros((S, n_p), dtype=i32, pin_memory=pin)
        self._pose_host = torch.zeros((S, 12), dtype=torch.float32, pin_memory=pin)
        self._force_host = torch.zeros(S, dtype=b, pin_memory=pin)
        ring = self.pipeline_depth + 1
        self._active_host = [torch.zeros(S, dtype=b, pin_memory=pin) for _ in range(ring)]
        self._ring = [torch.zeros(n_pipe, dtype=i32, pin_memory=pin) for _ in range(ring)]
        self._sizes = dict(S=S, N=N, D=D, W=W, PB=PB, n_t=n_t, n_p=n_p)
        if pin:
            self._capture()

    def _capture(self) -> None:
        """Capture FT and FP once, after a warm-up on clones of the stack
        and buffers."""
        track, promote = self._kwargs()
        clone = lambda t: None if t is None else type(t)(  # noqa: E731
            *(None if a is None else a.clone() for a in t))
        m_w, io_w, aux_w = clone(self.stack), clone(self._io), clone(self.aux)

        def warm():
            _fleet_track_half(m_w, io_w, aux_w, **track)
            _fleet_promote_half(m_w, io_w, aux_w, **promote)

        self._graphs = _capture_graphs(self.device, warm, (
            lambda: _fleet_track_half(self.stack, self._io, self.aux, **track),
            lambda: _fleet_promote_half(self.stack, self._io, self.aux, **promote),
        ))
        self.captures += len(self._graphs)

    def _run_half(self, k: int, *, eager: bool = False) -> None:
        """FT (k = 0) or FP (k = 1): its graph's replay, or eagerly where
        there is no graph (or when asked)."""
        if self._graphs is not None and not eager:
            self._graphs[k].replay()
            return
        half = (_fleet_track_half, _fleet_promote_half)[k]
        with _step_math(self.device):
            half(self.stack, self._io, self.aux, **self._kwargs()[k])

    def _aux_row(self, eng: DeviceVO) -> _FleetAux:
        """A stream's control state at its entry, from its host mirror (the
        reads the classic tick makes each tick)."""
        st = eng.state
        kf = st.keyframes[-1]
        traj = st.trajectory
        R1, t1 = (traj[-1][1], traj[-1][2]) if traj else (kf.R, kf.t)
        R0, t0 = (traj[-2][1], traj[-2][2]) if len(traj) >= 2 else (R1, t1)
        return _FleetAux(
            R1=np.asarray(R1, np.float32), t1=np.asarray(t1, np.float32),
            R0=np.asarray(R0, np.float32), t0=np.asarray(t0, np.float32),
            traj_n=np.int32(min(len(traj), 2)), since_kf=np.int32(st.frame_count - kf.index),
            block=np.bool_(False),
        )

    def _scatter_in(self, i: int) -> None:
        """Copy engine i's map into row i of the stack (``copy_``: the
        stack's buffers are never rebound) and make the stream active."""
        eng = self.engines[i]
        self._ensure_stack(eng.map)
        for dst, src in zip(self.stack, eng.map):
            if dst is not None:
                dst[i].copy_(src)
        if self._pipeline:
            for dst, src in zip(self.aux, self._aux_row(eng)):
                dst[i].copy_(torch.as_tensor(src))
        eng.map = None  # fleet-managed from here on
        self.active[i] = True

    def _gather_out(self, i: int) -> None:
        """Copy row i of the stack into engine i's own buffers, for the host
        event paths that sync and upload."""
        eng = self.engines[i]
        for dst, src in zip(eng._bufs, self.stack):
            if dst is not None:
                dst.copy_(src[i])
        eng.map = eng._bufs
        eng._host_dirty = True
        self.active[i] = False

    def _sync_local(self, i: int) -> VOState:
        if self.active[i]:
            self._gather_out(i)
            state = self.engines[i].sync_host()
            self._scatter_in(i)
            return state
        return self.engines[i].sync_host()

    def sync_host(self, i: int) -> VOState:
        """Pull stream i's device state into its host mirror (on a mesh, a
        collective: the owner's state on every rank)."""
        self._flush()
        return self._from_owner(i, self._sync_local)

    def finalize(self, i: int) -> VOState:
        """Stream i's finalized VOState (on a mesh, a collective)."""
        self._flush()

        def local(k):
            self._sync_local(k)
            return hostvo.finalize(self.engines[k].state)

        return self._from_owner(i, local)

    # -- the tick -----------------------------------------------------------

    def step(self, frames) -> None:
        """Advance every stream by one frame (``frames[i]`` may be None); on
        a mesh every rank passes all S frames and steps its own."""
        if len(frames) != self.n_streams:
            raise ValueError(f"{len(frames)} frames for {self.n_streams} streams")
        if self._shard is not None:
            lo = self._shard[1]
            frames = list(frames[lo: lo + len(self.engines)])
        with self._step_span() as sp:
            if self._pipeline:
                self._step_pipelined(frames, sp)
            else:
                self._step_classic(frames, sp)

    def _step_span(self) -> annotate:
        self._ticks += 1
        return annotate("fleet.step", tick=self._ticks - 1, stepped=0, bootstrapped=0, fp_rows=0,
                        promoted=0, event_paths=0)

    def _share_requests(self, ticked: bool) -> None:
        """A sharded capped fleet, every tick on every rank, between FT and
        FP: all-gather each rank's promotion requests (none when it stepped
        no stream) into the [S] mask FP ranks, take the tick's fair-serve
        origin and advance it when any rank stepped (as the single fleet
        does, on the device: no host wait under NCCL)."""
        from cvsteer_tpu_torch.parallel.halo import all_gather

        S = len(self.engines)
        mine = torch.zeros(S + 1, dtype=torch.int32, device=self.device)
        if ticked:
            mine[:S] = _promote_requests(self._io, self.aux).to(torch.int32)
            mine[S] = 1
        every = torch.stack(all_gather(mine, self._shard[2]))  # [n, S + 1]
        self._gdo.copy_(every[:, :S].reshape(-1) > 0)
        if self._io is not None:
            self._io.prio.copy_(self._rr_dev)
        step = torch.where(every[:, S].any(), self.promote_cap, 0)
        self._rr_dev.copy_(torch.remainder(self._rr_dev + step, self.n_streams))

    def _enter(self, frames, sp: annotate) -> Optional[np.ndarray]:
        """Bootstrap and (re)entry, the host path until an engine has a map;
        a stream that initializes here consumed this tick's frame. Returns
        the tick's mask of stepped streams, None when there is none."""
        consumed = set()
        for i, (eng, feats) in enumerate(zip(self.engines, frames)):
            if self.active[i] or feats is None:
                continue
            if eng.map is not None:
                # an adopted state waiting to enter: it has not consumed
                # this tick's frame
                self._scatter_in(i)
                continue
            eng.process_frame(feats)
            consumed.add(i)
            if eng.map is not None:
                self._scatter_in(i)
        sp.set(bootstrapped=len(consumed))
        if self.stack is None or not self.active.any():
            return None
        tick = self.active.copy()
        for i, feats in enumerate(frames):
            if feats is None or i in consumed:
                tick[i] = False
        return tick if tick.any() else None

    def _put_features(self, yx, desc, fvalid, tick, slot: int) -> None:
        io = self._io
        io.yx.copy_(yx)
        io.desc.copy_(desc)
        io.fvalid.copy_(fvalid)
        act = self._active_host[slot]
        act.numpy()[:] = tick
        io.active.copy_(act, non_blocking=True)
        if not self._share:  # else _share_requests sets it
            io.prio.fill_(self._advance_rr(self.n_streams))

    def _step_classic(self, frames, sp: annotate) -> None:
        with annotate("fleet.enter"):
            tick = self._enter(frames, sp)
        if tick is None:
            if self._share:
                self._share_requests(False)
            return
        cfg = self.config
        sz = self._sizes
        stepped = np.nonzero(tick)[0]
        io = self._io
        with annotate("fleet.stage"):
            pose, force = self._pose_host.numpy(), self._force_host.numpy()
            for i in stepped:
                st = self.engines[i].state
                kf = st.keyframes[-1]
                Rp, tp = hostvo._predict_pose(st) if cfg.motion_model else (kf.R, kf.t)
                pose[i, :9], pose[i, 9:] = np.reshape(Rp, 9), tp
                force[i] = (st.frame_count - kf.index) >= cfg.kf_max_gap
            self._put_features(*_stack_features(frames, tick, sz["N"], sz["D"], self.device),
                               tick, 0)
            io.pose.copy_(self._pose_host, non_blocking=True)
            io.force.copy_(self._force_host, non_blocking=True)
        with annotate("fleet.ft"):
            self._run_half(0)
            if self._share:
                self._share_requests(True)
            self._t_host.copy_(io.t_out, non_blocking=True)
        with annotate("fleet.wait", fetch=1):
            _wait(self.device)  # fetch 1: every stream's T row
        t_rows = self._t_host.numpy().copy()
        p_rows = None
        if (t_rows[:, 14].astype(bool) & tick).any():
            with annotate("fleet.fp"):
                self._run_half(1)
                self._p_host.copy_(io.p_out, non_blocking=True)
            with annotate("fleet.wait", fetch=2):
                _wait(self.device)  # fetch 2: the promotions
            p_rows = self._p_host.numpy().copy()
            sp.set(fp_rows=sz["PB"])
        with annotate("fleet.complete"):
            results = self._rows(t_rows, p_rows)
            events = sum(self._complete(i, frames[i], results[i]) for i in stepped)
        sp.set(stepped=len(stepped), promoted=sum(int(results[i].promoted) for i in stepped),
               event_paths=events)

    def _rows(self, t_rows, p_rows):
        """Each stream's StepOut from the fetched rows (``p_rows`` None: FP
        did not run, no stream promoted)."""
        sz = self._sizes
        W, N = sz["W"], sz["N"]
        out = []
        for i in range(sz["S"]):
            r = _track_row(t_rows[i])._replace(promoted=False)  # served, not asked, counts
            if p_rows is not None and p_rows[i, -1]:
                r = _promote_row(r, p_rows[i], W, N)._replace(promoted=True)
            out.append(r)
        return out

    def _needs_map(self, eng: DeviceVO, res: StepOut) -> bool:
        """Does this result take a host event path that needs the row's
        device map (loss, closure, the speed clamp, a ground correction)?"""
        cfg = self.config
        lost = res.lost or not (np.isfinite(res.R).all() and np.isfinite(res.t).all())
        return lost or (res.promoted and (
            cfg.loop_closure or cfg.speed_prior_band[1] > 0
            or _ground_corrects(eng.state, res.ground_h)
        ))

    def _complete(self, i: int, feats, res: StepOut) -> bool:
        """Stream i's host tail; an event hands the row to the engine and
        takes the result back. Returns whether the event path ran."""
        eng = self.engines[i]
        if self._needs_map(eng, res):
            with annotate("fleet.event", stream=int(i)):
                self._gather_out(i)
                eng.complete(feats, res)
                if eng.map is not None:
                    self._scatter_in(i)
                # else: the engine fell back to bootstrap; it re-enters when ready
            return True
        eng._host_dirty = True
        eng.complete(feats, res)
        return False

    # -- the pipelined tick -------------------------------------------------

    def _step_pipelined(self, frames, sp: annotate) -> None:
        with annotate("fleet.enter"):
            tick = self._enter(frames, sp)
        if tick is None:
            if self._share:
                self._share_requests(False)
            self._flush(sp)
            return
        with annotate("fleet.launch"):
            sz = self._sizes
            feats = _stack_features(frames, tick, sz["N"], sz["D"], self.device)
            self._launch(feats, tick, frames, sp)
        while len(self._queue) > 1:
            self._process(self._queue.pop(0), sp)

    def _launch(self, feats, tick, frames, sp: annotate) -> None:
        """One pipelined tick: the features in, FT and FP back to back, the
        fetch started into the ring's next slot, the tick queued."""
        sp.set(stepped=int(tick.sum()), fp_rows=self._sizes["PB"])
        slot = self._slot
        self._slot = (slot + 1) % len(self._ring)
        self._put_features(*feats, tick, slot)
        self._run_half(0)
        if self._share:
            self._share_requests(True)
        self._run_half(1)
        self._ring[slot].copy_(self._io.pipe_out, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._queue.append([frames, tick, slot, set(), event])

    def _flush(self, sp: Optional[annotate] = None) -> None:
        """Process every in-flight tick (pipelined; a no-op otherwise)."""
        q, self._queue = self._queue, []
        for pending in q:
            self._process(pending, sp)

    def step_batched(self, yx, desc, fvalid) -> None:
        """A pipelined tick from batched features (``yx [S, N, 2]``, ``desc
        [S, N, D]``, ``fvalid [S, N]``), on the fleet's device: what the
        batched front-end (features.extract_features over an [S, H, W]
        image stack) returns, so the tick needs no stacking. The host
        mirrors get feature rows only for streams that promote (in the
        tick's fetch) or lose tracking (copied out of the batch). Keeps up
        to ``pipeline_depth`` ticks in flight. Every stream must be active
        (bootstrap through :meth:`step`). On a mesh each rank passes only
        its own S/n rows, as its front end makes them."""
        if not self._pipeline:
            raise ValueError("step_batched needs pipeline=True")
        if self.stack is None or not self.active.all():
            raise ValueError("step_batched needs every stream active; bootstrap through step()")
        with self._step_span() as sp:
            tick = self.active.copy()
            with annotate("fleet.launch"):
                self._launch((yx, desc, fvalid), tick, _LazyFeatureRows(yx, desc, fvalid), sp)
            while len(self._queue) > self.pipeline_depth:
                self._process(self._queue.pop(0), sp)

    def _process(self, pending, sp: Optional[annotate]) -> None:
        """Apply a fetched tick to the host mirrors: the lagged twin of the
        classic tick's loop. A stream in the tick's drop set was rewritten
        by a host event after this tick was launched: its result is
        superseded and its frame counts as skipped. Its counts go on the
        step span ``sp`` (None: a flush outside a step)."""
        with annotate("fleet.process"):
            promoted, events = self._process_tick(*pending)
        if sp is not None:
            sp.add(promoted=promoted, event_paths=events)

    def _process_tick(self, frames, tick, slot, drop, event) -> Tuple[int, int]:
        if event is not None:
            with annotate("fleet.wait", fetch=1):
                event.synchronize()
        sz = self._sizes
        S, N, D, PB = sz["S"], sz["N"], sz["D"], sz["PB"]
        ring = self._ring[slot]
        h = ring.numpy()
        o = S * sz["n_t"]
        results = self._rows(h[:o].reshape(S, -1), h[o: o + S * sz["n_p"]].reshape(S, -1))
        if isinstance(frames, _LazyFeatureRows):
            # the promoted rows came with the fetch; losses (rare) are
            # copied out of the batch; tracked-only streams need none
            o += S * sz["n_p"]
            row_stream = h[o: o + PB]
            o += PB
            rows = {}
            for j, sid in enumerate(row_stream):
                if sid < 0:
                    continue
                a = o + j * 2 * N
                bd = o + PB * 2 * N + j * N * D
                bv = o + PB * 2 * N + PB * N * D + j * N
                rows[int(sid)] = _row_features(
                    self._to_device(ring[a: a + 2 * N]).view(torch.float32).view(N, 2),
                    self._to_device(ring[bd: bd + N * D]).view(torch.float32).view(N, D),
                    self._to_device(ring[bv: bv + N]) != 0,
                )
            need = [i for i in range(S) if tick[i] and i not in drop and i not in rows
                    and (results[i].promoted or results[i].lost
                         or not np.isfinite(results[i].R).all()
                         or not np.isfinite(results[i].t).all())]
            rows.update(frames.materialize(need))
            frames = [rows.get(i) for i in range(S)]
        promoted = events = 0
        for i in range(S):
            if not tick[i]:
                continue
            eng = self.engines[i]
            if i in drop:
                eng.state.frame_count += 1  # consumed; its result superseded
                continue
            res = results[i]
            lost = res.lost or not (np.isfinite(res.R).all() and np.isfinite(res.t).all())
            event_path = self._complete(i, frames[i], res)
            promoted += int(res.promoted)
            events += event_path
            # after a loss the in-flight ticks tracked from a stale map: drop
            # their results (skipped frames); after a closure the in-flight
            # tick is a plain track (the block latch forbids a ring change):
            # keep it, one tick stale, unless the engine fell back to
            # bootstrap
            if event_path and (lost or not self.active[i]):
                for pend in self._queue:
                    if pend[1][i]:
                        pend[3].add(i)
        return promoted, events

    def _to_device(self, a: torch.Tensor) -> torch.Tensor:
        """A slice of a pinned ring buffer on the fleet's device (a copy on
        the CPU), without a wait: the copy is queued before the slot's next
        fetch."""
        if self.device.type == "cuda":
            return a.to(self.device, non_blocking=True)
        return a.clone()

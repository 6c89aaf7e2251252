"""Monocular visual odometry: keyframing + windowed Schur BA — the host
engine of cvsteer_tpu.slam.vo, ported.

A host loop (keyframe decisions are control flow) around eager device
steps: the tracking step (match to the last keyframe, PnP with projective
rescue) and the keyframe step (triangulation + gating + windowed BA +
per-landmark reprojection error) each run on the device and are fetched
once. ``process_image`` runs features.frontend.extract_features;
``process_frame`` takes Features directly (the synthetic feature streams
of the tests use this seam).

Pose convention: T_k = (R_k, t_k), world -> camera-k. Scale is fixed by the
two-view initialization baseline (||t|| = 1).

Ported here: init and two-view bootstrap (with the ground-plane gauge),
tracking with rescue, relocalization, keyframe decision and promotion,
windowed BA, re-bootstrap, the keyframe epilogue (the ground prior, the
speed prior with its band, loop closure in SE(3) or Sim(3) through
slam.loopclosure), ``finalize`` (which re-anchors the whole trajectory on
the corrected keyframes), and the options both engines share with
cvsteer_tpu_torch.slam.vo_device: the constant-velocity motion model
(``motion_model``) and flow-driven keyframing (``kf_min_flow_px``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig, extract_features
from cvsteer_tpu_torch.features.matching import match_descriptors
from cvsteer_tpu_torch.geometry.camera import (
    Intrinsics,
    undistort_normalized,
    undistort_normalized_np,
)
from cvsteer_tpu_torch.geometry.epipolar import ransac_essential
from cvsteer_tpu_torch.geometry.pose import recover_pose, triangulate
from cvsteer_tpu_torch.slam import vo_core
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust, refine_pose
from cvsteer_tpu_torch.utils.metrics import StepTimer
from cvsteer_tpu_torch.utils.precision import precise

#: consecutive lost frames (no reloc) before the engine restarts its map
REBOOT_AFTER_LOST = 5
#: most landmarks one windowed BA solve carries (most-observed kept)
MAX_BA_LANDMARKS = 4096


class VOConfig(NamedTuple):
    """The reference's VOConfig, field for field (see cvsteer_tpu.slam.vo
    for each field's rationale).

    ``loop_scale_band`` (lo, hi) bounds a Sim(3) closure edge's measured
    relative scale and the solved node scales; lo <= 0 turns both checks
    off, hi included (ADVICE.md's finding at vo.py:126, ported as the
    reference has it: an upper bound alone cannot be set).
    ``speed_prior_band`` (lo, hi): hi = 0 turns the clamp off (the speed
    history is still recorded); ``ground_height_m`` 0 turns the ground
    prior off, and with it on the speed band records only."""

    intrinsics: Intrinsics = Intrinsics(500.0, 500.0, 320.0, 240.0)
    frontend: FrontendConfig = FrontendConfig()
    match_ratio: float = 0.85
    min_parallax: float = 0.03
    init_min_inliers: int = 30
    track_min_landmarks: int = 40
    kf_max_gap: int = 10
    kf_min_flow_px: float = 0.0
    window: int = 8
    ba_iterations: int = 12
    huber_delta: float = 4e-3
    ransac_hypotheses: int = 512
    ransac_threshold: float = 1e-5
    max_landmarks: int = 4096
    tri_min_ray_angle_deg: float = 0.35
    loop_closure: bool = False
    loop_closure_sim3: bool = False
    loop_min_gap: int = 6
    loop_min_inliers: int = 25
    loop_sig_capacity: int = 4096
    loop_max_candidates: int = 3
    loop_signature_threshold: float = 0.75
    loop_cooldown: int = 0
    loop_consistency: int = 1
    loop_reject_cooldown: int = 0
    loop_robust_delta: float = 0.0
    loop_scale_band: Tuple[float, float] = (0.5, 2.0)
    motion_model: bool = False
    # device engine only (cvsteer_tpu.slam.vo_device); the host engine
    # ignores it, as the reference's does
    track_local_map: bool = False
    rescue_radius_px: float = 12.0
    rescue_min_cos: float = 0.6
    speed_prior_band: Tuple[float, float] = (0.0, 0.0)
    speed_prior_window: int = 64
    ground_height_m: float = 0.0

    @property
    def rescue_radius_norm(self) -> float:
        f = 0.5 * (self.intrinsics.fx + self.intrinsics.fy)
        return float(self.rescue_radius_px) / max(f, 1e-6)

    @property
    def kf_min_flow_norm(self) -> float:
        """Flow-promotion threshold in normalized units."""
        f = 0.5 * (self.intrinsics.fx + self.intrinsics.fy)
        return float(self.kf_min_flow_px) / max(f, 1e-6)


@dataclasses.dataclass
class Keyframe:
    index: int  # frame index
    features: Features
    R: np.ndarray  # [3, 3] world->camera
    t: np.ndarray  # [3]
    landmark_ids: np.ndarray  # [N] int64, -1 = feature has no landmark
    # slot-generation stamps paired with landmark_ids (device engine only:
    # it reuses culled slots, and a stamp that differs from the slot's
    # generation marks an id whose slot now holds another landmark); None
    # on host-engine keyframes, whose culled ids are cleared at once
    landmark_gens: Optional[np.ndarray] = None
    # landmark ids freshly triangulated at this keyframe's promotion
    fresh_ids: Optional[np.ndarray] = None
    # lazily computed global descriptor (keyframe_signature)
    signature: Optional[np.ndarray] = None
    # device mirror (track_version, X [N, 3], sel [N]) of this keyframe's
    # landmark positions per feature slot, rebuilt when the map changes
    track_cache: Optional[tuple] = None
    # host mirror (x_norm [N, 2], valid [N]) of the immutable features
    host_cache: Optional[tuple] = None


@dataclasses.dataclass
class VOState:
    config: VOConfig
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))
    keyframes: List[Keyframe] = dataclasses.field(default_factory=list)
    landmarks: Optional[np.ndarray] = None  # [max_landmarks, 3]
    landmark_valid: Optional[np.ndarray] = None  # [max_landmarks]
    num_landmarks: int = 0
    trajectory: List[Tuple[int, np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=list
    )  # (frame_idx, R, t)
    # parallel to trajectory: None for keyframe entries, else
    # (ref_kf_frame, R_rel, t_rel, prev_kf_frame, b_old) for finalize()
    traj_ref: List[Optional[tuple]] = dataclasses.field(default_factory=list)
    initialized: bool = False
    frame_count: int = 0
    # bumped whenever landmark positions / keyframe poses mutate
    track_version: int = 0
    # consecutive frames with < 8 tracked landmarks and no relocalization
    lost_streak: int = 0
    # rolling per-frame speeds (inter-keyframe baseline / frame gap),
    # recorded at every promotion; feeds scale-continuous re-init
    kf_baselines: List[float] = dataclasses.field(default_factory=list)
    # diagnostic event log (None = off)
    diag: Optional[list] = dataclasses.field(default=None, repr=False)
    # per-phase timer (None = off): spans "features", "track", "keyframe",
    # "init", and "capture" (the device engine's one-time graph capture)
    timer: Optional[StepTimer] = dataclasses.field(default=None, repr=False)
    # lazily built signature index of the host closure path
    # (slam.loopclosure.state_signature_index)
    sig_index: Optional[object] = dataclasses.field(default=None, repr=False)
    # closure-gate bookkeeping (loopclosure.closure_gate): (region, streak)
    # of the last promotion's top candidate, and region -> keyframe-index
    # cooldowns after rejected verifications
    loop_streak: Tuple[int, int] = (-1, 0)
    loop_reject_until: dict = dataclasses.field(default_factory=dict)
    # rolling ground-height observations (smoothed_ground)
    ground_hist: List[float] = dataclasses.field(default_factory=list)

    def poses(self) -> Tuple[np.ndarray, np.ndarray]:
        """Trajectory as (R [F, 3, 3], t [F, 3])."""
        Rs = np.stack([p[1] for p in self.trajectory])
        ts = np.stack([p[2] for p in self.trajectory])
        return Rs, ts


def init_vo(config: VOConfig = VOConfig(), device="cuda") -> VOState:
    """A fresh VO state whose device steps run on ``device``."""
    state = VOState(config=config, device=torch.device(device))
    state.landmarks = np.zeros((config.max_landmarks, 3), np.float32)
    state.landmark_valid = np.zeros(config.max_landmarks, bool)
    return state


def _span(state: VOState, name: str):
    return state.timer.span(name) if state.timer is not None else contextlib.nullcontext()


def _dev(state: VOState, a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=state.device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _normalize(yx: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    uv = torch.stack([(yx[:, 1] - K.cx) / K.fx, (yx[:, 0] - K.cy) / K.fy], -1)
    return undistort_normalized(uv, K.dist) if K.has_distortion else uv


@precise()
def _track_fused(
    desc_a, valid_a, X_slots, sel_slots, yx_a, yx_b, desc_b, valid_b, R0, t0, R1, t1,
    K: Intrinsics, *, ratio, iterations, huber_delta, min_track, dual_init=False,
    rescue_radius=0.0, rescue_min_cos=0.6, kf_min_flow=0.0, ground_prior=False,
):
    """The steady-state tracking step: match to the keyframe, pair matched
    features with the keyframe-slot landmark mirror, motion-only PnP from
    the prediction (R0, t0) — and, with ``dual_init``, from the keyframe
    pose (R1, t1) too, keeping the better — then the projective rescue and
    a short re-refine. With ``kf_min_flow > 0`` it also returns the median
    displacement of the matched keyframe features (normalized units; 0.0
    otherwise) for the flow-driven keyframe rule; with ``ground_prior`` the
    ground-plane height observation (vo_core.ground_height_obs; 0.0
    otherwise). Returns device tensors (R, t, n_inliers, idx, n_valid,
    uv_all, valid_b, flow, ground_h)."""
    idx = match_descriptors(desc_a, valid_a, desc_b, valid_b, ratio=ratio).index
    use = (idx >= 0) & sel_slots
    uv_all = _normalize(yx_b, K)
    uv = torch.where(use[:, None], uv_all[torch.clamp_min(idx, 0)], 0.0)
    Ra, ta, na = vo_core.pnp_dual_refine(
        X_slots, uv, use, R0, t0, R1, t1,
        iterations=iterations, huber_delta=huber_delta,
        min_track=min_track, dual_init=dual_init,
    )
    if float(rescue_radius) > 0.0:
        idx = vo_core.guided_rescue(
            desc_a, valid_a, X_slots, sel_slots, desc_b, valid_b, uv_all, idx, Ra, ta,
            radius_norm=rescue_radius, min_sim=rescue_min_cos,
        )
        use = (idx >= 0) & sel_slots
        uv = torch.where(use[:, None], uv_all[torch.clamp_min(idx, 0)], 0.0)
        Ra, ta, na = vo_core.pnp_dual_refine(
            X_slots, uv, use, Ra, ta, R1, t1,
            iterations=max(iterations // 2, 4), huber_delta=huber_delta,
            min_track=min_track, dual_init=False,
        )
    if float(kf_min_flow) > 0.0:
        flow = vo_core.median_flow(_normalize(yx_a, K), valid_a, uv_all, idx)
    else:
        flow = torch.zeros((), dtype=uv_all.dtype, device=uv_all.device)
    if ground_prior:
        ground_h = vo_core.ground_height_obs(
            X_slots, use, yx_b[torch.clamp_min(idx, 0), 0], Ra, ta, K.cy
        )
    else:
        ground_h = torch.zeros((), dtype=uv_all.dtype, device=uv_all.device)
    return Ra, ta, na, idx, valid_b.sum(), uv_all, valid_b, flow, ground_h


@precise()
def _kf_fused(
    R_pad, t_pad, X_pad, uv, mask_old, pot_mask, fixed, P1, P2, x_prev, x_new_m,
    fresh, n_room, *, iterations, huber_delta, tri_angle,
):
    """Triangulation + cheirality/bounds/ray-angle/capacity gating of the F
    candidate slots + windowed BA with the accepted candidates as extra
    columns + per-landmark mean reprojection error."""
    Xc = triangulate(P1, P2, x_prev, x_new_m)  # [F, 3]
    ok = fresh & vo_core.triangulation_gate(Xc, P1, P2, tri_angle)
    ok = ok & (torch.cumsum(ok.to(torch.int32), 0) <= n_room)
    Lp = mask_old.shape[1]
    X = torch.cat([X_pad[:Lp], torch.where(ok[:, None], Xc, 0.0)], dim=0)
    mask = torch.cat([mask_old, pot_mask & ok[None, :]], dim=1)
    problem = BAProblem(uv=uv, mask=mask, fixed_cameras=fixed, huber_delta=huber_delta)
    final, _ = bundle_adjust(BAState(R=R_pad, t=t_pad, X=X), problem, iterations=iterations)
    mean_err = vo_core.masked_mean_reproj(final, problem)
    return final.R, final.t, final.X, mean_err, ok, Xc


@precise()
def _ba_only(R_pad, t_pad, X_pad, uv, mask, fixed, *, iterations, huber_delta):
    """Windowed BA + per-landmark mean error with no candidate columns (the
    cheaper step when triangulation is skipped)."""
    problem = BAProblem(uv=uv, mask=mask, fixed_cameras=fixed, huber_delta=huber_delta)
    final, _ = bundle_adjust(BAState(R=R_pad, t=t_pad, X=X_pad), problem, iterations=iterations)
    return final.R, final.t, final.X, vo_core.masked_mean_reproj(final, problem)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def _kf_track_cache(state: VOState, kf: Keyframe):
    """Device mirror of ``kf``'s per-slot landmark positions (rebuilt when
    state.track_version moves)."""
    if kf.track_cache is None or kf.track_cache[0] != state.track_version:
        ids = kf.landmark_ids
        sel = ids >= 0
        X = np.zeros((ids.shape[0], 3), np.float32)
        X[sel] = state.landmarks[ids[sel]]
        kf.track_cache = (state.track_version, _dev(state, X), _dev(state, sel))
    return kf.track_cache[1], kf.track_cache[2]


def _match(state: VOState, fa: Features, fb: Features):
    idx = _host(match_descriptors(
        fa.desc, fa.valid, fb.desc, fb.valid, ratio=state.config.match_ratio
    ).index)
    return idx, idx >= 0


def _norm_pts(state: VOState, feats: Features) -> np.ndarray:
    """Normalized (undistorted) pixels, computed host-side."""
    K = state.config.intrinsics
    yx = _host(feats.yx).astype(np.float32)
    xy = np.stack([(yx[..., 1] - K.cx) / K.fx, (yx[..., 0] - K.cy) / K.fy], -1)
    if K.has_distortion:
        xy = undistort_normalized_np(xy, K.dist)
    return xy.astype(np.float32)


def _kf_host_cache(state: VOState, kf: Keyframe):
    if kf.host_cache is None:
        kf.host_cache = (_norm_pts(state, kf.features), _host(kf.features.valid))
    return kf.host_cache


def _diag(state: VOState, **ev) -> None:
    if state.diag is not None:
        ev.setdefault("f", state.frame_count)
        state.diag.append(ev)


def median_speed(state: VOState) -> Optional[float]:
    """Rolling-median per-frame speed over the last ``speed_prior_window``
    promotions; None below 8 samples."""
    hist = state.kf_baselines
    if len(hist) < 8:
        return None
    return float(np.median(hist[-state.config.speed_prior_window:]))


def keyframe_signature(features: Features) -> np.ndarray:
    """Global descriptor: mean of valid local descriptors, L2-normalized
    (the reference's slam.loopclosure.keyframe_signature)."""
    desc = _host(features.desc)
    valid = _host(features.valid)
    if valid.sum() == 0:
        return np.zeros(desc.shape[-1], np.float32)
    sig = desc[valid].mean(axis=0)
    n = np.linalg.norm(sig)
    return (sig / n if n > 1e-9 else sig).astype(np.float32)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _try_initialize(state: VOState, feats: Features) -> bool:
    """Two-view initialization against the current bootstrap keyframe
    (keyframes[-1]); the recovered pose and points are composed onto its
    pose (the identity for a fresh state)."""
    cfg = state.config
    kf0 = state.keyframes[-1]
    idx, valid = _match(state, kf0.features, feats)
    if valid.sum() < cfg.init_min_inliers:
        # re-seed the bootstrap keyframe with the current frame (never a
        # featureless one; replace a previous failed re-seed)
        if int(_host(feats.valid).sum()) < 16:
            return False
        _diag(state, ev="reseed")
        if len(state.keyframes) >= 2 and not (kf0.landmark_ids >= 0).any():
            state.keyframes.pop()
        n = feats.yx.shape[0]
        state.keyframes.append(
            Keyframe(state.frame_count, feats, kf0.R.copy(), kf0.t.copy(),
                     np.full(n, -1, np.int64))
        )
        return False

    x0 = _norm_pts(state, kf0.features)
    x1 = _norm_pts(state, feats)
    pts0 = x0
    pts1 = x1[np.maximum(idx, 0)]
    parallax = np.linalg.norm(pts0 - pts1, axis=-1)
    if np.median(parallax[valid]) < cfg.min_parallax:
        return False

    gen = torch.Generator(device=state.device)
    gen.manual_seed(state.frame_count)
    p0, p1, v = _dev(state, pts0), _dev(state, pts1), _dev(state, valid)
    res = ransac_essential(
        p0, p1, v, gen,
        num_hypotheses=cfg.ransac_hypotheses, inlier_threshold=cfg.ransac_threshold,
    )
    if int(res.num_inliers) < cfg.init_min_inliers:
        return False
    pose = recover_pose(res.E, p0, p1, res.inliers)
    good = _host(pose.cheirality)
    X_c0 = _host(pose.points)
    n_new = int(good.sum())
    if n_new < cfg.init_min_inliers:
        return False

    # scale-continuous re-initialization: continue the old map's scale
    s_init = 1.0
    med = median_speed(state)
    if med is not None and med > 1e-12:
        s_init = med * max(state.frame_count - kf0.index, 1)
    if cfg.ground_height_m > 0:
        # absolute anchor: the init gauge from the ground plane (map units
        # == meters from frame one), over the speed history
        h_raw = _init_ground_height(_host(kf0.features.yx)[:, 0], X_c0, good, cfg.intrinsics.cy)
        if h_raw is not None:
            s_init = cfg.ground_height_m / h_raw
    X_c0 = X_c0 * s_init
    X = (X_c0 - kf0.t) @ kf0.R  # camera-0 -> world
    _diag(state, ev="init", kf0_frame=int(kf0.index), n_inliers=n_new, scale=s_init)

    lm_ids_kf0 = kf0.landmark_ids.copy()
    feat_ids0 = np.nonzero(good)[0]
    new_ids = np.nonzero(~state.landmark_valid)[0][:n_new]
    state.landmarks[new_ids] = X[feat_ids0]
    state.landmark_valid[new_ids] = True
    state.num_landmarks = int(state.landmark_valid.sum())
    lm_ids_kf0[feat_ids0] = new_ids
    kf0.landmark_ids = lm_ids_kf0

    lm_ids = np.full(feats.yx.shape[0], -1, np.int64)
    lm_ids[idx[feat_ids0]] = new_ids
    R_rel = _host(pose.R)
    t_rel = _host(pose.t) * s_init
    R = (R_rel @ kf0.R).astype(np.float32)
    t = (R_rel @ kf0.t + t_rel).astype(np.float32)
    state.keyframes.append(
        Keyframe(state.frame_count, feats, R, t, lm_ids, fresh_ids=new_ids.astype(np.int64))
    )
    state.trajectory.append((state.frame_count, R, t))
    state.traj_ref.append(None)
    state.initialized = True
    state.track_version += 1
    state.kf_baselines.append(s_init / max(state.frame_count - kf0.index, 1))
    return True


def _init_ground_height(v, X_c0, good, cy) -> Optional[float]:
    """The bootstrap's ground height: the dominant-height cluster of the
    bottom-of-image triangulated points (as vo_core.ground_height_obs, on
    the host), None below 8 supporting points."""
    y_c = X_c0[:, 1]
    sel = good & (v > 1.25 * cy) & (y_c > 1e-3) & (X_c0[:, 2] > 1e-3)
    if sel.sum() < 8:
        return None
    pair = (np.abs(y_c[None, :] - y_c[:, None]) < 0.08 * y_c[:, None]) & sel[None, :] & sel[:, None]
    band = pair[np.argmax(pair.sum(1))]
    if band.sum() < 8:
        return None
    h_raw = float(y_c[band].mean())
    return h_raw if h_raw > 1e-9 else None


def _append_traj(state: VOState, R, t) -> None:
    """Trajectory append + relative-to-keyframe anchor (VOState.traj_ref)."""
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    state.trajectory.append((state.frame_count, R, t))
    if not state.keyframes:
        state.traj_ref.append(None)
        return
    kf = state.keyframes[-1]
    R_rel = (R @ kf.R.T).astype(np.float32)
    t_rel = (t - R_rel @ kf.t).astype(np.float32)
    prev = state.keyframes[-2] if len(state.keyframes) >= 2 else None
    if prev is not None:
        b_old = float(np.linalg.norm((-kf.R.T @ kf.t) - (-prev.R.T @ prev.t)))
        pidx = prev.index
    else:
        b_old, pidx = 0.0, -1
    state.traj_ref.append((kf.index, R_rel, t_rel, pidx, b_old))


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------


def _predict_pose(state: VOState):
    """Constant-velocity prediction: the last inter-frame motion applied to
    the latest pose; the keyframe pose when the recent trajectory is not
    finite or its motion exceeds vo_core.MAX_PRED_ROT_DEG /
    MAX_PRED_SHIFT (a bad track must not feed diverging predictions)."""
    kf = state.keyframes[-1]
    if len(state.trajectory) < 2:
        return kf.R, kf.t
    _, R1, t1 = state.trajectory[-1]
    _, R0, t0 = state.trajectory[-2]
    if not (np.isfinite(R1).all() and np.isfinite(t1).all()
            and np.isfinite(R0).all() and np.isfinite(t0).all()):
        return kf.R, kf.t
    R_rel = R1 @ R0.T
    t_rel = t1 - R_rel @ t0
    cos = np.clip(0.5 * (np.trace(R_rel) - 1.0), -1.0, 1.0)
    if (
        np.degrees(np.arccos(cos)) > vo_core.MAX_PRED_ROT_DEG
        or np.linalg.norm(t_rel) > vo_core.MAX_PRED_SHIFT
    ):
        return kf.R, kf.t
    return (R_rel @ R1).astype(np.float32), (R_rel @ t1 + t_rel).astype(np.float32)


class _Fetch:
    """Device tensors on their way to the host: on a card each is copied
    without blocking into a pinned buffer and an event marks the copies'
    end; :meth:`get` waits for that event (a no-op once the stream was
    synchronized) and returns numpy arrays. On the CPU the tensors are the
    host values already."""

    def __init__(self, tensors):
        tensors = list(tensors)
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [
                torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(a, non_blocking=True)
                for a in tensors
            ]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensors

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [_host(a) for a in self.host]


def _track_issue(state: VOState, feats: Features) -> _Fetch:
    """Launch the tracking step (match to the last keyframe, PnP, rescue)
    and start fetching its result; pair with :func:`_track_complete`. The
    split lets a server launch many streams' steps before it waits once
    (slam.vo_server)."""
    cfg = state.config
    kf = state.keyframes[-1]
    X_dev, sel_dev = _kf_track_cache(state, kf)
    Rp, tp = _predict_pose(state) if cfg.motion_model else (kf.R, kf.t)
    dual = cfg.motion_model and not (np.array_equal(Rp, kf.R) and np.array_equal(tp, kf.t))
    return _Fetch(_track_fused(
        kf.features.desc, kf.features.valid, X_dev, sel_dev, kf.features.yx,
        feats.yx, feats.desc, feats.valid, _dev(state, Rp), _dev(state, tp),
        _dev(state, kf.R), _dev(state, kf.t), cfg.intrinsics,
        ratio=cfg.match_ratio, iterations=10, huber_delta=cfg.huber_delta,
        min_track=cfg.track_min_landmarks, dual_init=dual,
        rescue_radius=cfg.rescue_radius_norm, rescue_min_cos=cfg.rescue_min_cos,
        kf_min_flow=cfg.kf_min_flow_norm, ground_prior=cfg.ground_height_m > 0,
    ))


def _track_complete(state: VOState, fetched: _Fetch):
    """Host tail of the tracking step: waits for the fetch and returns host
    values (R, t, n_tracked, idx, valid, n_valid, x_new, fvalid, flow,
    ground_h); x_new/fvalid are the frame's normalized pixels and feature
    validity, which a promotion consumes without another fetch."""
    kf = state.keyframes[-1]
    R, t, n, idx, n_valid, uv_all, valid_b, flow, ground_h = fetched.get()
    n_tracked = int(n)
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        R, t, n_tracked = kf.R.copy(), kf.t.copy(), 0
    return (
        R, t, n_tracked, idx, idx >= 0, int(n_valid),
        uv_all.astype(np.float32), valid_b, float(flow), float(ground_h),
    )


def _track(state: VOState, feats: Features):
    """Match to the last keyframe's landmark-bearing features; PnP refine.
    Returns host values (R, t, n_tracked, idx, valid, n_valid, x_new,
    fvalid, flow, ground_h)."""
    return _track_complete(state, _track_issue(state, feats))


def _track_against(state: VOState, feats: Features, kf: Keyframe):
    """PnP of ``feats`` against an arbitrary keyframe's landmarks,
    initialized from that keyframe's pose (the relocalization primitive)."""
    idx, valid = _match(state, kf.features, feats)
    use = valid & (kf.landmark_ids >= 0)
    lm_ids = np.where(use, kf.landmark_ids, -1)
    n = len(idx)
    X = np.zeros((n, 3), np.float32)
    sel = lm_ids >= 0
    X[sel] = state.landmarks[lm_ids[sel]]
    uv_all = _norm_pts(state, feats)
    uv = np.zeros((n, 2), np.float32)
    uv[sel] = uv_all[np.maximum(idx, 0)[sel]]
    R, t, inl = refine_pose(
        _dev(state, X), _dev(state, uv), _dev(state, sel),
        _dev(state, kf.R), _dev(state, kf.t),
        iterations=12, huber_delta=state.config.huber_delta,
    )
    return _host(R), _host(t), int(inl.sum()), idx, valid


def _relocalize(state: VOState, feats: Features, *, max_candidates: int = 3):
    """Tracking-loss recovery: PnP against the keyframes ranked by global
    signature; the first whose motion-only BA keeps enough inliers wins.
    Returns (R, t, n_inliers, idx, valid, kf_index) or None."""
    sig = keyframe_signature(feats)
    lm_bearing = [
        (k, kf) for k, kf in enumerate(state.keyframes) if (kf.landmark_ids >= 0).sum() >= 8
    ]
    if not lm_bearing:
        return None

    def kf_sig(kf: Keyframe) -> np.ndarray:
        if kf.signature is None:
            kf.signature = keyframe_signature(kf.features)
        return kf.signature

    ranked = sorted(lm_bearing, key=lambda e: -float(np.dot(kf_sig(e[1]), sig)))
    for k, kf in ranked[:max_candidates]:
        R, t, n_inl, idx, valid = _track_against(state, feats, kf)
        if n_inl >= max(8, state.config.track_min_landmarks // 2):
            return R, t, n_inl, idx, valid, k
    return None


# ---------------------------------------------------------------------------
# keyframes
# ---------------------------------------------------------------------------


def _kf_inherit(state: VOState, feats: Features, idx, valid, ref_kf):
    """Landmark-id inheritance from the reference keyframe:
    (kf_prev, lm_ids, fresh)."""
    kf_prev = state.keyframes[-1] if ref_kf is None else state.keyframes[ref_kf]
    lm_ids = np.full(feats.yx.shape[0], -1, np.int64)
    prev_has = kf_prev.landmark_ids >= 0
    inherit = valid & prev_has
    lm_ids[np.maximum(idx, 0)[inherit]] = kf_prev.landmark_ids[inherit]
    return kf_prev, lm_ids, valid & ~prev_has


def _kf_append(state: VOState, feats, R, t, lm_ids, x_new, fvalid=None):
    kf_new = Keyframe(state.frame_count, feats, R, t, lm_ids)
    if fvalid is None:
        fvalid = _host(feats.valid)
    kf_new.host_cache = (x_new, fvalid)
    state.keyframes.append(kf_new)


def _add_keyframe(
    state: VOState, feats: Features, R, t, idx, valid, ref_kf=None, x_new=None, fvalid=None,
):
    """Promote the current frame: inherit landmark ids, triangulate new
    landmarks, run windowed BA (one device step + one fetch), register the
    accepted candidates, write back, and cull landmarks the optimizer could
    not reconcile."""
    if x_new is None:
        x_new = _norm_pts(state, feats)
    _kf_fused_complete(
        state, *_kf_fused_issue(state, feats, R, t, idx, valid, ref_kf, x_new, fvalid)
    )


def _kf_fused_issue(state: VOState, feats: Features, R, t, idx, valid, ref_kf, x_new, fvalid=None):
    """Host assembly and launch of the keyframe step, its fetch started:
    (fetch, ctx). ``fetch`` is None when neither BA nor triangulation has
    enough support; :func:`_kf_fused_complete` then appends the keyframe
    with inherited ids only. The grid: cameras padded to ``cfg.window``
    (the new frame is the last real camera), landmark columns = [the
    window's landmarks | F candidate slots], F the feature capacity; the
    triangulation gate masks the candidates on the device."""
    cfg = state.config
    kf_prev, lm_ids, fresh = _kf_inherit(state, feats, idx, valid, ref_kf)
    skip_tri = fresh.sum() < 8 or state.num_landmarks >= cfg.max_landmarks
    fresh_eff = fresh & (not skip_tri)

    window = state.keyframes[-(cfg.window - 1):] if cfg.window > 1 else []
    C = len(window) + 1
    c_new = C - 1
    id_arrays = [kf.landmark_ids[kf.landmark_ids >= 0] for kf in window]
    id_arrays.append(lm_ids[lm_ids >= 0])
    lm_set = np.unique(np.concatenate(id_arrays))
    if lm_set.size < 8 and skip_tri:
        return None, (feats, R, t, lm_ids, x_new, fvalid)
    if lm_set.size > MAX_BA_LANDMARKS:
        # keep the most-observed landmarks (ties: lowest id)
        counts = np.zeros(lm_set.size, np.int64)
        for kf in window:
            counts += np.isin(lm_set, kf.landmark_ids[kf.landmark_ids >= 0])
        counts += np.isin(lm_set, lm_ids[lm_ids >= 0])
        order = np.argsort(-counts, kind="stable")[:MAX_BA_LANDMARKS]
        lm_set = np.sort(lm_set[order])
    L = lm_set.size
    Cp = cfg.window
    F = fresh.shape[0]

    uv = np.zeros((Cp, L + F, 2), np.float32)
    mask_old = np.zeros((Cp, L), bool)
    for c, kf in enumerate(window):
        x, fv = _kf_host_cache(state, kf)
        sel = (kf.landmark_ids >= 0) & fv & np.isin(kf.landmark_ids, lm_set)
        loc = np.searchsorted(lm_set, kf.landmark_ids[sel])
        uv[c, loc] = x[sel]
        mask_old[c, loc] = True
    sel_new = (lm_ids >= 0) & np.isin(lm_ids, lm_set)
    loc = np.searchsorted(lm_set, lm_ids[sel_new])
    uv[c_new, loc] = x_new[sel_new]
    mask_old[c_new, loc] = True

    # candidate columns: observed by kf_prev (when in the window) and the
    # new frame; masked on the device by the triangulation gate
    x_prev_all = _kf_host_cache(state, kf_prev)[0]
    x_new_all = x_new[np.maximum(idx, 0)]
    pot = np.zeros((Cp, F), bool)
    uv[c_new, L:] = x_new_all
    pot[c_new] = fresh_eff
    for c, kf in enumerate(window):
        if kf is kf_prev:
            uv[c, L:] = x_prev_all
            pot[c] = fresh_eff
            break

    fixed = np.ones(Cp, bool)  # padding cameras held fixed
    fixed[:C] = False
    fixed[0] = True
    if Cp > 1:
        fixed[1] = True  # monocular gauge: the second camera pins scale

    R_pad = np.broadcast_to(np.eye(3, dtype=np.float32), (Cp, 3, 3)).copy()
    t_pad = np.zeros((Cp, 3), np.float32)
    if window:
        R_pad[: C - 1] = np.stack([kf.R for kf in window])
        t_pad[: C - 1] = np.stack([kf.t for kf in window])
    R_pad[c_new] = np.asarray(R, np.float32)
    t_pad[c_new] = np.asarray(t, np.float32)
    X_pad = state.landmarks[lm_set].astype(np.float32)

    d = lambda a: _dev(state, a)  # noqa: E731
    if skip_tri:
        fetch = _Fetch(_ba_only(
            d(R_pad), d(t_pad), d(X_pad), d(uv[:, :L]), d(mask_old), d(fixed),
            iterations=cfg.ba_iterations, huber_delta=cfg.huber_delta,
        ))
    else:
        P1 = np.concatenate([kf_prev.R, kf_prev.t[:, None]], 1).astype(np.float32)
        P2 = np.concatenate(
            [np.asarray(R, np.float32), np.asarray(t, np.float32)[:, None]], 1
        )
        fetch = _Fetch(_kf_fused(
            d(R_pad), d(t_pad), d(X_pad), d(uv), d(mask_old), d(pot), d(fixed),
            d(P1), d(P2), d(x_prev_all), d(x_new_all), d(fresh_eff),
            cfg.max_landmarks - state.num_landmarks,
            iterations=cfg.ba_iterations, huber_delta=cfg.huber_delta,
            tri_angle=cfg.tri_min_ray_angle_deg,
        ))
    ctx = (feats, R, t, lm_ids, x_new, fvalid, window, lm_set, L, kf_prev, idx, skip_tri)
    return fetch, ctx


def _kf_fused_complete(state: VOState, fetch: Optional[_Fetch], ctx) -> None:
    """Host tail of the keyframe step: register the fetched candidates,
    append the keyframe, write back the BA results and cull landmarks the
    optimizer could not reconcile. When the window carried < 8 landmarks
    the BA is under-constrained: candidates register from the raw
    triangulation and poses and old landmarks stay."""
    cfg = state.config
    feats, R, t, lm_ids, x_new, fvalid = ctx[:6]
    if fetch is None:
        _kf_append(state, feats, R, t, lm_ids, x_new, fvalid)
        return
    window, lm_set, L, kf_prev, idx, skip_tri = ctx[6:]
    if skip_tri:
        Rs, ts, X, mean_err = fetch.get()
        ok, Xc = np.zeros(0, bool), None
    else:
        Rs, ts, X, mean_err, ok, Xc = fetch.get()
    ba_valid = lm_set.size >= 8

    # register accepted candidates (ids in slot order == device cumsum rank)
    ok_slots = np.nonzero(ok)[0]
    new_ids = np.empty(0, np.int64)
    if ok_slots.size:
        new_ids = np.nonzero(~state.landmark_valid)[0][: ok_slots.size]
        src = X[L + ok_slots] if ba_valid else Xc[ok_slots]
        state.landmarks[new_ids] = src
        state.landmark_valid[new_ids] = True
        state.num_landmarks = int(state.landmark_valid.sum())
        kf_prev.landmark_ids[ok_slots] = new_ids
        lm_ids[np.maximum(idx, 0)[ok_slots]] = new_ids

    _kf_append(state, feats, R, t, lm_ids, x_new, fvalid)
    state.keyframes[-1].fresh_ids = new_ids.astype(np.int64)
    if not ba_valid:
        # under-constrained window: keep the raw triangulation, leave poses
        state.track_version += 1
        return
    for c, kf in enumerate(window + [state.keyframes[-1]]):
        kf.R, kf.t = Rs[c], ts[c]
    state.landmarks[lm_set] = X[:L]

    bar = vo_core.cull_bar(cfg.huber_delta)
    bad = set(int(g) for g in lm_set[np.nonzero(mean_err[:L] > bar)[0]])
    if ok_slots.size:
        bad |= set(int(g) for g in new_ids[mean_err[L + ok_slots] > bar])
    if bad:
        bad_l = list(bad)
        state.landmark_valid[bad_l] = False
        for kf in state.keyframes:
            kf.landmark_ids[np.isin(kf.landmark_ids, bad_l)] = -1
    state.track_version += 1


def _decide_keyframe(state: VOState, feats, R, t, n_tracked, idx, valid, n_valid, flow=0.0):
    """Relocalization fallback + trajectory append + keyframe decision.
    Returns (R, t, idx, valid, ref_kf) when the frame should become a
    keyframe, else None."""
    ref_kf = None
    if n_tracked < 8:
        reloc = _relocalize(state, feats)
        if reloc is not None:
            R, t, n_tracked, idx, valid, ref_kf = reloc
            _diag(state, ev="reloc", ref_kf=int(ref_kf), n=int(n_tracked))
    if n_tracked < 8:
        # lost: hold the last keyframe pose; re-bootstrap after a streak
        state.lost_streak += 1
        _diag(state, ev="lost", n=int(n_tracked), streak=state.lost_streak)
        kf = state.keyframes[-1]
        _append_traj(state, kf.R, kf.t)
        if state.lost_streak >= REBOOT_AFTER_LOST and n_valid >= 16:
            _rebootstrap(state, feats)
        return None
    state.lost_streak = 0
    _append_traj(state, R, t)

    gap = state.frame_count - state.keyframes[-1].index
    flow_thresh = state.config.kf_min_flow_norm
    needs_kf = (
        n_tracked < state.config.track_min_landmarks
        or gap >= state.config.kf_max_gap
        or (flow_thresh > 0.0 and flow > flow_thresh)
    )
    if needs_kf and n_valid >= 16:  # never promote a featureless frame
        return R, t, idx, valid, ref_kf
    return None


def _rebootstrap(state: VOState, feats: Features) -> None:
    """Restart the map after persistent tracking loss: a fresh bootstrap
    keyframe at the last keyframe pose, back to two-view initialization."""
    kf = state.keyframes[-1]
    state.keyframes.append(
        Keyframe(state.frame_count, feats, kf.R.copy(), kf.t.copy(),
                 np.full(feats.yx.shape[0], -1, np.int64))
    )
    state.initialized = False
    state.lost_streak = 0
    state.track_version += 1
    _diag(state, ev="reboot", n_kf=len(state.keyframes))


def apply_speed_prior(state: VOState, fresh_ids=None) -> bool:
    """Record the newest keyframe's per-frame speed; with the kinematic band
    on (VOConfig.speed_prior_band hi > 0, and no ground prior), first clamp
    its baseline into [lo, hi] x rolling-median speed x frame gap. Returns
    True when a correction applied.

    On violation the promotion increment is rescaled about the previous
    keyframe's center: the new pose moves to the clamped baseline and
    ``fresh_ids`` (this promotion's fresh triangulations) rescale with it;
    older landmarks keep their positions."""
    if len(state.keyframes) < 2:
        return False
    lo, hi = state.config.speed_prior_band
    if state.config.ground_height_m > 0:
        # the ground prior is the absolute reference; the band is relative
        # (it encodes drifted scale) and would fight its corrections
        hi = 0.0
    kf, prev = state.keyframes[-1], state.keyframes[-2]
    gap = max(kf.index - prev.index, 1)
    c_prev = -prev.R.T @ prev.t
    c_new = -kf.R.T @ kf.t
    b = float(np.linalg.norm(c_new - c_prev))
    med = median_speed(state)
    corrected = False
    if hi > 0 and med is not None:
        b_cl = float(np.clip(b, lo * med * gap, hi * med * gap))
        if b > 1e-12 and abs(b_cl - b) > 1e-9 * med:
            r = b_cl / b
            c_corr = c_prev + (c_new - c_prev) * r
            kf.t = (-kf.R @ c_corr).astype(np.float32)
            if fresh_ids is not None and len(fresh_ids):
                X = state.landmarks[fresh_ids]
                state.landmarks[fresh_ids] = (c_prev + (X - c_prev) * r).astype(np.float32)
            state.trajectory[-1] = (state.frame_count, kf.R.copy(), kf.t.copy())
            state.track_version += 1
            _diag(state, ev="speed_prior", b=b, b_clamped=b_cl, gap=gap)
            b = b_cl
            corrected = True
    hist = state.kf_baselines
    hist.append(b / gap)
    if len(hist) > 4 * state.config.speed_prior_window:
        del hist[: -2 * state.config.speed_prior_window]
    return corrected


def ground_violation(config: VOConfig, h_obs: float) -> bool:
    """Does a height observation warrant a ground-prior correction?"""
    target = config.ground_height_m
    if target <= 0.0 or h_obs <= 1e-9:
        return False
    return abs(np.log(target / float(h_obs))) >= vo_core.GROUND_DEADBAND


def smoothed_ground(state: VOState, h_obs: float) -> float:
    """Record a ground-height observation; return the rolling median of the
    last 3, which the controller corrects against."""
    state.ground_hist.append(float(h_obs))
    del state.ground_hist[:-9]
    return float(np.median(state.ground_hist[-3:]))


def ground_correction_ratio(config: VOConfig, h_sm: float):
    """The control law: smoothed height -> the per-promotion correction
    ratio r (a similarity about the newest camera center), or None inside
    the deadband. Proportional on the log error with gain GROUND_GAIN,
    capped at GROUND_MAX_STEP (GROUND_MAX_STEP_FAR while far)."""
    target = config.ground_height_m
    if target <= 0.0 or h_sm <= 1e-9:
        return None
    e = float(np.log(target / h_sm))
    if abs(e) < vo_core.GROUND_DEADBAND:
        return None
    cap = vo_core.GROUND_MAX_STEP_FAR if abs(e) > vo_core.GROUND_FAR else vo_core.GROUND_MAX_STEP
    return float(np.exp(np.clip(vo_core.GROUND_GAIN * e, -cap, cap)))


def apply_ground_prior(state: VOState, h_obs: float) -> bool:
    """Hold the map scale to the ground plane (VOConfig.ground_height_m):
    when the smoothed height observation leaves the deadband, rescale the
    window keyframes and every live landmark about the newest camera center
    by ground_correction_ratio. A global similarity is a gauge transform of
    the reprojection objective, so windowed BA cannot fight it; keyframes
    outside the window keep their at-time poses (corrections do not
    rewrite history). Returns True when a correction applied."""
    target = state.config.ground_height_m
    if target <= 0.0 or h_obs <= 1e-9 or not state.keyframes:
        return False
    r = ground_correction_ratio(state.config, smoothed_ground(state, h_obs))
    if r is None:
        return False
    kf = state.keyframes[-1]
    c0 = -kf.R.T @ kf.t
    for k in state.keyframes[-state.config.window:]:
        c = c0 + ((-k.R.T @ k.t) - c0) * r
        k.t = (-k.R @ c).astype(np.float32)
    live = state.landmark_valid
    state.landmarks[live] = (c0 + (state.landmarks[live] - c0) * r).astype(np.float32)
    state.track_version += 1
    state.trajectory[-1] = (state.frame_count, kf.R.copy(), kf.t.copy())
    _diag(state, ev="ground", h=float(h_obs), r=r)
    return True


def _fresh_ids_of_last_kf(state: VOState) -> np.ndarray:
    """This promotion's fresh triangulations (Keyframe.fresh_ids, recorded
    at registration: they also enter the previous keyframe's table, so no
    later recomputation can find them)."""
    ids = state.keyframes[-1].fresh_ids
    return ids if ids is not None else np.empty(0, np.int64)


def _keyframe_epilogue(state: VOState, ground_h: float = 0.0) -> None:
    """After a keyframe's windowed BA: the ground prior, the speed prior,
    loop closure, and the trajectory entry of the new keyframe."""
    cfg = state.config
    if cfg.ground_height_m > 0 and ground_h > 0:
        # absolute scale first, so the speed prior records corrected speeds
        apply_ground_prior(state, ground_h)
    if cfg.speed_prior_band[1] > 0:
        apply_speed_prior(state, fresh_ids=_fresh_ids_of_last_kf(state))
    else:
        apply_speed_prior(state)  # record only: feeds scale-continuous init
    if cfg.loop_closure:
        from cvsteer_tpu_torch.slam.loopclosure import close_loops, close_loops_sim3

        closer = close_loops_sim3 if cfg.loop_closure_sim3 else close_loops
        t0 = time.perf_counter()
        n_closed = closer(
            state, min_gap=cfg.loop_min_gap, min_inliers=cfg.loop_min_inliers,
            huber_delta=cfg.loop_robust_delta,
            signature_threshold=cfg.loop_signature_threshold,
        )
        _diag(state, ev="closure", accepted=int(n_closed or 0), K=len(state.keyframes),
              solve_ms=round((time.perf_counter() - t0) * 1e3, 2))
        state.track_version += 1  # a closure may move poses and landmarks
    kf = state.keyframes[-1]
    state.trajectory[-1] = (state.frame_count, kf.R.copy(), kf.t.copy())
    if state.traj_ref:
        state.traj_ref[-1] = None  # keyframe entry: anchored to itself


def _post_track(state: VOState, feats, R, t, n_tracked, idx, valid, n_valid,
                x_new=None, fvalid=None, flow=0.0, ground_h=0.0) -> VOState:
    """Everything after the tracking fetch: relocalization fallback,
    trajectory append, keyframe promotion and its epilogue."""
    req = _decide_keyframe(state, feats, R, t, n_tracked, idx, valid, n_valid, flow=flow)
    if req is not None:
        R2, t2, idx2, valid2, ref_kf = req
        with _span(state, "keyframe"):
            _add_keyframe(state, feats, R2, t2, idx2, valid2, ref_kf=ref_kf,
                          x_new=x_new, fvalid=fvalid)
            _keyframe_epilogue(state, ground_h=ground_h)
        _diag(state, ev="kf", n_kf=len(state.keyframes), n_tracked=int(n_tracked))
    state.frame_count += 1
    return state


def process_frame(state: VOState, feats: Features) -> VOState:
    """Advance VO by one frame of features (tensors on state.device)."""
    if not state.keyframes:
        n = feats.yx.shape[0]
        eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        state.keyframes.append(
            Keyframe(state.frame_count, feats, eye, zero, np.full(n, -1, np.int64))
        )
        state.trajectory.append((state.frame_count, eye.copy(), zero.copy()))
        state.traj_ref.append(None)
        state.frame_count += 1
        return state

    if not state.initialized:
        with _span(state, "init"):
            ok = _try_initialize(state, feats)
        if not ok:
            kf = state.keyframes[-1]
            _append_traj(state, kf.R, kf.t)
        state.frame_count += 1
        return state

    with _span(state, "track"):
        tracked = _track(state, feats)
    return _post_track(state, feats, *tracked)


def finalize(state: VOState) -> VOState:
    """Propagate the latest keyframe refinements into the trajectory:
    keyframe entries take their keyframes' final poses, the others are
    re-anchored on their reference keyframe with the local baseline
    ratio."""
    by_frame = {kf.index: kf for kf in state.keyframes}
    refs = state.traj_ref
    for i, (f, R, t) in enumerate(state.trajectory):
        if f in by_frame:
            kf = by_frame[f]
            state.trajectory[i] = (f, kf.R.copy(), kf.t.copy())
            continue
        if i < len(refs) and refs[i] is not None:
            ref, R_rel, t_rel, pidx, b_old = refs[i]
            kf = by_frame.get(ref)
            if kf is None:
                continue
            s = 1.0
            pkf = by_frame.get(pidx)
            if pkf is not None and b_old > 1e-9:
                c0 = -kf.R.T @ kf.t
                c1 = -pkf.R.T @ pkf.t
                s = float(np.clip(np.linalg.norm(c0 - c1) / b_old, 1e-3, 1e3))
            state.trajectory[i] = (
                f, (R_rel @ kf.R).astype(np.float32),
                (R_rel @ kf.t + s * t_rel).astype(np.float32),
            )
    return state


def image_features(state: VOState, image) -> Features:
    """Features of ``image [H, W]`` (numpy or tensor, 0..255 scale; uint8
    is cast on the device) on state.device, timed as the "features" span."""
    with _span(state, "features"):
        img = torch.as_tensor(image).to(state.device).to(torch.float32)
        return extract_features(img, cfg=state.config.frontend)


def process_image(state: VOState, image) -> VOState:
    """Extract features from ``image [H, W]`` and advance VO by one frame."""
    return process_frame(state, image_features(state, image))

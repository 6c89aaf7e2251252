"""Loop-closure detection and pose-graph correction for VO (twin of
cvsteer_tpu.slam.loopclosure).

Candidate keyframes are found by global descriptor similarity (the mean
phase descriptor per keyframe), verified geometrically with the two-view
RANSAC pipeline, and accepted closures become pose-graph edges. The graph
(odometry chain + closures) is optimized with slam.posegraph (SE(3)) or
slam.posegraph_sim3 (Sim(3), scale-drift aware) on the state's device, and
the corrected keyframe poses and landmarks are written back to the host
mirror.

A monocular closure edge's translation has unknown scale: the SE(3) path
rescales it by the map's depth ratio (or the current baseline), the Sim(3)
path measures the relative map scale from both sides' depth ratios.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.slam import vo_core
from cvsteer_tpu_torch.slam.posegraph import PoseGraph, Poses, edge_residuals, optimize_pose_graph
from cvsteer_tpu_torch.slam.posegraph_sim3 import Sim3Graph, optimize_pose_graph_sim3
from cvsteer_tpu_torch.slam.posegraph_sim3 import edge_residuals as sim3_edge_residuals
from cvsteer_tpu_torch.slam.sim3 import Sim3
from cvsteer_tpu_torch.slam.twoview import TwoViewResult, two_view_pose_from_features
from cvsteer_tpu_torch.slam.vo import VOState, _diag, _host
from cvsteer_tpu_torch.slam.vo import keyframe_signature  # noqa: F401  (the reference's name here)

#: keyframes per closure-gate region bucket (closure_gate and the rejection
#: cooldown): candidates within one bucket count as the same place
GATE_REGION_KF = 8


class LoopClosure(NamedTuple):
    i: int  # older keyframe index (into state.keyframes)
    j: int  # newer keyframe index
    R: np.ndarray  # relative rotation camera-i -> camera-j
    t: np.ndarray  # relative translation, rescaled to trajectory units
    num_inliers: int
    result: object = None  # the verifying TwoViewResult (numpy, unit baseline)


class SignatureIndex:
    """Device-resident keyframe signature index for closure detection: one
    ``[capacity, D]`` tensor, new keyframes added by a row write, detection
    one matvec + top-k (vo_core.closure_candidates). Keyframes beyond
    ``capacity`` are not indexed."""

    def __init__(self, dim: int, capacity: int = 4096, device="cpu"):
        self.capacity = int(capacity)
        self.sigs = torch.zeros((self.capacity, dim), dtype=torch.float32, device=device)
        self.n = 0  # keyframes indexed so far (== next row)

    def extend(self, keyframes) -> None:
        """Index ``keyframes[self.n:]``. Past ``capacity`` keyframes are not
        indexed (revisits of late regions go undetected): warn once when
        the run crosses it (raise VOConfig.loop_sig_capacity)."""
        if len(keyframes) > self.capacity and self.n <= self.capacity:
            warnings.warn(
                f"SignatureIndex full: {len(keyframes)} keyframes > capacity "
                f"{self.capacity}; keyframes beyond capacity are not indexed for "
                "closure detection (loops onto them will not be found). Raise "
                "VOConfig.loop_sig_capacity.",
                RuntimeWarning,
                stacklevel=3,
            )
        for k in range(self.n, min(len(keyframes), self.capacity)):
            f = keyframes[k].features
            self.sigs[k] = vo_core.signature_device(f.desc, f.valid)
        self.n = len(keyframes)

    def query(self, features, *, min_gap: int, top: int):
        """(idx [top], score [top]) numpy: the newest keyframe (row n - 1)
        against rows [0, (n - 1) - min_gap]; other rows score -inf."""
        idx, score = vo_core.closure_candidates(
            self.sigs, vo_core.signature_device(features.desc, features.valid),
            self.n - 1, min_gap=min_gap, top=top,
        )
        return _host(idx), _host(score)


def state_signature_index(state: VOState) -> SignatureIndex:
    """The state's lazily built and extended signature index."""
    idx = getattr(state, "sig_index", None)
    if idx is None:
        D = int(state.keyframes[-1].features.desc.shape[-1])
        idx = SignatureIndex(D, capacity=state.config.loop_sig_capacity, device=state.device)
        state.sig_index = idx
    idx.extend(state.keyframes)
    return idx


def closure_gate(state: VOState, cand_idx, scores, *, min_gap: int, threshold: float) -> bool:
    """Cheap pre-event gate on fetched candidates: should this promotion pay
    a closure event? (1) some candidate clears ``threshold`` at ``min_gap``
    keyframes of separation; (2) the top candidate points at the same
    region (GATE_REGION_KF buckets) for VOConfig.loop_consistency
    consecutive promotions; (3) the region is not in a rejection cooldown.
    Mutates state.loop_streak; find_loop_closures sets the cooldowns."""
    j = len(state.keyframes) - 1
    cand = [int(i) for i, s in zip(cand_idx, scores) if s >= threshold and 0 <= i <= j - min_gap]
    if not cand:
        state.loop_streak = (-1, 0)
        return False
    region = cand[0] // GATE_REGION_KF
    last, streak = state.loop_streak
    streak = streak + 1 if region == last else 1
    state.loop_streak = (region, streak)
    if streak < state.config.loop_consistency:
        return False
    return j > state.loop_reject_until.get(region, -1)


def _verify(state: VOState, cand: List[int], j: int, thresh_px: float) -> List[TwoViewResult]:
    """Two-view verification of each candidate keyframe against keyframe
    ``j``, RANSAC drawing from one generator seeded with ``j``; results on
    the host (numpy)."""
    kfs = state.keyframes
    cfg = state.config
    gen = torch.Generator(device=state.device).manual_seed(j)
    out = []
    for i in cand:
        res = two_view_pose_from_features(
            kfs[i].features, kfs[j].features, cfg.intrinsics,
            match_ratio=cfg.match_ratio, ransac_hypotheses=cfg.ransac_hypotheses,
            ransac_threshold_px=thresh_px, generator=gen,
        )
        out.append(TwoViewResult(*(_host(a) for a in res)))
    return out


def find_loop_closures(
    state: VOState,
    *,
    min_gap: int = 6,
    signature_threshold: float = 0.75,
    min_inliers: int = 25,
    max_candidates: int = 3,
    candidates=None,
) -> List[LoopClosure]:
    """Verified closures between the newest keyframe and older ones.

    ``candidates`` (idx, score) normally come from the device engine's
    step; without them the state's :class:`SignatureIndex` answers and
    :func:`closure_gate` decides whether to verify. A region whose
    candidates all fail verification enters the rejection cooldown
    (VOConfig.loop_reject_cooldown)."""
    kfs = state.keyframes
    j = len(kfs) - 1
    if j < min_gap:
        return []
    if candidates is None:
        cand_idx, scores = state_signature_index(state).query(
            kfs[j].features, min_gap=min_gap, top=max_candidates
        )
        if not closure_gate(state, cand_idx, scores, min_gap=min_gap,
                            threshold=signature_threshold):
            return []
    else:
        cand_idx, scores = (np.asarray(a) for a in candidates)
    cand = [
        int(i) for i, s in zip(cand_idx[:max_candidates], scores)
        if s >= signature_threshold and 0 <= i <= j - min_gap
    ]
    if not cand:
        return []
    closures: List[LoopClosure] = []
    for i, res in zip(cand, _verify(state, cand, j, ransac_threshold_px(state))):
        n_inl = int(res.num_inliers)
        if n_inl < min_inliers:
            continue
        t = res.t * _closure_scale(state, i, res)
        closures.append(LoopClosure(i=i, j=j, R=res.R, t=t, num_inliers=n_inl, result=res))
    if not closures:
        cd = state.config.loop_reject_cooldown
        if cd:
            for r in set(c // GATE_REGION_KF for c in cand):
                state.loop_reject_until[r] = j + cd
    return closures


def ransac_threshold_px(state: VOState) -> float:
    """The configured Sampson threshold (normalized units) in pixels."""
    K = state.config.intrinsics
    return float(np.sqrt(state.config.ransac_threshold)) * 0.5 * (K.fx + K.fy)


def _side_scale(state: VOState, k: int, depths_tri: np.ndarray) -> Optional[float]:
    """Scale of keyframe k's local map relative to the closure's unit-baseline
    triangulation: median(map depth) / median(triangulated depth)."""
    kf = state.keyframes[k]
    lm = kf.landmark_ids[kf.landmark_ids >= 0]
    if lm.size < 10 or depths_tri.size < 10:
        return None
    d_map = (state.landmarks[lm] @ kf.R.T + kf.t)[:, 2]
    d_map = d_map[d_map > 1e-3]
    d_tri = depths_tri[depths_tri > 1e-6]
    if d_map.size < 10 or d_tri.size < 10:
        return None
    return float(np.median(d_map) / np.median(d_tri))


def closure_scales(state: VOState, c_i: int, c_j: int, res) -> Tuple[Optional[float], Optional[float]]:
    """(s_i, s_j): each keyframe's local-map scale against the closure's
    unit-baseline triangulation; s_j / s_i is the relative scale drift."""
    tri = res.points[res.point_valid]
    if tri.shape[0] < 10:
        return None, None
    s_i = _side_scale(state, c_i, tri[:, 2])
    tri_j = tri @ res.R.T + res.t  # the same points from camera j
    return s_i, _side_scale(state, c_j, tri_j[:, 2])


def sim3_closure_edge(state: VOState, c: LoopClosure):
    """The Sim(3) edge (s_z, R_z, t_z) of a verified closure:
    s_z = s_j / s_i, R_z = R, t_z = s_j t_unit (map units on both sides).
    None when the newer side lacks landmark depth support; relative scale 1
    when only the older side lacks it.

    Ported as the reference has it, with its open finding (ADVICE.md,
    loopclosure.py:416): an out-of-band s_z is replaced by 1 but t_z keeps
    s_j, so when the broken side is s_j the translation fed to the solver
    is wrong too."""
    res = c.result
    if res is None:
        return None
    s_i, s_j = closure_scales(state, c.i, c.j, res)
    if s_j is None or s_j <= 0:
        return None
    if s_i is None or s_i <= 0:
        # the older side lost its landmark links (slot reuse): the newer
        # side still anchors the baseline, and relative scale 1 is the prior
        return 1.0, res.R, res.t * s_j
    s_z = s_j / s_i
    lo, hi = state.config.loop_scale_band
    if lo > 0 and not (lo <= s_z <= hi):
        # implausible measured relative scale (mixed-epoch depth support or
        # a near-zero-baseline revisit): unit-scale prior instead
        _diag(state, ev="closure_edge_clamp", s_z=round(float(s_z), 4))
        s_z = 1.0
    return s_z, res.R, res.t * s_j


def _closure_scale(state: VOState, i: int, res) -> float:
    """Metric scale of a closure's unit translation: the map's median
    landmark depth in keyframe i over the closure's triangulated median
    depth; else the current baseline between keyframe i and the newest."""
    kf = state.keyframes[i]
    lm = kf.landmark_ids[kf.landmark_ids >= 0]
    tri = res.points[res.point_valid]
    if lm.size >= 10 and tri.shape[0] >= 10:
        depth_map = (state.landmarks[lm] @ kf.R.T + kf.t)[:, 2]
        depth_map = depth_map[depth_map > 1e-3]
        depth_tri = tri[:, 2]
        depth_tri = depth_tri[depth_tri > 1e-6]
        if depth_map.size >= 10 and depth_tri.size >= 10:
            return float(np.median(depth_map) / np.median(depth_tri))
    ci = -kf.R.T @ kf.t
    kj = state.keyframes[-1]
    cj = -kj.R.T @ kj.t
    return max(float(np.linalg.norm(cj - ci)), 1e-6)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_pose_graph(poses, graph):
    """Pad poses and edges to power-of-two buckets, as the reference does:
    padding poses are fixed identities no edge touches, padding edges are
    weight-0 identity self-loops at pose 0 (zero residual, masked). The
    solvers see the reference's shapes, so both packages optimize the same
    systems. Handles (Poses, PoseGraph) and (Sim3, Sim3Graph). Returns
    (poses, graph, P_real)."""
    P = poses.R.shape[0]
    E = graph.i.shape[0]
    Pp, Ep = _bucket(P), _bucket(E)
    if Pp == P and Ep == E:
        return poses, graph, P
    pp, ep = Pp - P, Ep - E
    dev = poses.R.device

    def eye(n):
        return torch.eye(3, device=dev).expand(n, 3, 3)

    pkw = dict(
        R=torch.cat([poses.R, eye(pp)]),
        t=torch.cat([poses.t, torch.zeros((pp, 3), device=dev)]),
    )
    if hasattr(poses, "s"):
        pkw["s"] = torch.cat([poses.s, torch.ones(pp, device=dev)])
    gkw = dict(
        i=torch.cat([graph.i, graph.i.new_zeros(ep)]),
        j=torch.cat([graph.j, graph.j.new_zeros(ep)]),
        R_z=torch.cat([graph.R_z, eye(ep)]),
        t_z=torch.cat([graph.t_z, torch.zeros((ep, 3), device=dev)]),
        weight=torch.cat([graph.weight, torch.zeros(ep, device=dev)]),
        fixed=torch.cat([graph.fixed, torch.ones(pp, dtype=torch.bool, device=dev)]),
    )
    if hasattr(graph, "s_z"):
        gkw["s_z"] = torch.cat([graph.s_z, torch.ones(ep, device=dev)])
    return type(poses)(**pkw), type(graph)(**gkw), P


def _dev(state: VOState, a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=state.device)


def build_keyframe_graph(state: VOState, closures: List[LoopClosure], *,
                         closure_weight: float = 5.0) -> Tuple[Poses, PoseGraph]:
    """Odometry chain (from the current keyframe poses) + closure edges."""
    kfs = state.keyframes
    P = len(kfs)
    poses = Poses(R=_dev(state, np.stack([kf.R for kf in kfs])),
                  t=_dev(state, np.stack([kf.t for kf in kfs])))
    ii, jj, Rz, tz, w = [], [], [], [], []
    for k in range(P - 1):
        Rrel = kfs[k + 1].R @ kfs[k].R.T
        ii.append(k)
        jj.append(k + 1)
        Rz.append(Rrel)
        tz.append(kfs[k + 1].t - Rrel @ kfs[k].t)
        w.append(1.0)
    for c in closures:
        ii.append(c.i)
        jj.append(c.j)
        Rz.append(c.R)
        tz.append(c.t)
        w.append(closure_weight)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    graph = PoseGraph(
        i=_dev(state, ii, torch.int32), j=_dev(state, jj, torch.int32),
        R_z=_dev(state, np.stack(Rz)), t_z=_dev(state, np.stack(tz)),
        weight=_dev(state, w), fixed=_dev(state, fixed, torch.bool),
    )
    return poses, graph


def _prune(solve, residuals, n_odo: int, n_clo: int, w0: np.ndarray, max_closure_residual: float):
    """The false-positive loop shared by both closers: solve with the active
    closures (dropped ones masked to weight 0, so the graph keeps one
    shape), then drop every closure whose residual stays at or above the
    bar, or, when the odometry chain had to bend past 3x the bar with no
    closure at fault, the active closure with the largest residual; until
    the solve is consistent or no closure is left. Returns (active,
    solution, closure residuals, largest odometry residual); solution None
    when ``solve`` gave up."""
    odo_bound = 3.0 * max_closure_residual
    active = np.ones(n_clo, bool)
    opt = clo_res = None
    odo_max = 0.0
    while active.any():
        w = w0.copy()
        w[n_odo: n_odo + n_clo][~active] = 0.0
        opt = solve(w)
        if opt is None:
            return active, None, clo_res, odo_max
        res = np.linalg.norm(residuals(opt, w), axis=-1)
        odo_res, clo_res = res[:n_odo], res[n_odo: n_odo + n_clo]
        odo_max = float(odo_res.max()) if n_odo else 0.0
        bad = (clo_res >= max_closure_residual) & active
        if not bad.any() and odo_max < odo_bound:
            break
        if bad.any():
            active &= ~bad
        else:
            active[int(np.argmax(np.where(active, clo_res, -np.inf)))] = False
    return active, opt, clo_res, odo_max


def close_loops(
    state: VOState,
    *,
    min_gap: int = 6,
    min_inliers: int = 25,
    iterations: int = 15,
    closure_weight: float = 10.0,
    max_closure_residual: float = 0.1,
    dense_solver_max_poses: int = 64,
    huber_delta: float = 0.0,
    robust_kernel: str = "tukey",
    candidates=None,
    signature_threshold: float = 0.75,
) -> int:
    """Detect closures, optimize the SE(3) keyframe pose graph (dense up to
    ``dense_solver_max_poses`` keyframes, PCG beyond), write poses back.
    Returns the number of accepted closures (0 = nothing changed).

    A closure is inconsistent when its residual after a trial solve stays
    above ``max_closure_residual`` or the odometry chain bent beyond 3x
    that bound to absorb it; inconsistent closures are dropped and the
    graph re-solved. Landmarks follow their anchoring (first-observer)
    keyframe rigidly."""
    closures = find_loop_closures(
        state, min_gap=min_gap, min_inliers=min_inliers,
        candidates=candidates, signature_threshold=signature_threshold,
    )
    if not closures:
        return 0
    n_odo = len(state.keyframes) - 1
    solver = "dense" if len(state.keyframes) <= dense_solver_max_poses else "pcg"
    poses, graph0 = build_keyframe_graph(state, closures, closure_weight=closure_weight)
    poses, graph0, P_real = _pad_pose_graph(poses, graph0)

    def graph_of(w):
        return graph0._replace(weight=_dev(state, w))

    def solve(w):
        return optimize_pose_graph(
            poses, graph_of(w), iterations=iterations, solver=solver,
            huber_delta=huber_delta, robust_kernel=robust_kernel,
        )[0]

    active, opt, _, _ = _prune(
        solve, lambda o, w: _host(edge_residuals(o, graph_of(w))),
        n_odo, len(closures), _host(graph0.weight), max_closure_residual,
    )
    if not active.any():
        return 0
    old = [(kf.R.copy(), kf.t.copy()) for kf in state.keyframes]
    Rn = _host(opt.R)[:P_real]
    tn = _host(opt.t)[:P_real]
    anchor = _landmark_anchors(state)
    for k in np.unique(anchor[anchor >= 0]):
        sel = np.nonzero(anchor == k)[0]
        Ro, to = old[k]
        Xc = state.landmarks[sel] @ Ro.T + to  # camera frame (invariant)
        state.landmarks[sel] = (Xc - tn[k]) @ Rn[k]
    for k, kf in enumerate(state.keyframes):
        kf.R, kf.t = Rn[k], tn[k]
    return int(active.sum())


def _landmark_anchors(state: VOState) -> np.ndarray:
    """[capacity] first-observer keyframe index per landmark slot (-1 =
    none), sized by the slot capacity (the device engine reuses slots)."""
    n_lm = state.landmarks.shape[0]
    anchor = np.full(n_lm, -1, np.int64)
    for k in reversed(range(len(state.keyframes))):  # first observer wins
        ids = state.keyframes[k].landmark_ids
        anchor[ids[(ids >= 0) & (ids < n_lm)]] = k
    return anchor


#: most keyframes a Sim(3) solve carries; longer histories solve a skeleton
SK_MAX = 250


def close_loops_sim3(
    state: VOState,
    *,
    min_gap: int = 6,
    min_inliers: int = 25,
    iterations: int = 20,
    closure_weight: float = 10.0,
    max_closure_residual: float = 0.1,
    huber_delta: float = 0.0,
    robust_kernel: str = "tukey",
    candidates=None,
    signature_threshold: float = 0.75,
) -> int:
    """Scale-drift-aware loop closure over a Sim(3) keyframe pose graph.

    Closure edges carry the relative map scale (sim3_closure_edge),
    odometry edges scale 1; the false-positive loop is close_loops'. Above
    SK_MAX keyframes the solve runs on a skeleton (every stride-th keyframe
    plus the newest and all closure endpoints) and each skipped keyframe
    follows its skeleton predecessor's correction through its stored
    relative pose. Dense Cholesky up to 256 padded poses, PCG beyond.
    Afterwards each pose's recovered scale folds into its translation and
    its anchored landmarks move by the inverse similarity.

    Ported as the reference has it, with its open finding (ADVICE.md,
    loopclosure.py:823): the scale-sanity gate rejects the whole event
    when any node scale leaves VOConfig.loop_scale_band, instead of
    pruning the offending edge and re-solving."""
    closures = find_loop_closures(
        state, min_gap=min_gap, min_inliers=min_inliers,
        candidates=candidates, signature_threshold=signature_threshold,
    )
    if not closures:
        _diag(state, ev="closure_reject", stage="verify")
        return 0
    edges = [(c, sim3_closure_edge(state, c)) for c in closures]
    edges = [(c, e) for c, e in edges if e is not None]
    if not edges:
        _diag(state, ev="closure_reject", stage="edge_scale")
        return 0

    kfs_all = state.keyframes
    P_all = len(kfs_all)
    edges_orig = [(c.i, c.j) for c, _ in edges]
    if P_all > SK_MAX:
        stride = -(-P_all // SK_MAX)
        sk = sorted(
            set(range(0, P_all, stride)) | {P_all - 1}
            | {c.i for c in closures} | {c.j for c in closures}
        )
    else:
        sk = list(range(P_all))
    sk_of = {k: n for n, k in enumerate(sk)}
    kfs = [kfs_all[k] for k in sk]
    edges = [(c._replace(i=sk_of[c.i], j=sk_of[c.j]), e) for c, e in edges]
    P = len(kfs)
    poses = Sim3(
        s=torch.ones(P, device=state.device),
        R=_dev(state, np.stack([kf.R for kf in kfs])),
        t=_dev(state, np.stack([kf.t for kf in kfs])),
    )
    fixed = np.zeros(P, bool)
    fixed[0] = True
    n_odo = P - 1
    ii, jj, sz, Rz, tz, w = [], [], [], [], [], []
    for k in range(n_odo):
        Rrel = kfs[k + 1].R @ kfs[k].R.T
        ii += [k]
        jj += [k + 1]
        sz += [1.0]
        Rz.append(Rrel)
        tz.append(kfs[k + 1].t - Rrel @ kfs[k].t)
        w += [1.0]
    for c, (s_z, R_z, t_z) in edges:
        ii += [c.i]
        jj += [c.j]
        sz += [s_z]
        Rz.append(R_z)
        tz.append(t_z)
        w += [closure_weight]
    graph = Sim3Graph(
        i=_dev(state, ii, torch.int32), j=_dev(state, jj, torch.int32), s_z=_dev(state, sz),
        R_z=_dev(state, np.stack(Rz)), t_z=_dev(state, np.stack(tz)), weight=_dev(state, w),
        fixed=_dev(state, fixed, torch.bool),
    )
    poses, graph0, P_real = _pad_pose_graph(poses, graph)
    # the dense [7P, 7P] Cholesky is cubic in the padded pose count
    solver = "pcg" if int(graph0.fixed.shape[0]) > 256 else "dense"

    def graph_of(w_):
        return graph0._replace(weight=_dev(state, w_))

    def solve(w_):
        opt, stats = optimize_pose_graph_sim3(
            poses, graph_of(w_), iterations=iterations, huber_delta=huber_delta,
            robust_kernel=robust_kernel, solver=solver, cg_iterations=100,
        )
        return opt if np.isfinite(float(stats.cost)) else None

    n_clo = len(edges)
    active, opt, clo_res, odo_max = _prune(
        solve, lambda o, w_: _host(sim3_edge_residuals(o, graph_of(w_))),
        n_odo, n_clo, _host(graph0.weight), max_closure_residual,
    )
    if opt is None:
        return 0
    if not active.any():
        _diag(
            state, ev="closure_reject", stage="post_solve", n_verified=n_clo,
            clo_res=[round(float(x), 4) for x in clo_res[:8]],
            odo_res_max=round(odo_max, 4), bar=max_closure_residual,
        )
        return 0
    edges_orig = [e for e, a in zip(edges_orig, active) if a]
    edges = [e for e, a in zip(edges, active) if a]

    old = [(kf.R.copy(), kf.t.copy()) for kf in state.keyframes]
    sn = _host(opt.s)[:P_real]
    Rn = _host(opt.R)[:P_real]
    tn = _host(opt.t)[:P_real]
    lo_b, hi_b = state.config.loop_scale_band
    if lo_b > 0 and (sn.min() < lo_b or sn.max() > hi_b):
        # recovered node scales outside the band: the solver satisfied a
        # broken constraint by warping the map (a smooth warp keeps every
        # edge residual small, so the residual checks miss it)
        _diag(state, ev="closure_reject", stage="scale_sanity",
              sn_min=round(float(sn.min()), 4), sn_max=round(float(sn.max()), 4))
        return 0
    if P_all > len(sk):
        # expand the skeleton's corrections: T_k_new = Z_(k|a) o T_a_new,
        # Z the stored relative pose to the skeleton predecessor a
        sk_arr = np.asarray(sk)
        sn_f = np.ones(P_all, np.float32)
        Rn_f = np.stack([o[0] for o in old]).astype(np.float32)
        tn_f = np.stack([o[1] for o in old]).astype(np.float32)
        for k in range(P_all):
            a = int(sk_arr[max(int(np.searchsorted(sk_arr, k, side="right")) - 1, 0)])
            n = sk_of[a]
            if k == a:
                sn_f[k], Rn_f[k], tn_f[k] = sn[n], Rn[n], tn[n]
                continue
            Ra_o, ta_o = old[a]
            Rz_k = old[k][0] @ Ra_o.T
            tz_k = old[k][1] - Rz_k @ ta_o
            sn_f[k] = sn[n]
            Rn_f[k] = Rz_k @ Rn[n]
            tn_f[k] = Rz_k @ tn[n] + tz_k
        sn, Rn, tn = sn_f, Rn_f, tn_f

    anchor = _landmark_anchors(state)
    for k in np.unique(anchor[anchor >= 0]):
        sel = np.nonzero(anchor == k)[0]
        Ro, to = old[k]
        Xc = state.landmarks[sel] @ Ro.T + to  # camera frame, invariant
        state.landmarks[sel] = ((Xc - tn[k]) @ Rn[k]) / sn[k]  # T_new^{-1} Xc

    c_old = np.stack([-(o[0].T @ o[1]) for o in old])
    for k, kf in enumerate(state.keyframes):
        kf.R, kf.t = Rn[k], (tn[k] / sn[k]).astype(np.float32)
    c_new = np.stack([-(kf.R.T @ kf.t) for kf in state.keyframes])
    ed_diag = [
        {
            "i": int(i0), "j": int(j0), "s_z": round(float(s_z), 4),
            "t_z": round(float(np.linalg.norm(t_z)), 3),
            "gap_pre": round(float(np.linalg.norm(c_old[i0] - c_old[j0])), 3),
            "gap_post": round(float(np.linalg.norm(c_new[i0] - c_new[j0])), 3),
        }
        for (i0, j0), (_, (s_z, _R, t_z)) in zip(edges_orig, edges)
    ]
    _diag(
        state, ev="closure_solve", sn_min=round(float(sn.min()), 4),
        sn_max=round(float(sn.max()), 4),
        d_center_max=round(float(np.linalg.norm(c_new - c_old, axis=1).max()), 3),
        edges=ed_diag,
    )
    return len(edges)

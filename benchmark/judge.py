"""The comparisons that decide ``correct``, and their limits.

Two layers are judged, each against a reference that shares nothing with
the program:

- **front-end**: the keypoints and descriptors the timed path produced on
  frames of the window, against :mod:`benchmark.reference` in float64 on
  the same frames. Per frame, each program keypoint is matched to the
  nearest reference keypoint of its level (within ``MATCH_PX`` level
  pixels). ``kp_miss_pct``: the worst frame's share of keypoints, of both
  sides, left without a match. ``desc_err``: the worst frame's median,
  over matched keypoints, of the largest absolute descriptor component
  difference (descriptors are unit vectors).
- **poses** (fleet cells): every stream's poses returned in the window
  against the generator's exact ground truth. For every pair of frames
  a gap apart (the traffic's ``pose_gap_frames``), the rotation between
  the two returned poses is compared with the true one (each the
  pose-to-pose rotation R_{k+g} R_k^T: free of the world frame and of
  monocular scale), as rotation vectors v (returned) and u (true). A
  stream's axis error is
  1 - sum(v . u) / sum(|v| |u|): each pair's cosine, weighted by the size
  of both turns, so that pairs whose true turn is too small to show an
  axis weigh little. ``rot_axis_err``: the worst stream's. A stream that
  turns about the true axes reads near 0 whatever the error in the angle
  (on these scenes the VO's angles shrink on streams whose tracking has
  weakened, in the JAX reference as in the program: PERF.md); a stream
  whose poses do not move reads 1; one that follows another camera's
  motion reads about 1 or more. The magnitude error (median angle of
  R_est R_true^T over the median true angle) is printed for the median
  and the worst stream, not judged. A pose that never came, or is not
  finite, is a failed answer.

Every limit, and the readings it was set from, is in PERF.md.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

#: the largest distance (level pixels) at which two keypoints are one
MATCH_PX = 0.05

#: name -> limit; a run is correct when every number is at most its limit
LIMITS = {
    "kp_miss_pct": 0.9,
    "desc_err": 2e-4,
    "rot_axis_err": 0.5,
}


def match_frame(prog: dict, ref, levels: int) -> tuple:
    """(unmatched, total, per-keypoint desc errors [n]) of one frame:
    ``prog`` the program's Features row (yx in level-0 pixels, level, desc,
    valid), ``ref`` a reference.RefFeatures."""
    unmatched, total, errs = 0, 0, []
    for lvl in range(levels):
        sel = prog["valid"] & (prog["level"] == lvl)
        p_yx = prog["yx"][sel].double() / (2.0 ** lvl)
        p_desc = prog["desc"][sel].double()
        r_yx = ref.yx[lvl].double().to(p_yx.device)
        r_desc = ref.desc[lvl].double().to(p_yx.device)
        total += len(p_yx) + len(r_yx)
        if len(p_yx) == 0 or len(r_yx) == 0:
            unmatched += len(p_yx) + len(r_yx)
            continue
        d = torch.cdist(p_yx, r_yx)
        best, j = d.min(1)
        ok = best <= MATCH_PX
        # one reference keypoint takes at most one program keypoint
        matched = torch.unique(j[ok]).numel()
        unmatched += (len(p_yx) - matched) + (len(r_yx) - matched)
        if ok.any():
            errs.append((p_desc[ok] - r_desc[j[ok]]).abs().amax(1))
    e = torch.cat(errs) if errs else torch.zeros(0, dtype=torch.float64)
    return unmatched, total, e


def frontend_numbers(frames: Sequence[dict], refs: Sequence, levels: int) -> Dict[str, float]:
    """kp_miss_pct and desc_err over sampled frames (see the module)."""
    miss, derr = 0.0, 0.0
    for prog, ref in zip(frames, refs):
        u, n, e = match_frame(prog, ref, levels)
        miss = max(miss, 100.0 * u / max(n, 1))
        derr = max(derr, float(e.median()) if e.numel() else float("inf"))
    return {"kp_miss_pct": miss, "desc_err": derr}


# -- poses ---------------------------------------------------------------------

def _angles(R: np.ndarray) -> np.ndarray:
    """Rotation angles (radians) of a stack of rotation matrices."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def _rotvec(R: np.ndarray) -> np.ndarray:
    """Rotation vectors (axis times angle) of a stack of rotation matrices."""
    ang = _angles(R)
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.sin(ang)
    return w * np.where(s > 1e-9, ang / (2.0 * np.maximum(s, 1e-12)), 0.5)[:, None]


def rotation_errors(R: np.ndarray, gR: np.ndarray, gap: int) -> tuple:
    """(axis error, magnitude error) of returned against true pose-to-pose
    rotations ``gap`` frames apart: 1 - the cosine of their rotation
    vectors weighted by the size of both turns (1 where the returned ones
    are all nought), and the median angle between them over the median
    true angle. (inf, inf) without pairs."""
    if len(R) <= gap:
        return float("inf"), float("inf")
    rel = R[gap:] @ np.swapaxes(R[:-gap], -1, -2)
    grel = gR[gap:] @ np.swapaxes(gR[:-gap], -1, -2)
    v, gv = _rotvec(rel), _rotvec(grel)
    norm = float((np.linalg.norm(v, axis=1) * np.linalg.norm(gv, axis=1)).sum())
    axis = 1.0 - float((v * gv).sum()) / norm if norm > 0 else 1.0
    mag = np.median(_angles(rel @ np.swapaxes(grel, -1, -2))) / max(np.median(_angles(grel)), 1e-12)
    return axis, float(mag)


def pose_numbers(streams: Sequence[dict], gap: int) -> Dict[str, float]:
    """rot_axis_err (the worst stream's), the magnitude error of the median
    and the worst stream, and the count of failed answers, over pairs of
    frames ``gap`` apart. Each stream:
    ``R`` [F, 3, 3], ``t`` [F, 3] returned (None where no pose came),
    ``gt_R``, ``gt_t`` the truth of the same frames."""
    axis, mag, failed, attempted = [], [], 0, 0
    for s in streams:
        attempted += len(s["gt_t"])
        ok = np.array([r is not None and np.isfinite(r).all() and np.isfinite(t).all()
                       for r, t in zip(s["R"], s["t"])], bool)
        failed += int((~ok).sum()) + (len(s["gt_t"]) - len(s["R"]))
        if not ok.all() or len(s["R"]) != len(s["gt_t"]):
            axis.append(float("inf"))
            mag.append(float("inf"))
            continue
        a, m = rotation_errors(np.stack(s["R"]), np.asarray(s["gt_R"]), gap)
        axis.append(a)
        mag.append(m)
    return {"rot_axis_err": max(axis, default=float("inf")),
            "_rot_err_median": float(np.median(mag)) if mag else float("inf"),
            "_rot_err_worst": max(mag, default=float("inf")),
            "_poses_failed": failed, "_poses_attempted": attempted}


def verdict(numbers: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have limits."""
    rows = [(k, float(v), LIMITS[k]) for k, v in numbers.items() if k in LIMITS]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows

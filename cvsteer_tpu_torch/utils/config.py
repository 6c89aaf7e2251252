"""Typed configuration tree + flag overrides (SURVEY.md section 5, config).

The reference scatters parameters between a cv::CommandLineParser keys table
(example/steer.cpp:133-140), constructor defaults (SteerableFiltersG2.h:38,
SteerableFiltersG4.h:38), and CMake options. Here everything lives in one
dataclass tree that serializes to/from JSON and accepts dotted CLI
overrides (``--set slam.window=10 frontend.levels=4``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


@dataclasses.dataclass
class FilterBankConfig:
    """G2 defaults match SteerableFiltersG2.h:38; G4 SteerableFiltersG4.h:38."""

    g2_width: int = 4
    g2_spacing: float = 0.67
    g4_width: int = 6
    g4_spacing: float = 0.5
    phase_k: float = 2.0  # accepted-but-unused in the reference (quirk C15)


@dataclasses.dataclass
class FrontendCfg:
    levels: int = 5
    keypoints_per_level: int = 256
    nms_radius: int = 2
    threshold: float = 1.0
    descriptor_grid: int = 4
    descriptor_spacing: float = 3.0
    order: int = 2  # 2 = G2/H2, 4 = G4/H4 (features.frontend.FrontendConfig)


@dataclasses.dataclass
class CameraConfig:
    # Brown-Conrady distortion (OpenCV k1, k2, p1, p2, k3 ordering);
    # all-zero = pure pinhole
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0


# Published calibrations for the BASELINE datasets (OpenCV convention),
# applied via cli_vo --camera-preset. TUM freiburg values are the
# ROS-default monocular calibrations from the dataset documentation;
# KITTI odometry grayscale cam0 is rectified (no distortion).
CAMERA_PRESETS: Dict[str, Dict[str, float]] = {
    "tum_fr1": dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                    k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633),
    "tum_fr2": dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7,
                    k1=0.2312, k2=-0.7849, p1=-0.0033, p2=-0.0001, k3=0.9172),
    "tum_fr3": dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6),
    "kitti_gray": dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157),
}


def apply_camera_preset(cfg: "EngineConfig", name: str) -> "EngineConfig":
    """Overwrite cfg.camera with a named published calibration."""
    if name not in CAMERA_PRESETS:
        raise KeyError(
            f"unknown camera preset {name!r}; have {sorted(CAMERA_PRESETS)}"
        )
    d = to_dict(cfg)
    d["camera"] = {**to_dict(cfg.camera), **CAMERA_PRESETS[name]}
    return from_dict(EngineConfig, d)


@dataclasses.dataclass
class SlamConfig:
    match_ratio: float = 0.85
    # matches slam.vo.VOConfig's robust default (round 3: 0.015 accepted
    # near-degenerate bootstrap pairs — see VOConfig.min_parallax)
    min_parallax: float = 0.03
    init_min_inliers: int = 30
    track_min_landmarks: int = 40
    kf_max_gap: int = 10
    window: int = 8
    ba_iterations: int = 12
    huber_delta: float = 4e-3
    ransac_hypotheses: int = 512
    ransac_threshold: float = 1e-5
    max_landmarks: int = 4096
    loop_closure: bool = False
    # Sim(3) pose graph for closures (scale-drift-aware monocular loop
    # closure) instead of the SE(3) graph
    loop_closure_sim3: bool = False
    loop_min_gap: int = 6
    loop_min_inliers: int = 25
    loop_robust_delta: float = 0.0
    motion_model: bool = False
    # device engine (--engine device) only: track against the per-landmark
    # descriptor store instead of only the last keyframe (robust to
    # feature dropout / viewpoint change)
    track_local_map: bool = False
    # flow-driven keyframe promotion threshold in pixels (0 = off): see
    # slam.vo.VOConfig.kf_min_flow_px
    kf_min_flow_px: float = 0.0
    # closure-event gate: consecutive same-region detections required
    # before paying verification, and the rejected-region cooldown in
    # keyframes (slam.loopclosure.closure_gate)
    loop_consistency: int = 1
    loop_reject_cooldown: int = 0
    # ground-plane height prior in meters (0 = off): the absolute
    # monocular scale anchor for fixed-height rigs
    # (slam.vo.apply_ground_prior)
    ground_height_m: float = 0.0
    # kinematic speed-prior band (0 = off; record-only when the ground
    # prior is active — governor precedence)
    speed_prior_lo: float = 0.0
    speed_prior_hi: float = 0.0


@dataclasses.dataclass
class MeshConfig:
    """Axis sizes; -1 infers one axis from the device count."""

    data: int = -1
    space: int = 1


@dataclasses.dataclass
class EngineConfig:
    filters: FilterBankConfig = dataclasses.field(default_factory=FilterBankConfig)
    frontend: FrontendCfg = dataclasses.field(default_factory=FrontendCfg)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    checkpoint_dir: str = ""
    checkpoint_every: int = 0  # keyframes between checkpoints; 0 disables
    profile_dir: str = ""  # profiler trace output; "" disables
    log_every: int = 10  # frames between metric log lines; 0 disables


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls, d: Dict[str, Any]):
    """Rebuild a (nested) dataclass from a plain dict, ignoring unknowns."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        ft = fields[k].type
        sub = _resolve(ft)
        if dataclasses.is_dataclass(sub) and isinstance(v, dict):
            kwargs[k] = from_dict(sub, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _resolve(t):
    if isinstance(t, str):
        return globals().get(t, t)
    return t


def save_config(cfg: EngineConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(path: str) -> EngineConfig:
    with open(path) as f:
        return from_dict(EngineConfig, json.load(f))


def apply_overrides(cfg: EngineConfig, overrides: Tuple[str, ...]) -> EngineConfig:
    """Dotted-path overrides: ``("slam.window=10", "frontend.levels=4")``."""
    d = to_dict(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value: {item!r}")
        key, value = item.split("=", 1)
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                raise KeyError(f"unknown config group {p!r} in {key!r}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key {key!r}")
        old = node[leaf]
        if isinstance(old, bool):
            node[leaf] = value.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            node[leaf] = int(value)
        elif isinstance(old, float):
            node[leaf] = float(value)
        else:
            node[leaf] = value
    return from_dict(EngineConfig, d)

"""Carry the reference package's parameters and state into the port.

The system has no weights: its parameters are tap banks and configs, its
per-frame state is a Features set, the VO engines carry a keyframed
VOState (the device engine a DeviceMap beside it, the fleet a stacked
DeviceMap and, pipelined, a _FleetAux) from frame to frame, and
loop closure optimizes Poses/PoseGraph and Sim3/Sim3Graph. These helpers take the reference
package's values as plain Python/numpy objects (NamedTuples, numpy or
array-like fields; anything with the same field names) and build the port's
types, so tests feed both packages identical inputs. Nothing here imports
the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig
from cvsteer_tpu_torch.filters.g2 import G2Bank
from cvsteer_tpu_torch.filters.g4 import G4Bank
from cvsteer_tpu_torch.filters.taps import SeparableBank
from cvsteer_tpu_torch.geometry.camera import Intrinsics
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.slam.vo_device import DeviceMap


def separable_bank(bank) -> SeparableBank:
    """A reference SeparableBank (xtaps, ytaps, names) -> the port's."""
    return SeparableBank(
        xtaps=np.asarray(bank.xtaps, np.float32),
        ytaps=np.asarray(bank.ytaps, np.float32),
        names=tuple(bank.names),
    )


def _bank(cls, bank):
    return cls(
        xtaps=np.asarray(bank.xtaps, np.float32),
        ytaps=np.asarray(bank.ytaps, np.float32),
        width=int(bank.width),
        spacing=float(bank.spacing),
    )


def g2_bank(bank) -> G2Bank:
    """A reference G2Bank (xtaps, ytaps, width, spacing) -> the port's."""
    return _bank(G2Bank, bank)


def g4_bank(bank) -> G4Bank:
    """A reference G4Bank (xtaps, ytaps, width, spacing) -> the port's."""
    return _bank(G4Bank, bank)


def features(f, device="cuda") -> Features:
    """A reference Features (arrays of any array type) -> the port's
    tensors on ``device``, with the reference's dtypes."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return Features(
        yx=t(f.yx, torch.float32),
        score=t(f.score, torch.float32),
        theta=t(f.theta, torch.float32),
        level=t(f.level, torch.int32),
        desc=t(f.desc, torch.float32),
        valid=t(f.valid, torch.bool),
    )


def intrinsics(k) -> Intrinsics:
    return Intrinsics(
        float(k.fx), float(k.fy), float(k.cx), float(k.cy),
        dist=tuple(float(d) for d in k.dist),
    )


def frontend_config(c) -> FrontendConfig:
    return FrontendConfig(**{f: getattr(c, f) for f in FrontendConfig._fields if hasattr(c, f)})


def vo_config(c) -> VOConfig:
    """A reference VOConfig -> the port's (fields matched by name)."""
    kw = {f: getattr(c, f) for f in VOConfig._fields if hasattr(c, f)}
    kw["intrinsics"] = intrinsics(c.intrinsics)
    kw["frontend"] = frontend_config(c.frontend)
    return VOConfig(**kw)


_MAP_DTYPES = dict(
    X=torch.float32, lm_valid=torch.bool, lm_gen=torch.int32, kf_uv=torch.float32,
    kf_fvalid=torch.bool, kf_obs=torch.int32, kf_R=torch.float32, kf_t=torch.float32,
    kf_live=torch.bool, kf_desc=torch.float32, lm_desc=torch.float32, sig=torch.float32,
    sig_n=torch.int32, since_kf=torch.int32, ground_hist=torch.float32,
)


def device_map(m, device="cuda") -> DeviceMap:
    """A reference DeviceMap (arrays of any array type; None fields stay
    None) -> the port's, on ``device``; a fleet's stack ``[S, ...]`` as
    well. Descriptors become float32, the port's descriptor type."""
    return DeviceMap(**{
        f: None if getattr(m, f, None) is None else torch.as_tensor(
            np.array(getattr(m, f), dtype=np.float32 if _MAP_DTYPES[f].is_floating_point else None),
            dtype=_MAP_DTYPES[f], device=device,
        )
        for f in DeviceMap._fields
    })


def fleet_aux(a, device="cuda"):
    """A reference fleet's _FleetAux (R1, t1, R0, t0 [S, ...] float32,
    traj_n, since_kf [S] int32, block [S] bool) -> the port's."""
    from cvsteer_tpu_torch.slam.vo_device import _FleetAux

    dtypes = dict(traj_n=torch.int32, since_kf=torch.int32, block=torch.bool)
    return _FleetAux(**{
        f: torch.as_tensor(np.array(getattr(a, f)), dtype=dtypes.get(f, torch.float32),
                           device=device)
        for f in _FleetAux._fields
    })


def _f32(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def poses(p, device="cuda"):
    """A reference posegraph.Poses (R, t) -> the port's."""
    from cvsteer_tpu_torch.slam.posegraph import Poses

    return Poses(R=_f32(p.R, device), t=_f32(p.t, device))


def pose_graph(g, device="cuda"):
    """A reference posegraph.PoseGraph -> the port's."""
    from cvsteer_tpu_torch.slam.posegraph import PoseGraph

    return PoseGraph(
        i=torch.as_tensor(np.array(g.i, dtype=np.int32), device=device),
        j=torch.as_tensor(np.array(g.j, dtype=np.int32), device=device),
        R_z=_f32(g.R_z, device), t_z=_f32(g.t_z, device), weight=_f32(g.weight, device),
        fixed=torch.as_tensor(np.array(g.fixed, dtype=bool), device=device),
    )


def sim3(s, device="cuda"):
    """A reference sim3.Sim3 (s, R, t) -> the port's."""
    from cvsteer_tpu_torch.slam.sim3 import Sim3

    return Sim3(s=_f32(s.s, device), R=_f32(s.R, device), t=_f32(s.t, device))


def sim3_graph(g, device="cuda"):
    """A reference posegraph_sim3.Sim3Graph -> the port's."""
    from cvsteer_tpu_torch.slam.posegraph_sim3 import Sim3Graph

    pg = pose_graph(g, device)
    return Sim3Graph(i=pg.i, j=pg.j, s_z=_f32(g.s_z, device), R_z=pg.R_z, t_z=pg.t_z,
                     weight=pg.weight, fixed=pg.fixed)


def _copy(a, dtype=None):
    return None if a is None else np.array(a, dtype=dtype)


def vo_state(s, device="cuda"):
    """A reference (keyframed) VOState -> the port's on ``device``: the
    config, keyframes (features on the device; poses, landmark tables,
    stamps, fresh ids and cached signatures copied), the landmark mirror,
    the trajectory with its re-anchoring records, and the bookkeeping of
    the priors and of the closure gate. The signature index and the
    diagnostic log start empty."""
    from cvsteer_tpu_torch.slam.vo import Keyframe, VOState

    kfs = [
        Keyframe(
            index=int(kf.index),
            features=None if kf.features is None else features(kf.features, device),
            R=np.array(kf.R, np.float32), t=np.array(kf.t, np.float32),
            landmark_ids=np.array(kf.landmark_ids, np.int64),
            landmark_gens=_copy(kf.landmark_gens, np.int32),
            fresh_ids=_copy(kf.fresh_ids, np.int64),
            signature=_copy(kf.signature, np.float32),
        )
        for kf in s.keyframes
    ]
    return VOState(
        config=vo_config(s.config), device=torch.device(device), keyframes=kfs,
        landmarks=np.array(s.landmarks, np.float32),
        landmark_valid=np.array(s.landmark_valid, bool),
        num_landmarks=int(s.num_landmarks),
        trajectory=[(int(f), np.array(R, np.float32), np.array(t, np.float32))
                    for f, R, t in s.trajectory],
        traj_ref=[None if r is None else (int(r[0]), np.array(r[1], np.float32),
                                          np.array(r[2], np.float32), int(r[3]), float(r[4]))
                  for r in s.traj_ref],
        initialized=bool(s.initialized), frame_count=int(s.frame_count),
        track_version=int(s.track_version), lost_streak=int(s.lost_streak),
        kf_baselines=[float(b) for b in s.kf_baselines],
        loop_streak=tuple(s.loop_streak), loop_reject_until=dict(s.loop_reject_until),
        ground_hist=[float(h) for h in s.ground_hist],
    )

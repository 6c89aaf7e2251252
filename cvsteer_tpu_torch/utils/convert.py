"""Carry the reference package's parameters and state into the port.

The system has no weights: its parameters are tap banks and configs, its
per-frame state is a Features set, and the device VO engine carries a
DeviceMap from frame to frame. These helpers take the reference
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
    None) -> the port's, on ``device``. Descriptors become float32, the
    port's descriptor type."""
    return DeviceMap(**{
        f: None if getattr(m, f, None) is None else torch.as_tensor(
            np.array(getattr(m, f), dtype=np.float32 if _MAP_DTYPES[f].is_floating_point else None),
            dtype=_MAP_DTYPES[f], device=device,
        )
        for f in DeviceMap._fields
    })

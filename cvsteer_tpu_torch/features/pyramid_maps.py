"""Batched steerable map pyramids: G2/H2 + G4/H4 over Gaussian levels (the
twin of cvsteer_tpu.features.pyramid_maps).

BASELINE config 2 as a direct API: every pyramid level's full set of
orientation-energy and phase maps from both quadrature pairs, batched over
images, for consumers that want the dense fields (flow, segmentation,
texture). On the card the pyramid is kernel B and every basis kernel A.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cvsteer_tpu_torch.filters import g2 as fg2
from cvsteer_tpu_torch.filters import g4 as fg4
from cvsteer_tpu_torch.ops.pyramid import gaussian_pyramid


class LevelMaps(NamedTuple):
    """Per-level dense map stack (shapes [..., H_l, W_l])."""

    g2: fg2.G2Maps
    g4: Optional[fg4.G4Maps]


def steerable_pyramid_maps(
    image: torch.Tensor,
    *,
    levels: int = 5,
    with_g4: bool = True,
    g2_bank: Optional[fg2.G2Bank] = None,
    g4_bank: Optional[fg4.G4Bank] = None,
) -> Tuple[LevelMaps, ...]:
    """All steerable maps of ``image [..., H, W]`` at every pyramid level."""
    if g2_bank is None:
        g2_bank = fg2.g2_bank()
    if with_g4 and g4_bank is None:
        g4_bank = fg4.g4_bank()
    out = []
    for img in gaussian_pyramid(image, levels):
        out.append(LevelMaps(
            g2=fg2.steerable_pipeline_g2(img, g2_bank),
            g4=fg4.steerable_pipeline_g4(img, g4_bank) if with_g4 else None,
        ))
    return tuple(out)

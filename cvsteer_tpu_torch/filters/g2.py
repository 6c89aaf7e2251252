"""G2/H2 steerable quadrature pair — the twin of cvsteer_tpu.filters.g2.

Pure functions over a stacked basis tensor ``[..., 7, H, W]`` in the order
(g2a, g2b, g2c, h2a, h2b, h2c, h2d). Conventions (theta = 0 vertical,
counterclockwise; energy coefficients of Freeman & Adelson's table,
cvsteer/SteerableFiltersG2.cpp:93-95) are the reference package's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.filters.taps import (
    G2_DEFAULT_SPACING,
    G2_DEFAULT_WIDTH,
    SeparableBank,
    g2h2_bank,
)


class G2Bank(NamedTuple):
    """Static filter-bank parameters for G2/H2."""

    xtaps: np.ndarray  # [7, T]
    ytaps: np.ndarray  # [7, T]
    width: int
    spacing: float

    @property
    def radius(self) -> int:
        return (self.xtaps.shape[1] - 1) // 2


def g2_bank(width: int = G2_DEFAULT_WIDTH, spacing: float = G2_DEFAULT_SPACING) -> G2Bank:
    bank: SeparableBank = g2h2_bank(width, spacing)
    return G2Bank(xtaps=bank.xtaps, ytaps=bank.ytaps, width=width, spacing=spacing)


# Basis stacking order, used everywhere downstream.
G2A, G2B, G2C, H2A, H2B, H2C, H2D = range(7)


def energy_coefficients(basis: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fourier coefficients (c1, c2, c3) of the oriented energy
    E(theta) = c1 + c2 cos(2 theta) + c3 sin(2 theta)."""
    g2a, g2b, g2c, h2a, h2b, h2c, h2d = [basis[..., k, :, :] for k in range(7)]
    c1 = (
        0.5 * g2b * g2b
        + 0.25 * g2a * g2c
        + 0.375 * (g2a * g2a + g2c * g2c)
        + 0.3125 * (h2a * h2a + h2d * h2d)
        + 0.5625 * (h2b * h2b + h2c * h2c)
        + 0.375 * (h2a * h2c + h2b * h2d)
    )
    c2 = (
        0.5 * (g2a * g2a - g2c * g2c)
        + 0.46875 * (h2a * h2a - h2d * h2d)
        + 0.28125 * (h2b * h2b - h2c * h2c)
        + 0.1875 * (h2a * h2c - h2b * h2d)
    )
    c3 = (
        -(g2a * g2b)
        - g2b * g2c
        - 0.9375 * (h2c * h2d + h2a * h2b)
        - 1.6875 * h2b * h2c
        - 0.1875 * h2a * h2d
    )
    return c1, c2, c3


def corner_strength(c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor) -> torch.Tensor:
    """Orientation-isotropic energy c1 - |(c2, c3)| = min_theta E(theta)."""
    return c1 - torch.hypot(c2, c3)


def dominant_orientation(c2: torch.Tensor, c3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta, strength): theta = atan2(c3, c2) / 2 in (-pi/2, pi/2],
    strength = |(c2, c3)|."""
    return 0.5 * torch.atan2(c3, c2), torch.hypot(c2, c3)

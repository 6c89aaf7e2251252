"""G2/H2 steerable quadrature pair — the twin of cvsteer_tpu.filters.g2.

Pure functions over a stacked basis tensor ``[..., 7, H, W]`` in the order
(g2a, g2b, g2c, h2a, h2b, h2c, h2d). Conventions are the reference
package's: theta = 0 vertical, counterclockwise; energy coefficients of
Freeman & Adelson's table (cvsteer/SteerableFiltersG2.cpp:93-95); angles in
(-pi, pi]; phase 0 = dark line, +-pi = bright line, +-pi/2 = edge; the
find_* extractors are fed the quadrature *magnitude*, as the reference CLI
and test do (quirk C23 in SURVEY.md), so the golden maps match.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.filters.taps import (
    G2_DEFAULT_SPACING,
    G2_DEFAULT_WIDTH,
    SeparableBank,
    g2h2_bank,
)
from cvsteer_tpu_torch.ops.cuda_frontend import filter_bank_diff, g2_maps


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


def g2_basis(image: torch.Tensor, bank: Optional[G2Bank] = None) -> torch.Tensor:
    """The 7 basis responses ``[..., 7, H, W]`` of ``image [..., H, W]``;
    differentiable (kernel A forward, kernel F backward on the card)."""
    if bank is None:
        bank = g2_bank()
    return filter_bank_diff(image, bank.xtaps, bank.ytaps)


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


def steer(basis: torch.Tensor, theta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steer the pair to scalar or per-pixel ``theta``:
    G2 = c^2 g2a - 2 c s g2b + s^2 g2c,
    H2 = c^3 h2a - 3 c^2 s h2b + 3 c s^2 h2c - s^3 h2d."""
    theta = torch.as_tensor(theta, dtype=basis.dtype, device=basis.device)
    ct = torch.cos(theta)
    st = torch.sin(theta)
    ct2, st2 = ct * ct, st * st
    ct3, st3 = ct2 * ct, st2 * st
    g2 = (
        ct2 * basis[..., G2A, :, :]
        - 2.0 * ct * st * basis[..., G2B, :, :]
        + st2 * basis[..., G2C, :, :]
    )
    h2 = (
        ct3 * basis[..., H2A, :, :]
        - 3.0 * ct2 * st * basis[..., H2B, :, :]
        + 3.0 * ct * st2 * basis[..., H2C, :, :]
        - st3 * basis[..., H2D, :, :]
    )
    return g2, h2


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """[0, 2pi) -> (-pi, pi] (SteerableFilters::wrap)."""
    return torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)


def steer_at(basis: torch.Tensor, y, x, theta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steer at the single pixel (y, x); returns scalar (g2, h2)."""
    g2, h2 = steer(basis[..., :, y, x][..., :, None, None], theta)
    return g2[..., 0, 0], h2[..., 0, 0]


def analyze_at(basis: torch.Tensor, y, x, theta):
    """Point steering with the full response set (g2, h2, e, magnitude, phase)."""
    g2v, h2v = steer_at(basis, y, x, theta)
    c1, c2, c3 = energy_coefficients(basis[..., :, y, x][..., :, None, None])
    e = oriented_energy(c1, c2, c3, theta)[..., 0, 0]
    magnitude, phase = magnitude_phase(g2v, h2v)
    return g2v, h2v, e, magnitude, phase


def magnitude_phase(g2: torch.Tensor, h2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrature magnitude hypot(g2, h2) and phase atan2(h2, g2) in
    (-pi, pi], NaNs -> 0."""
    return torch.hypot(g2, h2), torch.nan_to_num(torch.atan2(h2, g2))


def oriented_energy(c1, c2, c3, theta) -> torch.Tensor:
    """E(theta) = c1 + cos(2 theta) c2 + sin(2 theta) c3 (scalar or map theta)."""
    theta = torch.as_tensor(theta, dtype=c1.dtype, device=c1.device)
    return c1 + torch.cos(2.0 * theta) * c2 + torch.sin(2.0 * theta) * c3


def phase_weights(phase: torch.Tensor, phi: float, signum: bool, k: float = 2.0) -> torch.Tensor:
    """Phase selectivity cos^2(err), zero where err > pi/2; err = |phase -
    phi| (signum) or ||phase| - |phi||, folded to min(err, 2pi - err). Like
    the reference (SteerableFiltersG2.cpp:179-186), ``k`` is accepted and
    unused: cos^2 is hard-coded there (quirk C15)."""
    del k
    phi = float(phi)
    if signum:
        err = torch.abs(phase - phi)
    else:
        err = torch.abs(torch.abs(phase) - abs(phi))
    err = torch.minimum(err, 2.0 * math.pi - err)
    lam = torch.cos(err) ** 2
    return torch.where(err > math.pi / 2.0, 0.0, lam).to(phase.dtype)


def find_edges(e: torch.Tensor, phase: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """Edge map: e * phase_weights(phase, pi/2, abs-mode)."""
    return e * phase_weights(phase, math.pi / 2.0, signum=False, k=k)


def find_dark_lines(e: torch.Tensor, phase: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """Dark-line map: e * phase_weights(phase, 0, signed)."""
    return e * phase_weights(phase, 0.0, signum=True, k=k)


def find_bright_lines(e: torch.Tensor, phase: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """Bright-line map: e * phase_weights(phase, pi, signed)."""
    return e * phase_weights(phase, math.pi, signum=True, k=k)


class G2Maps(NamedTuple):
    """All maps of the reference CLI/test pipeline, batched."""

    g2: torch.Tensor
    h2: torch.Tensor
    energy: torch.Tensor
    magnitude: torch.Tensor
    phase: torch.Tensor
    theta: torch.Tensor
    strength: torch.Tensor
    edges: torch.Tensor
    lines_dark: torch.Tensor
    lines_bright: torch.Tensor


def g2_maps_from_basis(basis: torch.Tensor) -> G2Maps:
    """energy coefficients -> dominant orientation -> per-pixel steering ->
    magnitude/phase -> oriented energy -> edge and line maps."""
    c1, c2, c3 = energy_coefficients(basis)
    theta, strength = dominant_orientation(c2, c3)
    g2v, h2v = steer(basis, theta)
    magnitude, phase = magnitude_phase(g2v, h2v)
    return G2Maps(
        g2=g2v,
        h2=h2v,
        energy=oriented_energy(c1, c2, c3, theta),
        magnitude=magnitude,
        phase=phase,
        theta=theta,
        strength=strength,
        edges=find_edges(magnitude, phase),
        lines_dark=find_dark_lines(magnitude, phase),
        lines_bright=find_bright_lines(magnitude, phase),
    )


def steerable_pipeline_g2(image: torch.Tensor, bank: Optional[G2Bank] = None) -> G2Maps:
    """Full G2 analysis of ``image [..., H, W]`` (grayscale, 0..255 scale),
    the reference's end-to-end flow (example/steer.cpp:86-90). fp32 class:
    the basis is kernel A on the card, the rest plain PyTorch."""
    return g2_maps_from_basis(g2_basis(image, bank))


def g2_output_maps(
    image: torch.Tensor,
    bank: Optional[G2Bank] = None,
    *,
    accuracy: str = "fast",
    out_dtype=None,
):
    """The three reference output maps (edges, lines_dark, lines_bright)
    with an explicit accuracy class:

    - ``"fast"``: the fused maps kernel (kernel E; its plain version on the
      CPU) — one image read, three map writes, sqrt-free steering. What the
      CLI uses.
    - ``"precise"``: the full pipeline (steerable_pipeline_g2).

    ``out_dtype`` defaults to float32; bfloat16 halves the map writes (the
    CLI quantizes to 8 bits right after).
    """
    if bank is None:
        bank = g2_bank()
    if accuracy == "fast":
        return g2_maps(
            image, bank.xtaps, bank.ytaps,
            out_dtype=torch.float32 if out_dtype is None else out_dtype,
        )
    if accuracy != "precise":
        raise ValueError(f"accuracy must be 'fast' or 'precise', got {accuracy!r}")
    maps = steerable_pipeline_g2(image, bank)
    out = (maps.edges, maps.lines_dark, maps.lines_bright)
    if out_dtype is not None:
        out = tuple(m.to(out_dtype) for m in out)
    return out

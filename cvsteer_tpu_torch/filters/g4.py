"""G4/H4 steerable quadrature pair (4th order) — the twin of cvsteer_tpu.filters.g4.

Pure functions over a stacked basis tensor ``[..., 11, H, W]`` in the order
(g4a, g4b, g4c, g4d, g4e, h4a, h4b, h4c, h4d, h4e, h4f). Steering weights
(cvsteer/SteerableFiltersG4.cpp:92-122), the energy expansion and the
closed-form quadratic tables are the reference package's; like it, the port
fills the reference library's empty computeMagnitudeAndPhase stub.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cvsteer_tpu_torch.filters.taps import G4_DEFAULT_SPACING, G4_DEFAULT_WIDTH, g4h4_bank
from cvsteer_tpu_torch.ops.cuda_frontend import filter_bank_diff
from cvsteer_tpu_torch.utils.precision import precise


class G4Bank(NamedTuple):
    xtaps: np.ndarray  # [11, T]
    ytaps: np.ndarray  # [11, T]
    width: int
    spacing: float

    @property
    def radius(self) -> int:
        return (self.xtaps.shape[1] - 1) // 2


def g4_bank(width: int = G4_DEFAULT_WIDTH, spacing: float = G4_DEFAULT_SPACING) -> G4Bank:
    bank = g4h4_bank(width, spacing)
    return G4Bank(xtaps=bank.xtaps, ytaps=bank.ytaps, width=width, spacing=spacing)


G4A, G4B, G4C, G4D, G4E, H4A, H4B, H4C, H4D, H4E, H4F = range(11)


def g4_basis(image: torch.Tensor, bank: Optional[G4Bank] = None) -> torch.Tensor:
    """The 11 basis responses ``[..., 11, H, W]`` of ``image [..., H, W]``;
    differentiable (kernel A forward, kernel F backward on the card)."""
    if bank is None:
        bank = g4_bank()
    return filter_bank_diff(image, bank.xtaps, bank.ytaps)


def steering_coefficients(theta, dtype=torch.float32, device=None):
    """Interpolation weights (ga[5], ha[6]) at orientation ``theta``:
    G4: (c^4, -4 c^3 s, 6 c^2 s^2, -4 c s^3, s^4);
    H4: (c^5, -5 c^4 s, 10 c^3 s^2, -10 c^2 s^3, 5 c s^4, -s^5)."""
    theta = torch.as_tensor(theta, dtype=dtype, device=device)
    c, s = torch.cos(theta), torch.sin(theta)
    c2, s2 = c * c, s * s
    c3, s3 = c2 * c, s2 * s
    c4, s4 = c3 * c, s3 * s
    c5, s5 = c4 * c, s4 * s
    ga = (c4, -4.0 * c3 * s, 6.0 * c2 * s2, -4.0 * c * s3, s4)
    ha = (c5, -5.0 * c4 * s, 10.0 * c3 * s2, -10.0 * c2 * s3, 5.0 * c * s4, -s5)
    return ga, ha


def steer(basis: torch.Tensor, theta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steer G4/H4 to scalar or per-pixel ``theta``; returns (g4, h4)."""
    ga, ha = steering_coefficients(theta, dtype=basis.dtype, device=basis.device)
    g4 = sum(ga[i] * basis[..., G4A + i, :, :] for i in range(5))
    h4 = sum(ha[i] * basis[..., H4A + i, :, :] for i in range(6))
    return g4, h4


def magnitude_phase(g4: torch.Tensor, h4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrature magnitude and phase in (-pi, pi], NaNs -> 0 (the G2 semantics)."""
    return torch.hypot(g4, h4), torch.nan_to_num(torch.atan2(h4, g4))


_NUM_ANGLES = 16  # exact DFT for harmonics up to 2*7 theta; E4 needs up to 2*5.


def energy_harmonics(basis: torch.Tensor, num_harmonics: int = 2):
    """Fourier expansion of E(theta) = G4(theta)^2 + H4(theta)^2 from 16
    uniform angles over [0, pi): (a0, [a_m], [b_m]), m = 1..num_harmonics."""
    thetas = np.arange(_NUM_ANGLES, dtype=np.float64) * (math.pi / _NUM_ANGLES)
    energies = []
    for t in thetas:
        g4t, h4t = steer(basis, float(t))
        energies.append(g4t * g4t + h4t * h4t)
    e = torch.stack(energies, dim=0)
    n = float(_NUM_ANGLES)
    a0 = torch.sum(e, dim=0) / n
    a_ms: List[torch.Tensor] = []
    b_ms: List[torch.Tensor] = []
    shape = (_NUM_ANGLES,) + (1,) * (e.dim() - 1)
    for m in range(1, num_harmonics + 1):
        cosw = torch.as_tensor(np.cos(2.0 * m * thetas), dtype=e.dtype, device=e.device)
        sinw = torch.as_tensor(np.sin(2.0 * m * thetas), dtype=e.dtype, device=e.device)
        a_ms.append(torch.sum(e * cosw.reshape(shape), dim=0) * (2.0 / n))
        b_ms.append(torch.sum(e * sinw.reshape(shape), dim=0) * (2.0 / n))
    return a0, a_ms, b_ms


@functools.lru_cache(maxsize=None)
def _energy_quadratic_tables(num_angles: int = _NUM_ANGLES):
    """Constant [11, 11] float32 quadratic forms (M1, M2, M3) with
    c_k = sum_ij Mk_ij b_i b_j: the DC and cos/sin-2theta projections of the
    steering-weight products, exact at 16 angles. The G and H blocks stay
    separate (E = G4^2 + H4^2 has no cross terms). Computed in float64 as
    the reference computes them, so the float32 tables are bit-equal."""
    thetas = np.arange(num_angles, dtype=np.float64) * (math.pi / num_angles)
    U = np.zeros((num_angles, 11))
    for n, t in enumerate(thetas):
        c, s = math.cos(t), math.sin(t)
        U[n, :5] = [c**4, -4 * c**3 * s, 6 * c**2 * s**2, -4 * c * s**3, s**4]
        U[n, 5:] = [
            c**5, -5 * c**4 * s, 10 * c**3 * s**2,
            -10 * c**2 * s**3, 5 * c * s**4, -(s**5),
        ]
    P = np.einsum("ni,nj->nij", U, U)
    mask = np.zeros((11, 11))
    mask[:5, :5] = 1.0
    mask[5:, 5:] = 1.0
    P = P * mask
    n = float(num_angles)
    M1 = P.sum(0) / n
    M2 = np.einsum("n,nij->ij", np.cos(2.0 * thetas), P) * (2.0 / n)
    M3 = np.einsum("n,nij->ij", np.sin(2.0 * thetas), P) * (2.0 / n)
    return M1.astype(np.float32), M2.astype(np.float32), M3.astype(np.float32)


@functools.lru_cache(maxsize=None)
def g4_quad_terms():
    """Unique (i, j, w2, w3) products, i <= j, of the symmetrized c2/c3
    tables with a weight above 1e-7 (33 terms): the product list of the
    fused G4 maps kernel (the reference's pallas_frontend._g4_quad_terms)."""
    _, M2, M3 = _energy_quadratic_tables()
    M2s = (M2 + M2.T) / 2.0
    M3s = (M3 + M3.T) / 2.0
    terms = []
    for i in range(11):
        for j in range(i, 11):
            f = 1.0 if i == j else 2.0
            w2, w3 = f * float(M2s[i, j]), f * float(M3s[i, j])
            if abs(w2) > 1e-7 or abs(w3) > 1e-7:
                terms.append((i, j, w2, w3))
    return tuple(terms)


def _quad_form(M: np.ndarray, basis: torch.Tensor) -> torch.Tensor:
    """sum_ij M_ij b_i b_j per pixel: one channel mix, one reduction (fp32,
    TF32 off)."""
    m = torch.as_tensor(M, dtype=basis.dtype, device=basis.device)
    with precise():
        t = torch.einsum("ij,...jyx->...iyx", m, basis)
    return torch.sum(basis * t, dim=-3)


def energy_coefficients(basis: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c1, c2, c3): the DC and second-harmonic coefficients of E(theta),
    with the meaning of the G2 counterparts."""
    M1, M2, M3 = _energy_quadratic_tables()
    return _quad_form(M1, basis), _quad_form(M2, basis), _quad_form(M3, basis)


def dominant_orientation(c2: torch.Tensor, c3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta, strength) from the second harmonic — the G2 convention."""
    return 0.5 * torch.atan2(c3, c2), torch.hypot(c2, c3)


def oriented_energy(basis: torch.Tensor, theta) -> torch.Tensor:
    """Exact E(theta) = G4(theta)^2 + H4(theta)^2 at scalar or map theta."""
    g4t, h4t = steer(basis, theta)
    return g4t * g4t + h4t * h4t


class G4Maps(NamedTuple):
    g4: torch.Tensor
    h4: torch.Tensor
    energy: torch.Tensor
    magnitude: torch.Tensor
    phase: torch.Tensor
    theta: torch.Tensor
    strength: torch.Tensor


def g4_maps_from_basis(basis: torch.Tensor) -> G4Maps:
    """Orientation -> steered quadrature maps from a G4/H4 basis."""
    c1, c2, c3 = energy_coefficients(basis)
    theta, strength = dominant_orientation(c2, c3)
    g4v, h4v = steer(basis, theta)
    magnitude, phase = magnitude_phase(g4v, h4v)
    e = c1 + torch.cos(2.0 * theta) * c2 + torch.sin(2.0 * theta) * c3
    return G4Maps(
        g4=g4v, h4=h4v, energy=e, magnitude=magnitude, phase=phase,
        theta=theta, strength=strength,
    )


def steerable_pipeline_g4(image: torch.Tensor, bank: Optional[G4Bank] = None) -> G4Maps:
    """Full G4 analysis: basis -> orientation -> steered quadrature maps."""
    return g4_maps_from_basis(g4_basis(image, bank))

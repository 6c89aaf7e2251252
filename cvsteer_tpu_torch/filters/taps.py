"""Analytic 1-D tap functions and kernel sampling for steerable filter banks.

Freeman & Adelson (PAMI 1991, Appendix tables) define separable x/y basis
filters for the steerable quadrature pairs G2/H2 (2nd derivative of Gaussian
and its Hilbert transform) and G4/H4. Each 2-D basis filter is an outer
product of two 1-D taps sampled on a uniform grid.

Reference behavior reproduced here (cited for parity checking, not copied):
- tap formulas:      cvsteer/SteerableFiltersG2.cpp:35-42, SteerableFiltersG4.cpp:34-45
- kernel sampling:   cvsteer/SteerableFilters.cpp:33-42  (x = i*spacing, i in [-w, w])
- separable pairing: cvsteer/SteerableFiltersG2.cpp:62-68, SteerableFiltersG4.cpp:69-81
- defaults:          G2 width=4 spacing=0.67 (SteerableFiltersG2.h:38),
                     G4 width=6 spacing=0.5  (SteerableFiltersG4.h:38)

A bank is a pair of stacked tap matrices ``(xtaps[K,T], ytaps[K,T])`` — one
row per 2-D basis filter — applied as one batched separable bank
(cvsteer_tpu_torch.ops.cuda_frontend.filter_bank). This module is a copy of
cvsteer_tpu.filters.taps: the sampling code is identical, so the taps are
bit-identical to the reference package's.

All sampling is done in float64 numpy when a bank is built (taps are tiny
constants) and stored as float32.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Analytic tap functions (Freeman & Adelson table coefficients).
# Each maps a sample position x -> tap value. Pure numpy, float64.
# ---------------------------------------------------------------------------


def _gauss(x: np.ndarray) -> np.ndarray:
    return np.exp(-(x * x))


# --- G2 (2nd derivative of Gaussian), 3 basis filters from 3 unique taps ----
def g2_f1(x):  # 0.9213 (2x^2 - 1) e^{-x^2}
    return 0.9213 * (2.0 * x * x - 1.0) * _gauss(x)


def g2_f2(x):  # e^{-x^2}
    return _gauss(x)


def g2_f3(x):  # sqrt(1.8430) x e^{-x^2}
    return math.sqrt(1.8430) * x * _gauss(x)


# --- H2 (Hilbert transform of G2), 4 basis filters from 4 unique taps ------
def h2_f1(x):  # 0.9780 (-2.254 x + x^3) e^{-x^2}
    return 0.9780 * (-2.254 * x + x**3) * _gauss(x)


def h2_f2(x):
    return _gauss(x)


def h2_f3(x):
    return x * _gauss(x)


def h2_f4(x):  # 0.9780 (-0.7515 + x^2) e^{-x^2}
    return 0.9780 * (-0.7515 + x * x) * _gauss(x)


# --- G4, 5 basis filters from 5 unique taps ---------------------------------
def g4_f1(x):
    return 1.246 * (0.75 - 3.0 * x * x + x**4) * _gauss(x)


def g4_f2(x):
    return _gauss(x)


def g4_f3(x):
    return (-1.5 * x + x**3) * _gauss(x)


def g4_f4(x):
    return 1.246 * x * _gauss(x)


def g4_f5(x):
    return math.sqrt(1.246) * (x * x - 0.5) * _gauss(x)


# --- H4, 6 basis filters from 6 unique taps ---------------------------------
def h4_f1(x):
    return 0.3975 * (7.189 * x - 7.501 * x**3 + x**5) * _gauss(x)


def h4_f2(x):
    return _gauss(x)


def h4_f3(x):
    return 0.3975 * (1.438 - 4.501 * x * x + x**4) * _gauss(x)


def h4_f4(x):
    return x * _gauss(x)


def h4_f5(x):
    return 0.3975 * (x**3 - 2.225 * x) * _gauss(x)


def h4_f6(x):
    return (x * x - 0.6638) * _gauss(x)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample_taps(width: int, spacing: float, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Sample an analytic tap function on the uniform grid ``x = i*spacing``.

    ``i`` ranges over ``[-width, width]`` inclusive, giving ``2*width+1`` taps
    (parity with cvsteer/SteerableFilters.cpp:33-42). float32 output — the
    reference evaluates the formulas in double and stores to Mat1f, so we
    sample in float64 and cast once.
    """
    x = np.arange(-width, width + 1, dtype=np.float64) * float(spacing)
    return np.asarray(fn(x), dtype=np.float32)


class SeparableBank(NamedTuple):
    """A stacked separable filter bank.

    xtaps[K, T]: horizontal (row-direction, along image width) taps per basis.
    ytaps[K, T]: vertical (column-direction, along image height) taps per basis.
    names:       basis-image names in stacking order.

    Semantics are cross-correlation (OpenCV ``sepFilter2D`` convention): the
    basis image k is ``sum_{u,v} img[y+u, x+v] * ytaps[k, u+w] * xtaps[k, v+w]``
    with REFLECT_101 boundary handling.
    """

    xtaps: np.ndarray
    ytaps: np.ndarray
    names: Tuple[str, ...]

    @property
    def num_filters(self) -> int:
        return self.xtaps.shape[0]

    @property
    def num_taps(self) -> int:
        return self.xtaps.shape[1]

    @property
    def radius(self) -> int:
        return (self.xtaps.shape[1] - 1) // 2


# Pairings: (x_tap_fn, y_tap_fn) per basis image, matching the reference's
# sepFilter2D calls where kernelX filters along rows (width) and kernelY.t()
# filters along columns (height).
_G2_PAIRS: Sequence[Tuple[str, Callable, Callable]] = (
    # cvsteer/SteerableFiltersG2.cpp:62-68
    ("g2a", g2_f1, g2_f2),
    ("g2b", g2_f3, g2_f3),
    ("g2c", g2_f2, g2_f1),
    ("h2a", h2_f1, h2_f2),
    ("h2b", h2_f4, h2_f3),
    ("h2c", h2_f3, h2_f4),
    ("h2d", h2_f2, h2_f1),
)

_G4_PAIRS: Sequence[Tuple[str, Callable, Callable]] = (
    # cvsteer/SteerableFiltersG4.cpp:69-81
    ("g4a", g4_f1, g4_f2),
    ("g4b", g4_f3, g4_f4),
    ("g4c", g4_f5, g4_f5),
    ("g4d", g4_f4, g4_f3),
    ("g4e", g4_f2, g4_f1),
    ("h4a", h4_f1, h4_f2),
    ("h4b", h4_f3, h4_f4),
    ("h4c", h4_f5, h4_f6),
    ("h4d", h4_f6, h4_f5),
    ("h4e", h4_f4, h4_f3),
    ("h4f", h4_f2, h4_f1),
)


def _build_bank(pairs, width: int, spacing: float) -> SeparableBank:
    names = tuple(name for name, _, _ in pairs)
    xtaps = np.stack([sample_taps(width, spacing, fx) for _, fx, _ in pairs])
    ytaps = np.stack([sample_taps(width, spacing, fy) for _, _, fy in pairs])
    return SeparableBank(xtaps=xtaps, ytaps=ytaps, names=names)


G2_DEFAULT_WIDTH, G2_DEFAULT_SPACING = 4, 0.67
G4_DEFAULT_WIDTH, G4_DEFAULT_SPACING = 6, 0.5


def g2h2_bank(width: int = G2_DEFAULT_WIDTH, spacing: float = G2_DEFAULT_SPACING) -> SeparableBank:
    """The 7-filter G2/H2 bank: basis order (g2a, g2b, g2c, h2a, h2b, h2c, h2d)."""
    return _build_bank(_G2_PAIRS, width, spacing)


def g4h4_bank(width: int = G4_DEFAULT_WIDTH, spacing: float = G4_DEFAULT_SPACING) -> SeparableBank:
    """The 11-filter G4/H4 bank: (g4a..g4e, h4a..h4f)."""
    return _build_bank(_G4_PAIRS, width, spacing)

"""Essential-matrix estimation: normalized 8-point + fixed-iteration RANSAC
(twin of cvsteer_tpu.geometry.epipolar).

RANSAC is one batch over a static number of hypotheses: minimal sets come
from a random top-k over valid slots (no rejection loop), each hypothesis
is the smallest eigenvector of its 9x9 normal matrix (batched eigh), and
the winner is refit on its inliers and polished by Gauss-Newton on the
Sampson residual (LO-RANSAC). Inputs are normalized camera coordinates
(x, y) [N, 2].

Random numbers come from a ``torch.Generator``; the reference draws from
``jax.random``, and the two never give the same numbers, so tests inject
the minimal sets (``sets=``) instead of comparing streams.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cvsteer_tpu_torch.utils.precision import precise


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows a_i with a_i . vec(E) = x2_i^T E x1_i; [N, 9], vec row-major."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    return (p2[:, :, None] * p1[:, None, :]).reshape(p1.shape[0], 9)


def _project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (s, s, 0), s = mean."""
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S_new = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * S_new[..., None, :]) @ Vt


@precise()
def eight_point_essential(x1, x2, weights) -> torch.Tensor:
    """Weighted 8-point E from the smallest eigenvector of the 9x9 normal
    matrix; ``weights`` may carry a leading batch axis ([S, N] -> [S, 3, 3])."""
    rows = _epipolar_rows(x1, x2)  # [N, 9]
    wrows = rows * weights[..., :, None]
    AtA = wrows.transpose(-1, -2) @ rows  # [..., 9, 9]
    _, v = torch.linalg.eigh(AtA)
    E = v[..., :, 0].reshape(weights.shape[:-1] + (3, 3))
    return _project_to_essential(E)


@precise()
def eight_point_essential_svd(x1, x2, weights) -> torch.Tensor:
    """Weighted 8-point via the SVD of the row matrix (better conditioned
    for over-determined refits)."""
    rows = _epipolar_rows(x1, x2)
    wrows = rows * weights[:, None]
    _, _, Vt = torch.linalg.svd(wrows, full_matrices=False)
    return _project_to_essential(Vt[-1, :].reshape(3, 3))


@precise()
def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Sampson error of x2^T E x1 = 0; ``E [..., 3, 3]`` -> ``[..., N]``."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    Ep1 = p1 @ E.transpose(-1, -2)  # [..., N, 3]
    Etp2 = p2 @ E
    num = torch.sum(p2 * Ep1, dim=-1) ** 2
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


class RansacResult(NamedTuple):
    E: torch.Tensor  # [3, 3] best essential matrix (refit on inliers)
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # scalar
    best_error: torch.Tensor  # mean Sampson error over inliers


def sample_minimal_sets(
    generator: torch.Generator, valid: torch.Tensor, num_sets: int, set_size: int
) -> torch.Tensor:
    """[num_sets, set_size] random distinct indices drawn from valid slots
    (random-key top-k; invalid slots get +inf keys)."""
    n = valid.shape[0]
    u = torch.rand((num_sets, n), generator=generator, device=generator.device)
    u = torch.where(valid[None, :], u.to(valid.device), float("inf"))
    return torch.topk(-u, set_size, dim=1).indices


def _sampson_residual_and_jacobian(e, p1, p2, w):
    """Signed weighted Sampson residual of vec(E) = e [9] and its
    Jacobian [N, 9] (analytic)."""
    E = e.reshape(3, 3)
    Ep1 = p1 @ E.T  # [N, 3]
    Etp2 = p2 @ E
    num = torch.sum(p2 * Ep1, dim=-1)
    den = torch.sqrt(
        Ep1[:, 0] ** 2 + Ep1[:, 1] ** 2 + Etp2[:, 0] ** 2 + Etp2[:, 1] ** 2 + 1e-18
    )
    r = w * num / den
    # d num / d E_jk = p2_j p1_k; d (Ep1_m) / d E_mk = p1_k (m = 0, 1);
    # d (Etp2_k) / d E_jk = p2_j (k = 0, 1)
    dnum = (p2[:, :, None] * p1[:, None, :]).reshape(-1, 9)
    dden2 = torch.zeros_like(dnum).reshape(-1, 3, 3)
    dden2[:, 0, :] += 2.0 * Ep1[:, 0:1] * p1
    dden2[:, 1, :] += 2.0 * Ep1[:, 1:2] * p1
    dden2[:, :, 0] += 2.0 * Etp2[:, 0:1] * p2
    dden2[:, :, 1] += 2.0 * Etp2[:, 1:2] * p2
    dden = dden2.reshape(-1, 9) / (2.0 * den[:, None])
    J = w[:, None] * (dnum * den[:, None] - num[:, None] * dden) / (den * den)[:, None]
    return r, J


@precise()
def polish_essential(E, x1, x2, weights, *, iterations: int = 6) -> torch.Tensor:
    """Gauss-Newton refinement of E on weighted correspondences (the LO of
    LO-RANSAC): minimize the summed squared Sampson residual over vec(E),
    reprojecting onto the essential manifold each step and accepting only
    cost-decreasing steps."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    sqrt2 = 2.0 ** 0.5
    eye9 = torch.eye(9, dtype=E.dtype, device=E.device)

    def norm_e(e):
        return e * (sqrt2 / torch.clamp_min(torch.linalg.vector_norm(e), 1e-12))

    def cost(e):
        r, _ = _sampson_residual_and_jacobian(e, p1, p2, weights)
        return torch.sum(r * r)

    e = norm_e(E.reshape(9))
    c_e = cost(e)
    for _ in range(iterations):
        r, J = _sampson_residual_and_jacobian(e, p1, p2, weights)
        H = J.T @ J + 1e-10 * eye9
        g = J.T @ r
        e_new = e - torch.linalg.solve(H, g)
        e_new = norm_e(_project_to_essential(e_new.reshape(3, 3)).reshape(9))
        c_new = cost(e_new)
        better = c_new < c_e
        e = torch.where(better, e_new, e)
        c_e = torch.where(better, c_new, c_e)
    return e.reshape(3, 3)


@precise()
def ransac_essential(
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    num_hypotheses: int = 512,
    inlier_threshold: float = 1e-5,
    refit_rounds: int = 3,
    sets: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Fixed-iteration RANSAC for E from masked correspondences.

    x1, x2: [N, 2] normalized coords; valid: [N] mask. ``sets [S, 8]``
    injects the minimal sets (test seam); otherwise ``num_hypotheses`` sets
    are drawn with ``generator``. ``inlier_threshold`` bounds the Sampson
    error in normalized units (1e-5 is ~1.6 px at f = 500)."""
    dtype = x1.dtype
    if sets is None:
        sets = sample_minimal_sets(generator, valid, num_hypotheses, 8)
    sets = sets.to(x1.device)
    S = sets.shape[0]
    w = torch.zeros((S, x1.shape[0]), dtype=dtype, device=x1.device)
    w.scatter_(1, sets, 1.0)
    Es = eight_point_essential(x1, x2, w)  # [S, 3, 3]

    errs = sampson_error(Es, x1, x2)  # [S, N]
    inl = (errs < inlier_threshold) & valid[None, :]
    counts = inl.sum(dim=1)
    # inlier count with a continuous MSAC tie-break normalized into (0, 1)
    msac = torch.sum(
        torch.where(valid[None, :], torch.clamp_max(errs, inlier_threshold), 0.0),
        dim=1,
    )
    n_valid = torch.clamp_min(valid.sum(), 1)
    tie = msac / (inlier_threshold * n_valid.to(dtype) + 1e-30)
    best = torch.argmax(counts.to(dtype) - tie)
    E = Es[best]
    inliers = inl[best]

    for _ in range(refit_rounds):
        E = eight_point_essential_svd(x1, x2, inliers.to(dtype))
        inliers = (sampson_error(E, x1, x2) < inlier_threshold) & valid

    E_lo = polish_essential(E, x1, x2, inliers.to(dtype))
    inl_lo = (sampson_error(E_lo, x1, x2) < inlier_threshold) & valid
    better = inl_lo.sum() >= inliers.sum()
    E = torch.where(better, E_lo, E)
    inliers = torch.where(better, inl_lo, inliers)

    err = sampson_error(E, x1, x2)
    num = inliers.sum()
    mean_err = torch.sum(torch.where(inliers, err, 0.0)) / torch.clamp_min(num, 1)
    return RansacResult(E=E, inliers=inliers, num_inliers=num, best_error=mean_err)

"""Landmark-sharded bundle adjustment over a mesh axis (the twin of
cvsteer_tpu.parallel.ba_sharded).

The Schur complement separates over the landmarks, so the landmarks are
what is split: each rank of the ``lm_axis`` group holds an L/n slice of the
landmarks (X and its columns of the observation grid) and every camera.
Per LM iteration the reduced camera system's pieces are summed over the
ranks in one all-reduce of C^2 36 + C 36 + 2 C 6 floats, and each cost in
one scalar all-reduce (slam.ba, ``group``); every rank solves the same
summed camera system, and the landmark back-substitution stays local. The
traffic does not grow with L.

As in parallel.frontend_sharded, every rank is called with the whole
problem and cuts its own part: :func:`bundle_adjust_sharded` takes the
whole problem (or :func:`place_ba_inputs`' shards) and returns the cameras
(replicated) and X gathered once after the LM loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cvsteer_tpu_torch.parallel import halo
from cvsteer_tpu_torch.parallel.mesh import rank_device, sharded_axis
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, BAStats, bundle_adjust


class LandmarkShard(BAProblem):
    """One rank's landmark slice of a padded BAProblem (uv [C, L/n, 2],
    mask [C, L/n]), as :func:`place_ba_inputs` returns it."""

    __slots__ = ()


def _pad_rows(a: torch.Tensor, dim: int, pad: int, value) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, torch.full(shape, value, dtype=a.dtype, device=a.device)], dim)


def pad_landmarks(problem: BAProblem, state: BAState,
                  num_shards: int) -> Tuple[BAProblem, BAState, int]:
    """(problem, state, L): L padded up to a multiple of ``num_shards`` with
    masked-out landmarks at X = 1 (in front of every camera, so the depth
    guards stay quiet); L is the original count."""
    L = state.X.shape[0]
    pad = -(-L // num_shards) * num_shards - L
    if pad == 0:
        return problem, state, L
    problem = problem._replace(uv=_pad_rows(problem.uv, 1, pad, 0.0),
                               mask=_pad_rows(problem.mask, 1, pad, False))
    return problem, state._replace(X=_pad_rows(state.X, 0, pad, 1.0)), L


def _cut(problem: BAProblem, state: BAState, n: int, idx: int, device):
    """This rank's landmark slice (``idx`` of ``n``) of a padded problem."""
    Ll = state.X.shape[0] // n
    sl = slice(idx * Ll, (idx + 1) * Ll)
    shard = LandmarkShard(
        uv=problem.uv[:, sl].to(device).contiguous(), mask=problem.mask[:, sl].to(device).contiguous(),
        fixed_cameras=problem.fixed_cameras.to(device), huber_delta=problem.huber_delta,
    )
    return shard, BAState(R=state.R.to(device), t=state.t.to(device),
                          X=state.X[sl].to(device).contiguous())


def place_ba_inputs(state: BAState, problem: BAProblem, mesh, lm_axis: str = "data"):
    """(state, problem, L): L padded to the shard count and this rank's
    landmark shard on its device (a :class:`LandmarkShard`; the cameras
    whole). :func:`bundle_adjust_sharded` takes them as they are and returns
    X of the padded length: crop it with ``X[:L]``."""
    n, idx, _ = sharded_axis(mesh, lm_axis)
    problem, state, L = pad_landmarks(problem, state, n)
    shard, st = _cut(problem, state, n, idx, rank_device(mesh))
    return st, shard, L


def bundle_adjust_sharded(
    state: BAState,
    problem: BAProblem,
    mesh,
    *,
    lm_axis: str = "data",
    iterations: int = 20,
    lam0: float = 1e-4,
) -> Tuple[BAState, BAStats]:
    """Levenberg-Marquardt BA with the landmarks sharded over ``lm_axis`` of
    ``mesh``: the same result as slam.ba.bundle_adjust up to the order of
    the sums over the shards. Every rank of the mesh calls it with the
    whole problem (cut here) or with its :func:`place_ba_inputs` shard.
    Returns R and t (the same on every rank), X gathered from the shards
    (cropped to the original L for a whole problem), and the summed costs."""
    n, idx, group = sharded_axis(mesh, lm_axis)
    if isinstance(problem, LandmarkShard):
        L = None
    else:
        problem, state, L = pad_landmarks(problem, state, n)
        problem, state = _cut(problem, state, n, idx, rank_device(mesh))
    out, stats = bundle_adjust(state, BAProblem(*problem), iterations=iterations, lam0=lam0,
                               group=group)
    X = torch.cat(halo.all_gather(out.X, group), 0)
    return out._replace(X=X if L is None else X[:L]), stats

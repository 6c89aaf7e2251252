"""Masked descriptor matching (twin of cvsteer_tpu.features.matching).

The similarity matrix is one [N, M] fp32 matmul of unit descriptors (cosine
similarity), followed by a Lowe ratio test on the equivalent L2 distances
(d^2 = 2 - 2 s) and a mutual nearest-neighbour check. Invalid rows and
columns are masked, never dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvsteer_tpu_torch.utils.precision import precise


class Matches(NamedTuple):
    """index [N]: best match in B for each A keypoint (-1 = unmatched);
    score [N]: cosine similarity of the match; valid [N]: mask."""

    index: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)


@precise()
def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    *,
    ratio: float = 0.8,
    min_similarity: float = -1.0,
    mutual: bool = True,
) -> Matches:
    """Match unit descriptors ``desc_a [N, D]`` to ``desc_b [M, D]``.

    ``ratio``: Lowe ratio bound on L2 distances (best/second-best); 1.0
    disables the test."""
    sim = desc_a @ desc_b.T
    neg = -2.0  # below any cosine similarity
    sim = torch.where(valid_a[:, None] & valid_b[None, :], sim, neg)

    top2, top2_idx = torch.topk(sim, 2, dim=1)
    best, second = top2[:, 0], top2[:, 1]
    best_idx = top2_idx[:, 0]

    d1 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * best, 0.0))
    d2 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * second, 0.0))
    ok = valid_a & (best > min_similarity) & (best > neg) & (d1 <= ratio * d2)

    if mutual:
        rev_best = torch.argmax(sim, dim=0)  # [M]: best A for each B
        ok &= rev_best[best_idx] == torch.arange(sim.shape[0], device=sim.device)

    return Matches(
        index=torch.where(ok, best_idx, -1),
        score=torch.where(ok, best, 0.0),
        valid=ok,
    )


def gather_matched_points(yx_a: torch.Tensor, yx_b: torch.Tensor, matches: Matches):
    """Aligned point pairs (pts_a [N,2], pts_b [N,2], mask [N]) from matches."""
    idx = torch.clamp_min(matches.index, 0)
    return yx_a, yx_b[idx], matches.valid

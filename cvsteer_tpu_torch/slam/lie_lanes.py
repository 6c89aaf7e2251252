"""Batched Lie-group helpers for the pose-graph solvers (twin of
cvsteer_tpu.slam.lie_lanes).

The reference splits each matrix into nested lists of ``[E]`` lane arrays
for the TPU's vector registers. In PyTorch the batch axis leads instead: a
rotation is ``[..., 3, 3]``, a translation ``[..., 3]``, a tangent
``[..., 6]`` (or ``[..., 7]``). The function names are the reference's, so
slam.posegraph reads like its counterpart; exp and log are slam.se3's
(the reference's lane versions mirror se3 exactly, near pi included).
Every function here is plain elementwise or batched-matmul torch code, so
``torch.func.jvp`` and ``vmap`` go through it: the pose graphs take their
edge Jacobians that way.
"""

from __future__ import annotations

import torch

from cvsteer_tpu_torch.slam.se3 import exp_se3, exp_so3, log_so3

__all__ = [
    "add", "exp_se3", "exp_so3", "log_so3", "matmul", "matvec", "neg", "onehot",
    "scale", "sub", "transpose",
]


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] x [..., 3] -> [..., 3]."""
    return (A @ v[..., None])[..., 0]


def transpose(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def add(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u + v


def sub(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u - v


def neg(v: torch.Tensor) -> torch.Tensor:
    return -v


def scale(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row scalar ``s [...]`` times ``v [..., k]``."""
    return s[..., None] * v


def onehot(idx: torch.Tensor, num: int, dtype=torch.float32) -> torch.Tensor:
    """[E] int -> [E, num] one-hot: scatter-adds as one matmul (deterministic
    on the card, where ``index_add_`` sums repeated indices in no fixed
    order)."""
    return (idx[:, None] == torch.arange(num, device=idx.device, dtype=idx.dtype)).to(dtype)

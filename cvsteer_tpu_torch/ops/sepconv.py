"""Separable filter bank, plain PyTorch (the twin of cvsteer_tpu.ops.sepconv).

    image[..., H, W]  ->  basis[..., K, H, W]

Semantics match the reference package for golden parity: cross-correlation,
BORDER_REFLECT_101 boundary (``gfedcb|abcdefgh|gfedcba``), float32
arithmetic. The plain bank is a shift-and-accumulate over the taps — row
pass, then column pass, taps in order — with no convolution library call,
so no TF32 path exists (cuDNN runs fp32 convolutions in TF32 by default on
the card) and the sums run in exactly the order kernel A
(kernels/csrc/filter_bank.cu) uses.

Padding goes through an index map that keeps reflecting
(:func:`reflect_indices`), as ``jnp.pad(mode='reflect')`` does: unlike
``F.pad(mode='reflect')`` it stays defined where the pad reaches past the
whole dimension (tiny pyramid levels).
"""

from __future__ import annotations

import numpy as np
import torch


def reflect_indices(lo: int, hi: int, n: int, device=None) -> torch.Tensor:
    """REFLECT_101 source index of every position in ``[lo, hi)`` of an axis
    of length ``n``, reflecting repeatedly (period ``2 (n - 1)``)."""
    i = torch.arange(lo, hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def reflect_pad_2d(image: torch.Tensor, radius: int) -> torch.Tensor:
    """REFLECT_101 padding of the trailing two axes by ``radius``."""
    if radius == 0:
        return image
    *_, h, w = image.shape
    rows = reflect_indices(-radius, h + radius, h, image.device)
    cols = reflect_indices(-radius, w + radius, w, image.device)
    return image.index_select(-2, rows).index_select(-1, cols)


def filter_bank_plain(image: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """Apply a stacked separable bank ``xtaps/ytaps [K, T]`` to
    ``image [..., H, W]``; returns ``[..., K, H, W]`` float32."""
    xt = torch.as_tensor(np.asarray(xtaps, np.float32), device=image.device)
    yt = torch.as_tensor(np.asarray(ytaps, np.float32), device=image.device)
    K, T = xt.shape
    r = (T - 1) // 2
    *_, h, w = image.shape
    padded = reflect_pad_2d(image.to(torch.float32), r).unsqueeze(-3)
    xk = xt[:, :, None, None]  # [K, T, 1, 1] broadcasts over [..., 1, Hp, W]
    yk = yt[:, :, None, None]
    row = padded[..., :, 0:w] * xk[:, 0]
    for t in range(1, T):
        row = row + padded[..., :, t : t + w] * xk[:, t]
    col = row[..., 0:h, :] * yk[:, 0]
    for t in range(1, T):
        col = col + row[..., t : t + h, :] * yk[:, t]
    return col

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


def reflect_pad_2d(image: torch.Tensor, radius: int, axes=(True, True)) -> torch.Tensor:
    """REFLECT_101 padding of the trailing two axes by ``radius``.

    ``axes``: (pad_height, pad_width); an axis that already carries halo
    rows (spatially sharded execution, cvsteer_tpu_torch.parallel.halo) is
    skipped."""
    if radius == 0:
        return image
    *_, h, w = image.shape
    if axes[0]:
        image = image.index_select(-2, reflect_indices(-radius, h + radius, h, image.device))
    if axes[1]:
        image = image.index_select(-1, reflect_indices(-radius, w + radius, w, image.device))
    return image


def filter_bank_xla(image: torch.Tensor, xtaps, ytaps, *, pad_axes=(True, True)) -> torch.Tensor:
    """Apply a stacked separable bank ``xtaps/ytaps [K, T]`` to
    ``image [..., H, W]``; returns ``[..., K, H', W']`` float32.

    ``pad_axes``: which of (H, W) to REFLECT_101-pad. Pass ``(False, True)``
    when H already carries ``radius`` halo rows from a neighbour exchange;
    the output is then ``radius`` rows shorter on each side (H' = H - 2r).
    The name is the reference's (its version is XLA convolutions); here it
    is the shift-and-add loop, so rows computed from halo rows are bit for
    bit the rows of the padded whole."""
    xt = torch.as_tensor(np.asarray(xtaps, np.float32), device=image.device)
    yt = torch.as_tensor(np.asarray(ytaps, np.float32), device=image.device)
    K, T = xt.shape
    r = (T - 1) // 2
    padded = reflect_pad_2d(image.to(torch.float32), r, pad_axes).unsqueeze(-3)
    h, w = padded.shape[-2] - 2 * r, padded.shape[-1] - 2 * r
    xk = xt[:, :, None, None]  # [K, T, 1, 1] broadcasts over [..., 1, Hp, W]
    yk = yt[:, :, None, None]
    row = padded[..., :, 0:w] * xk[:, 0]
    for t in range(1, T):
        row = row + padded[..., :, t : t + w] * xk[:, t]
    col = row[..., 0:h, :] * yk[:, 0]
    for t in range(1, T):
        col = col + row[..., t : t + h, :] * yk[:, t]
    return col


#: Kernel A's plain version (both axes padded), and the reference's
#: independent shift-and-add oracle: in the port the bank itself is that loop.
filter_bank_plain = filter_bank_shifts = filter_bank_xla

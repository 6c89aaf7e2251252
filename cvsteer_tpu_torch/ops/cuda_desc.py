"""Descriptor sampling kernel D with its plain PyTorch version.

The port's counterpart of cvsteer_tpu.ops.pallas_desc: bilinear samples of
the basis ``[B, C, H, W]`` at each keypoint's rotated sample grid
``ys/xs [B, K, S]`` -> ``[B, K, S, C]`` float32, with coordinates clipped
to the image as the TPU wrapper clips them. Kernel D
(``kernels/csrc/desc_sample.cu``) reads fp32 corners, so it is at least as
accurate as the reference's bf16 sampling class. :func:`sample_patches_levels`
samples the keypoints of every pyramid level in one launch;
:func:`sample_patches` is its one-level case.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, and adds one to the
``desc_sample`` launch count where it launches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops.cuda_frontend import _MAX_LEVELS, _host, _on_cpu, _require
from cvsteer_tpu_torch.ops.interp import bilinear_sample_channels_last

_MAX_SAMPLES = 64  # kernel D: samples per keypoint
_MAX_CHANNELS = 16  # kernel D: basis channels (7 for G2/H2, 11 for G4/H4)


def sample_patches_plain(
    basis: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """fp32 bilinear samples, one image of the batch at a time."""
    return torch.stack([
        bilinear_sample_channels_last(b.movedim(0, -1), y, x)
        for b, y, x in zip(basis.to(torch.float32), ys, xs)
    ])


def sample_patches_levels_plain(
    bases: Sequence[torch.Tensor], ys: torch.Tensor, xs: torch.Tensor, counts: Sequence[int]
) -> torch.Tensor:
    """A loop of :func:`sample_patches_plain` over the levels' keypoints."""
    bounds = np.cumsum([0, *counts])
    return torch.cat([
        sample_patches_plain(b, ys[:, k0:k1], xs[:, k0:k1])
        for b, k0, k1 in zip(bases, bounds[:-1], bounds[1:])
    ], dim=1)


def sample_patches_levels(
    bases: Sequence[torch.Tensor], ys: torch.Tensor, xs: torch.Tensor, counts: Sequence[int]
) -> torch.Tensor:
    """Samples of several levels' keypoints in one call.

    ``bases``: each level's basis ``[B, C, H_l, W_l]``; ``ys/xs [B, K, S]``
    hold the keypoints of level 0, then those of level 1, ..., ``counts[l]``
    of level l (summing to K) -> ``[B, K, S, C]``, each level's keypoints
    sampled from its basis (C <= 16: the G2/H2 basis's 7 channels or the
    G4/H4 basis's 11). On the card: one launch of kernel D."""
    bases, counts = list(bases), [int(c) for c in counts]
    if len(bases) != len(counts) or sum(counts) != ys.shape[-2]:
        raise ValueError(f"sample_patches: counts {counts} for {len(bases)} levels, "
                         f"K = {ys.shape[-2]}")
    if all(_on_cpu(t) for t in (*bases, ys, xs)):
        return sample_patches_levels_plain(bases, ys, xs, counts)
    for t, name in [*((b, "basis") for b in bases), (ys, "ys"), (xs, "xs")]:
        _require(t, name, 3)
        if t.device != ys.device:
            raise ValueError(f"{name} on {t.device}, ys on {ys.device}")
    if ys.dim() != 3 or ys.shape != xs.shape or not 1 <= len(bases) <= _MAX_LEVELS:
        raise ValueError(f"sample_patches: ys {tuple(ys.shape)}, xs {tuple(xs.shape)}, "
                         f"{len(bases)} levels")
    b, k, s = ys.shape
    c = bases[0].shape[1]
    if s > _MAX_SAMPLES or c > _MAX_CHANNELS or any(
            t.dim() != 4 or t.shape[:2] != (b, c) for t in bases):
        raise ValueError(f"sample_patches: bases {[tuple(t.shape) for t in bases]}, "
                         f"ys {tuple(ys.shape)}")
    out = torch.empty((b, k, s, c), dtype=torch.float32, device=ys.device)
    if b * k * c == 0:
        return out
    ptrs = np.array([t.data_ptr() for t in bases], np.int64)
    hw = np.array([t.shape[-2:] for t in bases], np.int32)
    cnt = np.array(counts, np.int32)
    lib = kernels.library()
    kernels.count_launch("desc_sample")
    err = lib.cvs_desc_sample(
        _host(ptrs), _host(hw), _host(cnt), len(bases), ys.data_ptr(), xs.data_ptr(),
        out.data_ptr(), b, c, k, s, kernels.stream_handle(ys.device),
    )
    kernels.check(err, "desc_sample")
    return out


def sample_patches(
    basis: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """``basis [B, C, H, W]``, ``ys/xs [B, K, S]`` -> ``[B, K, S, C]``."""
    if _on_cpu(basis):
        return sample_patches_plain(basis, ys, xs)
    if ys.dim() != 3:
        raise ValueError(f"sample_patches: ys {tuple(ys.shape)}, expected [B, K, S]")
    return sample_patches_levels([basis], ys, xs, [ys.shape[1]])

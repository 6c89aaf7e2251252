"""Descriptor sampling kernel D with its plain PyTorch version.

The port's counterpart of cvsteer_tpu.ops.pallas_desc: bilinear samples of
the basis ``[B, C, H, W]`` at each keypoint's rotated sample grid
``ys/xs [B, K, S]`` -> ``[B, K, S, C]`` float32, with coordinates clipped
to the image as the TPU wrapper clips them. Kernel D
(``kernels/csrc/desc_sample.cu``) reads fp32 corners, so it is at least as
accurate as the reference's bf16 sampling class.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises, and adds one to the
``desc_sample`` launch count where it launches.
"""

from __future__ import annotations

import torch

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops.cuda_frontend import _on_cpu, _require
from cvsteer_tpu_torch.ops.interp import bilinear_sample_channels_last


def sample_patches_plain(
    basis: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """fp32 bilinear samples, one image of the batch at a time."""
    return torch.stack([
        bilinear_sample_channels_last(b.movedim(0, -1), y, x)
        for b, y, x in zip(basis.to(torch.float32), ys, xs)
    ])


def sample_patches(
    basis: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """``basis [B, C, H, W]``, ``ys/xs [B, K, S]`` -> ``[B, K, S, C]``."""
    if _on_cpu(basis):
        return sample_patches_plain(basis, ys, xs)
    for t, name in ((basis, "basis"), (ys, "ys"), (xs, "xs")):
        _require(t, name, 3)
        if t.device != basis.device:
            raise ValueError(f"{name} on {t.device}, basis on {basis.device}")
    if basis.dim() != 4 or ys.dim() != 3 or ys.shape != xs.shape:
        raise ValueError(
            f"sample_patches: basis {tuple(basis.shape)}, ys {tuple(ys.shape)}, "
            f"xs {tuple(xs.shape)}"
        )
    b, c, h, w = basis.shape
    _, k, s = ys.shape
    if ys.shape[0] != b or s * c > 256:
        raise ValueError(f"sample_patches: unsupported shapes {tuple(ys.shape)}, C={c}")
    out = torch.empty((b, k, s, c), dtype=torch.float32, device=basis.device)
    if b * k == 0:
        return out
    lib = kernels.library()
    kernels.count_launch("desc_sample")
    err = lib.cvs_desc_sample(
        basis.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
        b, c, h, w, k, s, kernels.stream_handle(basis.device),
    )
    kernels.check(err, "desc_sample")
    return out

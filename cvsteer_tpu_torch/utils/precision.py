"""Matmul-precision guard for geometry/SLAM numerics (twin of
cvsteer_tpu.utils.precision).

On the card PyTorch may route float32 products through TF32 (about 10
mantissa bits): matmuls when ``torch.backends.cuda.matmul.allow_tf32`` is
set, and convolutions by default (``torch.backends.cudnn.allow_tf32`` is
True). That is the same class of fault as the TPU's bf16 default, which
silently corrupts the small geometry algebra (8-point normal matrix,
epipolar residuals, triangulation, PnP, BA) whose errors compound into pose
estimates. ``precise`` turns both off for the code it wraps and restores
the caller's settings afterwards::

    @precise()
    def solve(...): ...

    with precise():
        ...
"""

from __future__ import annotations

import contextlib

import torch


class precise(contextlib.ContextDecorator):
    """Context (and decorator) with TF32 off for matmuls and convolutions."""

    def __init__(self):
        self._saved = []

    def __enter__(self):
        self._saved.append(
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        matmul, cudnn = self._saved.pop()
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        return False

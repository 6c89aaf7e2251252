"""Compute primitives: the separable bank, pyramids, bilinear sampling, and
the hand-written kernels' wrappers (the exports of cvsteer_tpu.ops)."""

from cvsteer_tpu_torch.ops.sepconv import (  # noqa: F401
    filter_bank_shifts,
    filter_bank_xla,
    reflect_pad_2d,
)
from cvsteer_tpu_torch.ops.pyramid import gaussian_pyramid, pyr_down  # noqa: F401
from cvsteer_tpu_torch.ops.interp import bilinear_sample  # noqa: F401

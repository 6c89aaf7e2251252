"""Utilities: image post-processing, config, metrics, checkpoints (the
exports of cvsteer_tpu.utils)."""

from cvsteer_tpu_torch.utils.imageproc import (  # noqa: F401
    bgr_to_gray_f32,
    convert_scale_u8,
    normalize_minmax_u8,
)

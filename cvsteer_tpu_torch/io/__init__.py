"""Image IO and dataset loading (the exports of cvsteer_tpu.io)."""

from cvsteer_tpu_torch.io.imageio import (  # noqa: F401
    imdecode_gray_f32,
    imread_gray_f32,
    imwrite_u8,
)
from cvsteer_tpu_torch.io.datasets import Sequence, open_sequence  # noqa: F401

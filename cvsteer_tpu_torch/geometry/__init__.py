"""Two-view epipolar geometry: essential matrix, RANSAC, pose,
triangulation (the exports of cvsteer_tpu.geometry)."""

from cvsteer_tpu_torch.geometry.camera import (  # noqa: F401
    Intrinsics,
    normalize_pixels,
    pixels_from_normalized,
)
from cvsteer_tpu_torch.geometry.epipolar import (  # noqa: F401
    eight_point_essential,
    ransac_essential,
    sampson_error,
)
from cvsteer_tpu_torch.geometry.pose import (  # noqa: F401
    decompose_essential,
    recover_pose,
    triangulate,
)

"""Keypoints, phase descriptors and matching on the steerable front-end
(the exports of cvsteer_tpu.features)."""

from cvsteer_tpu_torch.features.descriptors import (  # noqa: F401
    phase_descriptors,
    phase_descriptors_g4,
)
from cvsteer_tpu_torch.features.frontend import (  # noqa: F401
    Features,
    FrontendConfig,
    extract_features,
)
from cvsteer_tpu_torch.features.keypoints import Keypoints, detect_keypoints  # noqa: F401
from cvsteer_tpu_torch.features.matching import Matches, match_descriptors  # noqa: F401

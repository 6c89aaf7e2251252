"""VO engines, windowed Schur-complement BA and pose graphs (the exports
of cvsteer_tpu.slam)."""

from cvsteer_tpu_torch.slam import se3, sim3  # noqa: F401
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust  # noqa: F401
from cvsteer_tpu_torch.slam.posegraph import (  # noqa: F401
    PoseGraph,
    Poses,
    optimize_pose_graph,
)
from cvsteer_tpu_torch.slam.posegraph_sim3 import (  # noqa: F401
    Sim3Graph,
    optimize_pose_graph_sim3,
)
from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_frame, process_image  # noqa: F401
from cvsteer_tpu_torch.slam.vo_device import (  # noqa: F401
    DeviceVO,
    DeviceVOFleet,
    DeviceVOServer,
)
from cvsteer_tpu_torch.slam.vo_server import VOServer  # noqa: F401

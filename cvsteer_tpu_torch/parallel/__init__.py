"""Meshes, sharding and halo exchange over torch.distributed (the twin of
cvsteer_tpu.parallel).

- data parallelism: the image batch sharded over a ``data`` mesh axis;
- spatial parallelism: image rows sharded over a ``space`` mesh axis, the
  (2 width + 1)-tap convolution's overlap from a ring halo exchange;
- landmark-sharded bundle adjustment (ba_sharded) and the edge-sharded
  pose graph (posegraph_sharded): per LM or CG iteration one all-reduce
  whose size does not grow with the landmarks or edges;
- the stream axis of slam.vo_device.DeviceVOFleet sharded over a mesh axis
  (``mesh=``): each rank steps its own streams;
- the runtime (multihost): joining the world, barriers, a checksum, and a
  heartbeat whose failure callback checkpoints and exits;
- one process per rank (torchrun, or a 1-rank world made by make_mesh),
  every collective through parallel.halo's transport (listed inside
  halo.record_collectives), the heartbeat's probe on a gloo group of its own.
"""

from cvsteer_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from cvsteer_tpu_torch.parallel.halo import halo_exchange_rows  # noqa: F401
from cvsteer_tpu_torch.parallel.frontend_sharded import (  # noqa: F401
    gather_blocks,
    shard_batch,
    sharded_filter_bank,
    sharded_g2_maps,
    sharded_g4_maps,
)
from cvsteer_tpu_torch.parallel.features_sharded import (  # noqa: F401
    sharded_extract_features,
)
from cvsteer_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded  # noqa: F401
from cvsteer_tpu_torch.parallel.posegraph_sharded import optimize_pose_graph_sharded  # noqa: F401

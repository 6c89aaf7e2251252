"""Meshes, sharding and halo exchange over torch.distributed (the twin of
cvsteer_tpu.parallel).

- data parallelism: the image batch sharded over a ``data`` mesh axis;
- spatial parallelism: image rows sharded over a ``space`` mesh axis, the
  (2 width + 1)-tap convolution's overlap from a ring halo exchange;
- one process per rank (torchrun, or a 1-rank world made by make_mesh),
  every collective through parallel.halo's transport.

Still to port: bundle_adjust_sharded and optimize_pose_graph_sharded (the
landmark-sharded BA and the edge-sharded pose graph) and the multi-host
helpers.
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

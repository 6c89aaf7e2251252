"""cvsteer_tpu_torch: the PyTorch + CUDA port of cvsteer_tpu.

The package mirrors cvsteer_tpu's layout (filters/, ops/, features/,
geometry/, slam/, parallel/, io/, utils/, cli.py, cli_vo.py), and each
subpackage re-exports what its counterpart does. It imports torch and
never jax. Plain tensor code is PyTorch; each Pallas kernel of the
reference is a hand-written CUDA kernel for Hopper (sm_90a) under
kernels/csrc/, built on first use, with a plain PyTorch version that runs
on CPU tensors.

Ported: the G2/H2 and G4/H4 filters and dense maps (cli.py), the pyramid
feature front-end (fused and generic), matching, two-view geometry, bundle
adjustment, the host and device VO engines with loop closure and both pose
graphs, serving (VOServer, DeviceVOServer, DeviceVOFleet; cli_vo.py),
checkpoints, and on torch.distributed the mesh, the ring halo exchange, the
sharded maps (cli.py --mesh) and sharded feature extraction. Still to
port: parallel/'s sharded bundle adjustment and pose graph, its multi-host
helpers, and DeviceVOFleet(mesh=).
"""

__version__ = "0.1.0"

from cvsteer_tpu_torch.filters import (  # noqa: F401
    G2Bank,
    G4Bank,
    g2_bank,
    g4_bank,
    steerable_pipeline_g2,
    steerable_pipeline_g4,
)

"""cvsteer_tpu_torch: the PyTorch + CUDA port of cvsteer_tpu.

The package mirrors cvsteer_tpu's layout (filters/, ops/, features/,
geometry/, slam/, io/, utils/, cli_vo.py) so every module's counterpart is
easy to find. It imports torch and never jax. Plain tensor code is PyTorch;
each Pallas kernel of the reference on the ported path is a hand-written
CUDA kernel for Hopper (sm_90a) under kernels/csrc/, built on first use.

Ported so far: the single-stream host VO main path (cli_vo --engine host):
pyramid, fused G2/H2 detector, packed keypoint selection, phase
descriptors, mutual ratio matching, RANSAC two-view bootstrap, PnP
tracking and windowed Schur bundle adjustment.
"""

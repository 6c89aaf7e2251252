"""The benchmark of cvsteer_tpu_torch on one CUDA card (see README.md)."""

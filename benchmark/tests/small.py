"""Small CPU versions of the cells for the tests."""

import json
import os

import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT


def load(cell_cfg: str, traffic: str):
    with open(os.path.join(ROOT, "benchmark", "configs", cell_cfg + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    return cfg, tr


def small_fleet(streams: int = 2, hw=(120, 160)):
    cfg, tr = load("tum_vga_fleet", "staggered_xyz")
    H, W = hw
    f = 500.0 * W / 640
    cfg.update(streams=streams, image_hw=[H, W], intrinsics=[f, f, W / 2, H / 2])
    tr.update(sample_every_ticks=3, sample_ticks=2, pose_gap_frames=10)
    return cfg, tr


def small_extract(batch: int = 4, hw=(96, 128)):
    cfg, tr = load("tum_vga_g4_features", "pool_b32")
    H, W = hw
    cfg.update(batch=batch, image_hw=[H, W])
    tr.update(pool_batches=2, scenes=2, warmup_batches=1, sample_every_batches=1, sample_batches=2)
    return cfg, tr


def run_small(cfg, tr, seed: int, seconds: float):
    import time

    return harness.run_cell(cfg, tr, seed, seconds, False, time.perf_counter(), torch.device("cpu"))

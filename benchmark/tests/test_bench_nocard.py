"""Without a card a run fails: no fallback to the CPU, no result line."""

import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT


def test_bench_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tum_fleet_s16_staggered", "--seed",
         "3000000011", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr

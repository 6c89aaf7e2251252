"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and nothing reads the old records."""

import os
import re
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import ROOT


def test_bench_names_compare_whole():
    assert forbidden_modules(["cvsteer_tpu_torch", "cvsteer_tpu_torch.slam.vo"]) == []
    assert forbidden_modules(["jaxtyping", "flaxen", "cvsteer_tpu_x"]) == []
    assert forbidden_modules(["cvsteer_tpu.slam.vo", "jax.numpy", "jaxlib", "flax.linen"]) == \
        sorted(FORBIDDEN)


def test_bench_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness, benchmark.reference, benchmark.judge, benchmark.devtrace\n"
        "import benchmark.run, benchmark.control, benchmark.metrics\n"
        "import cvsteer_tpu_torch.features.frontend, cvsteer_tpu_torch.slam.vo_device\n"
        "from benchmark.run import forbidden_modules\n"
        "print(forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_bench_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "judge.py", "render.py", "work.py"):
        with open(os.path.join(ROOT, "benchmark", name)) as f:
            src = f.read()
        assert not re.search(r"^\s*(from|import)\s+cvsteer_tpu", src, re.M), name


def test_bench_reads_no_old_records():
    pat = re.compile(r"bench\.py|chip_smoke|BENCH_r|FLEET_r|SCALING_|MULTICHIP_|SLAM_r")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                with open(os.path.join(dirpath, f)) as fh:
                    code = "\n".join(l for l in fh.read().splitlines()
                                     if not l.lstrip().startswith("#"))
                for m in re.finditer(r"open\(([^)]*)\)", code):
                    assert not pat.search(m.group(1)), (f, m.group(0))

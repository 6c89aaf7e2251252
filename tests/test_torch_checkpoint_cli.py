"""cli_vo --checkpoint-dir on CPU (the library: tests/test_torch_checkpoint.py).

The TUM fixture cut to 8 frames, host and device engines, one stream and
two streams (serving, a ``stream<i>`` directory each): a second run on
the same directory writes the same trajectory files (the reference's
tests/test_cli_vo.py:343-368), and a run stopped at frame 4 and resumed
writes the uninterrupted run's trajectory. Each case runs its four cli
calls in a child process with ``MKL_CBWR=COMPATIBLE``: MKL's float32 GEMM
rounds by the operands' memory alignment, which differs from run to run
(tests/test_torch_serving.py).
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "assets" / "tum_fixture")
FLAGS = ["--set", "camera.fx=300", "camera.fy=300", "camera.cx=160", "camera.cy=120",
         "slam.min_parallax=0.005", "slam.kf_max_gap=2", "slam.window=6", "checkpoint_every=1",
         "--device", "cpu"]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("streams", [1, 2])
def test_torch_cli_vo_checkpoint_resume(tmp_path, streams, engine):
    inputs = ",".join([FIXTURE] * streams)
    base = ["--input", inputs, "--engine", engine] + FLAGS

    def traj(name):
        names = [f"{name}.txt"] if streams == 1 else [f"{name}.{i}.txt" for i in range(streams)]
        return [(tmp_path / n).read_text() for n in names]

    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    argvs = [base + ["--max-frames", "8", "--output", str(tmp_path / "full.txt")],
             base + ck + ["--max-frames", "4", "--output", str(tmp_path / "a.txt")],
             base + ck + ["--max-frames", "8", "--output", str(tmp_path / "b.txt")],
             base + ck + ["--max-frames", "8", "--output", str(tmp_path / "c.txt")]]
    code = ("from cvsteer_tpu_torch.cli_vo import main\n"
            f"for argv in {argvs!r}:\n    assert main(argv) == 0\n")
    env = dict(os.environ, MKL_CBWR="COMPATIBLE", OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    if streams > 1:
        assert (tmp_path / "ck" / "stream0").is_dir() and (tmp_path / "ck" / "stream1").is_dir()
    full, b, c = traj("full"), traj("b"), traj("c")
    assert all(len(t.splitlines()) == 8 for t in full)
    assert b == c  # resumed at the end: the trajectory again
    assert b == full  # stopped at frame 5 and resumed: the uninterrupted run

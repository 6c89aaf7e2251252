"""Package-level contracts of the port (cvsteer_tpu_torch), on CPU.

- Importing every module pulls in neither jax nor the reference package
  (checked in a fresh interpreter: this test process has jax loaded).
- chip_smoke.py fails, printing no result line, where there is no CUDA
  device, and in a directory that holds nothing else of the repository.
- Entry points and options that are not ported yet raise instead of
  silently doing something else; the entry points that default to the card
  refuse to run without one.
- The numpy-only image reader decodes the committed fixture exactly as
  OpenCV does.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from cvsteer_tpu_torch.io.imageio import imread_gray_f32
from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "assets" / "tum_fixture"


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_torch_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cvsteer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'cvsteer_tpu'))\n"
        "assert len(mods) >= 30, mods\n"
        "assert 'cvsteer_tpu_torch.slam.vo_device' in mods, mods\n"
        "assert not bad, bad\n"
        "print('modules', len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "modules" in res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_torch_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, where):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in _clean_env().items() if k != "PYTHONPATH"}
    else:
        cwd, env = ROOT, _clean_env()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_torch_cli_vo_refuses_unported_modes(tmp_path):
    """Every mode of cli_vo is ported (--checkpoint-dir too:
    tests/test_torch_checkpoint.py); the card is the default device."""
    from cvsteer_tpu_torch.cli_vo import main

    if not torch.cuda.is_available():  # the card is the default: refuse without one
        assert main(["--input", str(FIXTURE), "--engine", "device"]) == 2
        assert main(["--input", f"{FIXTURE},{FIXTURE}", "--engine", "device"]) == 2


@pytest.mark.parametrize(
    "field,value",
    [("loop_closure", True), ("loop_closure_sim3", True), ("speed_prior_band", (0.5, 2.0)),
     ("ground_height_m", 1.5)],
)
def test_torch_vo_engines_take_the_loop_closure_options(field, value):
    """The options that came with loop closure: both engines take them
    (their parity with the JAX package: tests/test_torch_loopclosure.py)."""
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    cfg = VOConfig()._replace(**{field: value})
    assert getattr(init_vo(cfg, device="cpu").config, field) == value
    assert getattr(DeviceVO(cfg, device="cpu").state.config, field) == value


@pytest.mark.parametrize("field,value", [("motion_model", True), ("kf_min_flow_px", 20.0)])
def test_torch_vo_engines_take_the_shared_options(field, value):
    """The options that came with the device engine: both engines take them
    (their parity with the JAX engine: tests/test_torch_vo_device_options.py)."""
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    cfg = VOConfig()._replace(**{field: value})
    assert getattr(init_vo(cfg, device="cpu").config, field) == value
    assert getattr(DeviceVO(cfg, device="cpu").state.config, field) == value


def test_torch_vo_device_engine_refuses_without_the_card():
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: DeviceVO(device='cuda') runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceVO(VOConfig())


def test_torch_imread_matches_opencv(tmp_path):
    for name in sorted(os.listdir(FIXTURE / "rgb"))[:3]:
        path = str(FIXTURE / "rgb" / name)
        np.testing.assert_array_equal(
            imread_gray_f32(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        )
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (21, 34), dtype=np.uint8)
    color = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    for i, (img, ext) in enumerate([(gray, ".png"), (gray, ".pgm"), (color, ".png")]):
        path = str(tmp_path / f"img{i}{ext}")
        cv2.imwrite(path, img)
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        assert np.abs(imread_gray_f32(path) - ref).max() <= 1.0
    assert imread_gray_f32(str(tmp_path / "missing.png")) is None

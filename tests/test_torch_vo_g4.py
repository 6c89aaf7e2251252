"""G4/H4 features through the port's VO, on CPU.

1. cli_vo on the committed TUM fixture (tests/assets/tum_fixture) with
   tests/test_cli_vo.py's flags and --set frontend.order=4, host engine:
   it initializes, writes one finite pose per frame (32) and prints its
   ATE against the fixture's ground truth. No JAX VO run is made (the
   reference's takes ~50 s on this fixture): the ATE is printed, its first
   such figure.
2. The fixture's first frame at order 4 (default FrontendConfig
   otherwise) against the reference's CPU path, at the bar of
   tests/test_torch_features.py: >= 98 % of keypoints within 0.5 px at
   the same level, matched descriptors within 2e-2.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvsteer_tpu.features.frontend import FrontendConfig as JConfig
from cvsteer_tpu.features.frontend import extract_features as j_extract
from cvsteer_tpu_torch.cli_vo import main
from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features
from cvsteer_tpu_torch.io.imageio import imread_gray_f32

torch.set_num_threads(2)
FIXTURE = pathlib.Path(__file__).resolve().parent / "assets" / "tum_fixture"


def test_torch_cli_vo_g4_on_the_tum_fixture(tmp_path, capsys):
    out = tmp_path / "traj.txt"
    rc = main([
        "--input", str(FIXTURE), "--device", "cpu",
        "--set", "camera.fx=300", "camera.fy=300", "camera.cx=160", "camera.cy=120",
        "slam.min_parallax=0.005", "slam.kf_max_gap=2", "slam.window=6", "frontend.order=4",
        "--output", str(out),
    ])
    assert rc == 0
    rows = np.array([[float(v) for v in ln.split()] for ln in out.read_text().splitlines()])
    assert rows.shape == (32, 8) and np.isfinite(rows).all()
    assert np.abs(np.diff(rows[:, 1:4], axis=0)).sum() > 0  # it moved: initialized
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("ATE RMSE")]
    assert len(line) == 1
    ate = float(line[0].split()[2])
    print(f"parity G4 VO on the TUM fixture (host engine, CPU): ATE {ate:.4f} m")
    assert np.isfinite(ate)


def test_torch_g4_features_of_the_fixture_match_jax():
    img = imread_gray_f32(str(sorted((FIXTURE / "rgb").iterdir())[0]))
    fj = jax.jit(lambda im: j_extract(im, cfg=JConfig(order=4)))(jnp.asarray(img))
    ft = extract_features(torch.from_numpy(img), cfg=FrontendConfig(order=4))
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() > 300
    yj, yt = np.asarray(fj.yx)[vj], ft.yx.numpy()[vt]
    lj, lt = np.asarray(fj.level)[vj], ft.level.numpy()[vt]
    d = np.linalg.norm(yj[:, None] - yt[None], axis=-1) + 1e3 * (lj[:, None] != lt[None])
    near = d.min(1) < 0.5
    assert near.mean() >= 0.98 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
    dj, dt = np.asarray(fj.desc)[vj][near], ft.desc.numpy()[vt][d.argmin(1)[near]]
    assert np.abs(dj - dt).max() < 2e-2

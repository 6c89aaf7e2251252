"""The port's public API surface against the reference package's.

- Every name a cvsteer_tpu ``__init__`` imports from one of its modules
  (read with ``ast``) imports from the counterpart module of
  cvsteer_tpu_torch, and the port's subpackage re-exports it too; the
  parallel/ names of the next slice are listed below.
- Each function this surface newly exposes holds to its JAX counterpart on
  seeded numpy inputs: the cases tests/test_filters_g2.py:41,
  test_native_codec.py:57, test_posegraph.py:39 and test_ba.py:84 run in
  the reference.
"""

import ast
import importlib
import pathlib
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
#: parallel/ names the port leaves for its next slice (ROADMAP.md §1)
NOT_YET = {"bundle_adjust_sharded", "optimize_pose_graph_sharded"}


def _exports():
    """(reference __init__ module, source module, name) of every re-export."""
    out = []
    for init in sorted((REPO / "cvsteer_tpu").rglob("__init__.py")):
        pkg = ".".join(init.relative_to(REPO).parent.parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("cvsteer_tpu"):
                out += [(pkg, node.module, a.name) for a in node.names]
    return out


EXPORTS = _exports()


def test_torch_api_reads_the_reference_exports():
    pkgs = {p for p, _, _ in EXPORTS}
    assert {"cvsteer_tpu", "cvsteer_tpu.slam", "cvsteer_tpu.parallel", "cvsteer_tpu.ops"} <= pkgs
    assert len(EXPORTS) > 60


@pytest.mark.parametrize("pkg", sorted({p for p, _, _ in EXPORTS}))
def test_torch_api_subpackage_reexports(pkg):
    port = importlib.import_module(pkg.replace("cvsteer_tpu", "cvsteer_tpu_torch", 1))
    missing = []
    for p, module, name in EXPORTS:
        if p != pkg or name in NOT_YET:
            continue
        src = importlib.import_module(module.replace("cvsteer_tpu", "cvsteer_tpu_torch", 1))
        if not hasattr(src, name) or getattr(port, name, None) is not getattr(src, name):
            missing.append(f"{module}.{name}")
    assert not missing, missing


def test_torch_api_top_level():
    import cvsteer_tpu
    import cvsteer_tpu_torch

    assert cvsteer_tpu_torch.__version__ == cvsteer_tpu.__version__
    from cvsteer_tpu_torch.slam import DeviceVO, VOServer, bundle_adjust, optimize_pose_graph  # noqa: F401


@pytest.mark.parametrize("shape", [(185, 256), (64, 64), (33, 47)])
def test_torch_filter_bank_xla_matches_opencv_and_jax(shape):
    """tests/test_filters_g2.py:41 on the port: both formulations against
    cv2.sepFilter2D (atol 2e-3, rtol 1e-5), and against the reference's
    filter_bank_xla."""
    from cvsteer_tpu.ops.sepconv import filter_bank_xla as j_bank
    from cvsteer_tpu_torch.filters.taps import g2h2_bank
    from cvsteer_tpu_torch.ops import filter_bank_shifts, filter_bank_xla

    img = np.random.default_rng(sum(shape)).uniform(0, 255, size=shape).astype(np.float32)
    bank = g2h2_bank()
    ours = filter_bank_xla(torch.from_numpy(img), bank.xtaps, bank.ytaps).numpy()
    shifts = filter_bank_shifts(torch.from_numpy(img), bank.xtaps, bank.ytaps).numpy()
    for k in range(7):
        ref = cv2.sepFilter2D(img, cv2.CV_32F, bank.xtaps[k].reshape(1, -1), bank.ytaps[k].reshape(-1, 1))
        np.testing.assert_allclose(ours[k], ref, atol=2e-3, rtol=1e-5)
        np.testing.assert_allclose(shifts[k], ref, atol=2e-3, rtol=1e-5)
    want = np.asarray(j_bank(jnp.asarray(img), bank.xtaps, bank.ytaps))
    np.testing.assert_allclose(ours, want, atol=2e-3, rtol=1e-5)


def test_torch_bilinear_sample_matches_jax():
    from cvsteer_tpu.ops.interp import bilinear_sample as j_sample
    from cvsteer_tpu_torch.ops import bilinear_sample

    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 3, 20, 30)).astype(np.float32)
    ys = rng.uniform(-2, 22, (5, 7)).astype(np.float32)  # some clamp at the border
    xs = rng.uniform(-2, 32, (5, 7)).astype(np.float32)
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    want = np.asarray(j_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    assert got.shape == want.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


def test_torch_imdecode_gray_f32():
    """test_native_codec.py:57 on the port's zlib-only codec: PNG bytes
    decode as the reference decodes them; JPEG bytes give None."""
    from cvsteer_tpu.io.imageio import imdecode_gray_f32 as j_decode
    from cvsteer_tpu_torch.io import imdecode_gray_f32, imread_gray_f32

    fish = REPO / "cvsteer_tpu_torch" / "io" / "golden" / "fish.png"
    data = fish.read_bytes()
    got = imdecode_gray_f32(data)
    assert got.shape == (185, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_decode(data))
    np.testing.assert_array_equal(got, imread_gray_f32(str(fish)))
    assert imdecode_gray_f32((REPO / "tests" / "assets" / "fish.jpg").read_bytes()) is None
    assert imdecode_gray_f32(b"not an image at all") is None


def test_torch_relative_pose_matches_jax():
    """test_posegraph.py:39's measurement: T_j o T_i^-1 of seeded poses."""
    from cvsteer_tpu.slam import se3 as jse3
    from cvsteer_tpu.slam.posegraph import Poses as JPoses
    from cvsteer_tpu.slam.posegraph import relative_pose as j_rel
    from cvsteer_tpu_torch.slam.posegraph import Poses, relative_pose

    rng = np.random.default_rng(6)
    R, t = jse3.exp_se3(jnp.asarray(rng.normal(0, 0.5, (6, 6)), jnp.float32))
    i, j = np.array([0, 1, 2, 3, 5]), np.array([1, 2, 3, 4, 0])
    want = j_rel(JPoses(R, t), jnp.asarray(i), jnp.asarray(j))
    got = relative_pose(Poses(torch.from_numpy(np.array(R)), torch.from_numpy(np.array(t))),
                        torch.from_numpy(i), torch.from_numpy(j))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_torch_sim3_identity_matches_jax():
    from cvsteer_tpu.slam import sim3 as jsim3
    from cvsteer_tpu_torch.slam import sim3

    for shape in [(), (4,), (2, 3)]:
        for g, w in zip(sim3.identity(shape), jsim3.identity(shape)):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_torch_build_normal_equations_matches_jax():
    """test_ba.py:84's linearization on the port: every block against the
    reference's build_normal_equations."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_ba import _synthetic_ba

    from cvsteer_tpu.slam.ba import build_normal_equations as j_build
    from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, NormalEquations, build_normal_equations

    problem, _, init = _synthetic_ba(C=3, L=8, pose_err=0.02, point_err=0.05)
    want = j_build(init, problem)

    def t(a):
        return torch.from_numpy(np.array(a))

    got = build_normal_equations(
        BAState(t(init.R), t(init.t), t(init.X)),
        BAProblem(t(problem.uv), t(problem.mask), t(problem.fixed_cameras), float(problem.huber_delta)),
    )
    assert isinstance(got, NormalEquations) and got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)

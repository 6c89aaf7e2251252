"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. This file imports
neither jax nor OpenCV, so it also runs on a GPU machine that has only
PyTorch; there, without the repository's conftest (which sets up jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.filters import taps
from cvsteer_tpu_torch.ops import cuda_desc as cd
from cvsteer_tpu_torch.ops import cuda_frontend as cf
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _texture(shape, seed=6):
    """Smooth random texture in 0..255 (3x3 box-blurred noise)."""
    img = np.random.default_rng(seed).random(shape).astype(np.float32) * 255
    if min(shape[-2:]) > 3:
        p = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
        img = sum(p[..., i : i + shape[-2], j : j + shape[-1]] for i in range(3) for j in range(3)) / 9
    return img.astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 480, 640), (2, 61, 83), (3, 2)])
def test_torch_cuda_kernels_match_plain(cuda, shape):
    img = torch.from_numpy(_texture(shape)).to(cuda)
    bank = taps.g2h2_bank()
    before = kernels.launch_counts()
    k, p = cf.filter_bank(img, bank.xtaps, bank.ytaps), filter_bank_plain(img, bank.xtaps, bank.ytaps)
    assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    k, p = cf.pyr_down(img), cf.pyr_down_plain(img)
    assert (k - p).abs().max().item() <= 255 * 3e-5 + 1e-3
    if min(shape[-2:]) > 6:
        ko = cf.g2_features_full(img, bank.xtaps, bank.ytaps, threshold=1.0)
        po = cf.g2_features_full_plain(img, bank.xtaps, bank.ytaps, threshold=1.0)
        for a, b in zip(ko[1:], po[1:]):
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1.0)
        keep = lambda p3: p3 > cf.P3_SENTINEL * 0.5  # noqa: E731
        assert (keep(ko[0]) == keep(po[0])).float().mean().item() >= 0.999
        basis = ko[5].reshape(-1, 7, *shape[-2:])
        ys = torch.rand((basis.shape[0], 32, 16), device=cuda) * shape[-2]
        xs = torch.rand((basis.shape[0], 32, 16), device=cuda) * shape[-1]
        k, p = cd.sample_patches(basis, ys, xs), cd.sample_patches_plain(basis, ys, xs)
        assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("filter_bank", "pyr_down"):
        assert after[name] > before[name]


def test_torch_cuda_wrappers_raise_on_unsupported_input(cuda):
    xt = taps.g2h2_bank().xtaps
    with pytest.raises(TypeError):
        cf.pyr_down(torch.zeros((8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        cf.filter_bank(torch.zeros((8, 16), device=cuda).T, xt, xt)
    with pytest.raises(ValueError):
        cf.filter_bank(torch.zeros((8, 8), device=cuda), np.zeros((12, 9)), np.zeros((12, 9)))


def test_torch_cuda_vo_step_on_the_card(cuda):
    """Two rendered frames through the port's VO on the card: features
    land on the device and the kernels of the path launch."""
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_image

    seq = PlanesSequence(n_frames=8)
    state = init_vo(VOConfig(), device=cuda)
    kernels.reset_launch_counts()
    for k in range(0, 8, 4):
        state = process_image(state, seq.render(k))
    assert state.keyframes[0].features.desc.device.type == "cuda"
    assert all(n > 0 for n in kernels.launch_counts().values())

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
from cvsteer_tpu_torch.ops import cuda_probes as cp
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
    assert k.shape == p.shape and torch.equal(k, p)
    k, p = cf.pyr_down(img), cf.pyr_down_plain(img)
    assert k.shape == p.shape and torch.equal(k, p)
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


#: levels narrower than the taps (kernels A and E)
NARROW = [(1, 1), (2, 2), (3, 5), (2, 5, 9)]


def _random_bank(K, R, seed):
    """K random x- and y-tap vectors of 2R + 1 taps; with K > 1 the last
    x-tap vector is a bit copy of the second, so two filters share a row
    pass (the kernels' row_of map)."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((K, 2 * R + 1)).astype(np.float32)
    yt = rng.standard_normal((K, 2 * R + 1)).astype(np.float32)
    if K > 1:
        xt[-1] = xt[1]
    return xt, yt


def _taps(bank):
    return bank.xtaps, bank.ytaps


@pytest.mark.parametrize("K", [1, 7, 11])
@pytest.mark.parametrize("R", range(7))
def test_torch_cuda_filter_bank_radii_bit_equal(cuda, R, K):
    """Kernel A at every radius it takes (T = 2R + 1 <= 13) with 1, 7 and 11
    filters, bit for bit against the plain bank, down to levels narrower
    than the taps: the G2/H2 and G4/H4 banks at that width (each has two
    filters with one x-tap vector), blur5, and random banks."""
    banks = [_random_bank(K, R, seed=R)]
    if K == 7:
        banks.append(_taps(taps.g2h2_bank(width=R)))
    if K == 11:
        banks.append(_taps(taps.g4h4_bank(width=R)))
    if K == 1 and R == 2:
        banks.append((cf._BINOMIAL5[None], cf._BINOMIAL5[None]))
    for i, shape in enumerate([(1, 480, 640), (2, 61, 83), (3, 2)] + NARROW):
        img = torch.from_numpy(_texture(shape, seed=i)).to(cuda)
        for xt, yt in banks:
            before = kernels.launch_counts()["filter_bank"]
            got = cf.filter_bank(img, xt, yt)
            assert kernels.launch_counts()["filter_bank"] == before + 1
            want = filter_bank_plain(img, xt, yt)
            assert got.shape == want.shape == tuple(shape[:-2]) + (K,) + tuple(shape[-2:])
            assert torch.equal(got, want), (shape, R, K)


@pytest.mark.parametrize("R", range(9))
def test_torch_cuda_maps_radii_bit_equal(cuda, R):
    """Kernel E's template at every radius it takes (T = 2R + 1 <= 17): E
    and E4 with float32 and bfloat16 maps and E′, each bit for bit against
    its plain version, with the G2/H2 and G4/H4 banks at that width and with
    random banks, on tiles cut by both edges and levels narrower than the
    taps."""
    g2 = [_taps(taps.g2h2_bank(width=R)), _random_bank(7, R, seed=10 + R)]
    g4 = [_taps(taps.g4h4_bank(width=R)), _random_bank(11, R, seed=20 + R)]
    for i, shape in enumerate([(2, 70, 150)] + NARROW):
        img = torch.from_numpy(_texture(shape, seed=30 + i)).to(cuda)
        before = kernels.launch_counts()
        for fn, plain, banks in ((cf.g2_maps, cf.g2_maps_plain, g2), (cf.g4_maps, cf.g4_maps_plain, g4)):
            for xt, yt in banks:
                for dtype in (torch.float32, torch.bfloat16):
                    got = fn(img, xt, yt, out_dtype=dtype)
                    want = plain(img, xt, yt, out_dtype=dtype)
                    for g, w in zip(got, want):
                        assert g.dtype == dtype and g.shape == img.shape
                        assert torch.equal(g, w), (fn.__name__, shape, R, dtype)
        for xt, yt in g2:
            got = cf.g2_feature_maps(img, xt, yt)
            want = cf.g2_feature_maps_plain(filter_bank_plain(img, xt, yt))
            for g, w in zip(got, want):
                assert g.shape == img.shape and torch.equal(g, w), ("g2_feature_maps", shape, R)
        after = kernels.launch_counts()
        assert after["g2_maps"] == before["g2_maps"] + 4
        assert after["g4_maps"] == before["g4_maps"] + 4
        assert after["g2_feature_maps"] == before["g2_feature_maps"] + 2


def _pyramid(cuda, shape, levels, seed=6):
    out = [torch.from_numpy(_texture(shape, seed)).to(cuda)]
    for _ in range(levels - 1):
        out.append(cf.pyr_down_plain(out[-1]).contiguous())
    return out


@pytest.mark.parametrize("threshold", [1.0, 50.0])
@pytest.mark.parametrize("nms", [2, 3, 4])
@pytest.mark.parametrize("shape,levels", [((1, 480, 640), 5), ((2, 61, 83), 8), ((3, 5), 1)])
def test_torch_cuda_g2_features_levels_bit_equal(cuda, shape, levels, nms, threshold):
    """Kernel C: every level of a pyramid in one launch, bit for bit against
    the plain version level by level (61x83 goes down to 2x3, 1x2 and 1x1
    levels, narrower than the bank and the NMS window)."""
    bank = taps.g2h2_bank()
    lv = _pyramid(cuda, shape, levels)
    before = kernels.launch_counts()["g2_features_full"]
    got = cf.g2_features_levels(lv, bank.xtaps, bank.ytaps, threshold=threshold, nms_radius=nms)
    assert kernels.launch_counts()["g2_features_full"] == before + 1
    kept = 0
    for img, g in zip(lv, got):
        want = cf.g2_features_full_plain(img, bank.xtaps, bank.ytaps, threshold=threshold,
                                         nms_radius=nms)
        for a, b in zip(g, want):
            assert a.shape == b.shape and torch.equal(a, b)
        kept += int((g[0] > cf.P3_SENTINEL * 0.5).sum())
    assert kept > 0 or min(shape[-2:]) <= 2 * nms + 2


def _corner_clouds(cuda, shapes, counts, S, seed):
    """ys/xs [2, sum(counts), S]: rotated 4x4-style grids around keypoints at
    the levels' corners and edges (clipped at the image), every eighth
    keypoint with samples scattered over the whole level (and beyond it)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(S)))
    off = (np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1)
           .reshape(-1, 2)[:S] - (side - 1) / 2) * 3.0
    ys, xs = [], []
    for (h, w), k in zip(shapes, counts):
        cy = rng.choice([0.0, h - 1.0, rng.uniform(0, h - 1)], (2, k))
        cx = rng.choice([0.0, w - 1.0, rng.uniform(0, w - 1)], (2, k))
        th = rng.uniform(-np.pi, np.pi, (2, k, 1))
        y = cy[..., None] + off[:, 0] * np.cos(th) - off[:, 1] * np.sin(th)
        x = cx[..., None] + off[:, 0] * np.sin(th) + off[:, 1] * np.cos(th)
        y[:, ::8] = rng.uniform(-3, h + 3, y[:, ::8].shape)
        x[:, ::8] = rng.uniform(-3, w + 3, x[:, ::8].shape)
        ys.append(y)
        xs.append(x)
    cat = lambda a: torch.from_numpy(np.concatenate(a, 1).astype(np.float32)).to(cuda)  # noqa: E731
    return cat(ys), cat(xs)


@pytest.mark.parametrize("S", [16, 40])
def test_torch_cuda_sample_patches_levels_bit_equal(cuda, S):
    """Kernel D: the keypoints of five levels in one launch, bit for bit
    against the plain version level by level — clouds clipped at the
    corners, widths that are and are not multiples of 4, an empty level, K
    not a multiple of the block's keypoints, scattered samples."""
    shapes = [(40, 64), (61, 83), (16, 21), (3, 5), (1, 1)]
    counts = [37, 21, 0, 11, 3]
    bases = [torch.from_numpy(_texture((2, 7) + s, seed=3 + i)).to(cuda) for i, s in enumerate(shapes)]
    ys, xs = _corner_clouds(cuda, shapes, counts, S, seed=4)
    before = kernels.launch_counts()["desc_sample"]
    got = cd.sample_patches_levels(bases, ys, xs, counts)
    assert kernels.launch_counts()["desc_sample"] == before + 1
    want = cd.sample_patches_levels_plain(bases, ys, xs, counts)
    assert got.shape == (2, sum(counts), S, 7) and torch.equal(got, want)
    for b, k0, k1 in zip(bases, np.cumsum([0] + counts[:-1]), np.cumsum(counts)):
        one = cd.sample_patches(b, ys[:, k0:k1].contiguous(), xs[:, k0:k1].contiguous())
        assert torch.equal(one, got[:, k0:k1])


@pytest.mark.parametrize("shape", [(16, 512, 512), (1, 480, 640), (2, 61, 83), (3, 5), (1, 1), (2, 2),
                                   (2, 5, 9)])
def test_torch_cuda_g2_feature_maps_bit_equal(cuda, shape):
    """Kernel E′ against its plain version (the plain bank, then the feature
    tail), bit for bit."""
    bank = taps.g2h2_bank()
    img = torch.from_numpy(_texture(shape, seed=9)).to(cuda)
    before = kernels.launch_counts()["g2_feature_maps"]
    got = cf.g2_feature_maps(img, bank.xtaps, bank.ytaps)
    assert kernels.launch_counts()["g2_feature_maps"] == before + 1
    want = cf.g2_feature_maps_plain(filter_bank_plain(img, bank.xtaps, bank.ytaps))
    for a, b in zip(got, want):
        assert a.shape == img.shape and torch.equal(a, b)


@pytest.mark.parametrize("shape", [(16, 512, 512), (1, 480, 640), (1, 185, 256), (2, 5, 9), (1, 1),
                                   (2, 2), (3, 5)])
def test_torch_cuda_maps_kernels_match_plain(cuda, shape):
    """Kernel E (G2, float32 and bfloat16 maps) and E4, its G4
    instantiation, against their plain versions on the same card: fp32
    arithmetic in the same order, so bit for bit."""
    img = torch.from_numpy(_texture(shape)).to(cuda)
    before = kernels.launch_counts()
    for fn, plain, bank in ((cf.g2_maps, cf.g2_maps_plain, taps.g2h2_bank()),
                            (cf.g4_maps, cf.g4_maps_plain, taps.g4h4_bank())):
        for dtype in (torch.float32, torch.bfloat16):
            got = fn(img, bank.xtaps, bank.ytaps, out_dtype=dtype)
            want = plain(img, bank.xtaps, bank.ytaps, out_dtype=dtype)
            for g, w in zip(got, want):
                assert g.dtype == dtype and g.shape == img.shape
                assert torch.equal(g, w)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["g2_maps"] == before["g2_maps"] + 2
    assert after["g4_maps"] == before["g4_maps"] + 2


@pytest.mark.parametrize("shape,levels", [
    ((1, 480, 640), 5), ((2, 61, 83), 5), ((3, 2), 5), ((1, 1), 5), ((2, 5, 9), 5), ((1, 185, 256), 5),
    ((1, 480, 640), 1), ((1, 480, 640), 2), ((2, 61, 83), 7), ((1, 185, 256), 7),
])
def test_torch_cuda_pyr_down_levels_bit_equal(cuda, shape, levels):
    """Kernel B: the whole pyramid in one launch (none for one level), each
    level equal to the composed plain steps bit for bit, down to 1x1."""
    img = torch.from_numpy(_texture(shape, seed=9)).to(cuda)
    before = kernels.launch_counts()["pyr_down"]
    got = cf.pyr_down_levels(img, levels)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pyr_down"] == before + (levels >= 2)
    want = [img]
    for _ in range(levels - 1):
        want.append(cf.pyr_down_plain(want[-1]))
    assert len(got) == levels and got[0] is img
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    again = cf.pyr_down_levels(img, levels)  # the ticket counters came back to 0
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("shape", [(16, 512, 512), (1, 480, 640), (1, 185, 256), (2, 2), (1, 1), (3, 5),
                                   (13, 7), (7, 13)])
def test_torch_cuda_filter_bank_adjoint_matches_plain(cuda, shape):
    """Kernel F against the explicit plain adjoint bit for bit (same order)
    and against autograd through the plain bank, with the G2/H2 and G4/H4
    banks and random banks at every odd T = 1..13; one launch per call, and
    the gradient of filter_bank_diff launches it."""
    img = torch.from_numpy(_texture(shape, seed=8)).to(cuda)
    banks = [(taps.g2h2_bank().xtaps, taps.g2h2_bank().ytaps), (taps.g4h4_bank().xtaps, taps.g4h4_bank().ytaps)]
    banks += [_random_bank(3, R, seed=R) for R in range(7)]
    for i, (xt, yt) in enumerate(banks):
        g = torch.randn(tuple(shape[:-2]) + (xt.shape[0],) + tuple(shape[-2:]), device=cuda)
        before = kernels.launch_counts()["filter_bank_adj"]
        got = cf.filter_bank_adjoint(g, xt, yt)
        assert kernels.launch_counts()["filter_bank_adj"] == before + 1
        want = cf.filter_bank_adjoint_plain(g, xt, yt)
        assert got.shape == img.shape and torch.equal(got, want), (shape, xt.shape)
        if i >= 2:
            continue
        scale = max(want.abs().max().item(), g.abs().sum().item() / g.numel())
        x = img.clone().requires_grad_()
        (ref,) = torch.autograd.grad(filter_bank_plain(x, xt, yt), x, g)
        assert (got - ref).abs().max().item() <= 1e-4 * scale
        before = kernels.launch_counts()["filter_bank_adj"]
        x = img.clone().requires_grad_()
        (gd,) = torch.autograd.grad(cf.filter_bank_diff(x, xt, yt), x, g)
        assert kernels.launch_counts()["filter_bank_adj"] == before + 1
        assert torch.equal(gd, got)


def test_torch_cuda_wrappers_raise_on_unsupported_input(cuda):
    xt = taps.g2h2_bank().xtaps
    with pytest.raises(TypeError):
        cf.pyr_down(torch.zeros((8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        cf.pyr_down_levels(torch.zeros((8, 8), device=cuda), 0)
    with pytest.raises(ValueError):
        cf.filter_bank(torch.zeros((8, 16), device=cuda).T, xt, xt)
    with pytest.raises(ValueError):
        cf.filter_bank(torch.zeros((8, 8), device=cuda), np.zeros((12, 9)), np.zeros((12, 9)))
    with pytest.raises(ValueError):  # the G2 maps kernel takes the 7-filter bank only
        cf.g2_maps(torch.zeros((8, 8), device=cuda), np.zeros((11, 9)), np.zeros((11, 9)))
    with pytest.raises(ValueError):
        cf.filter_bank_adjoint(torch.zeros((7, 8, 8), device=cuda), np.zeros((7, 15)), np.zeros((7, 15)))
    bank = taps.g2h2_bank()
    with pytest.raises(ValueError):  # the NMS window: radius 1 to 4
        cf.g2_features_full(torch.zeros((8, 8), device=cuda), bank.xtaps, bank.ytaps,
                            threshold=1.0, nms_radius=5)
    with pytest.raises(ValueError):  # levels with other leading axes
        cf.g2_features_levels([torch.zeros((2, 8, 8), device=cuda), torch.zeros((1, 4, 4), device=cuda)],
                              bank.xtaps, bank.ytaps, threshold=1.0)
    with pytest.raises(ValueError):  # the feature tail takes the 7-filter bank only
        cf.g2_feature_maps(torch.zeros((8, 8), device=cuda), np.zeros((11, 9)), np.zeros((11, 9)))
    with pytest.raises(ValueError):  # counts that do not sum to K
        z = torch.zeros((1, 7, 8, 8), device=cuda)
        cd.sample_patches_levels([z, z], torch.zeros((1, 5, 16), device=cuda),
                                 torch.zeros((1, 5, 16), device=cuda), [2, 2])


def test_torch_cuda_vo_step_on_the_card(cuda):
    """Two rendered frames through the port's VO on the card: features
    land on the device, and each frame's front-end is one pyr_down launch
    for the whole pyramid, one kernel C launch for all levels and one
    kernel D launch for all keypoints; the bank kernel A is not on this
    path."""
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_image

    seq = PlanesSequence(n_frames=8)
    state = init_vo(VOConfig(), device=cuda)
    kernels.reset_launch_counts()
    for k in range(0, 8, 4):
        state = process_image(state, seq.render(k))
    assert state.keyframes[0].features.desc.device.type == "cuda"
    counts = kernels.launch_counts()
    assert counts["filter_bank"] == 0
    assert counts["pyr_down"] == 2 * 1
    assert counts["g2_features_full"] == counts["desc_sample"] == 2


# ---------------------------------------------------------------------------
# The device-resident VO engine's two captured graphs (slam.vo_device)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def device_vo():
    """A DeviceVO on the card, 12 rendered frames in (initialized and
    captured), with the 13th frame's features in its input buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's steps are captured CUDA graphs")
    from cvsteer_tpu_torch.features.frontend import extract_features
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    seq = PlanesSequence(n_frames=40)
    vo = DeviceVO(VOConfig(), device="cuda")
    for k in range(12):
        vo.process_image(seq.render(k))
    assert vo.map is not None and vo.captures == 2
    feats = extract_features(torch.from_numpy(seq.render(12)).cuda())
    io = vo._io
    io.yx.copy_(feats.yx)
    io.desc.copy_(feats.desc)
    io.fvalid.copy_(feats.valid)
    kf = vo.state.keyframes[-1]
    io.pose.copy_(torch.from_numpy(np.concatenate([kf.R.reshape(9), kf.t])))
    return vo


def _engine_state(vo):
    return [a.clone() for a in vo.map if a is not None] + [a.clone() for a in vo._io]


def _run_from(vo, snap, half, eager):
    """Restore the map and buffers to ``snap``, run ``half`` (0 = T,
    1 = P) captured or eagerly, and return the map and buffers after."""
    for dst, src in zip([a for a in vo.map if a is not None] + list(vo._io), snap):
        dst.copy_(src)
    vo._run_half(half, eager=eager)
    torch.cuda.synchronize()
    return _engine_state(vo)


@pytest.mark.parametrize("half", [0, 1], ids=["T", "P"])
def test_torch_cuda_vo_graphs_equal_eager_and_replay(device_vo, half):
    """Each captured half gives the same map and outputs as the same half
    run eagerly on the same carried-in state, bit for bit, and replaying it
    twice on the same inputs gives the same again."""
    vo = device_vo
    snap = _engine_state(vo)
    if half == 1:  # P consumes T's outputs
        snap = _run_from(vo, snap, 0, eager=False)
    eager = _run_from(vo, snap, half, eager=True)
    first = _run_from(vo, snap, half, eager=False)
    again = _run_from(vo, snap, half, eager=False)
    names = [f for f, a in zip(vo.map._fields, vo.map) if a is not None] + list(vo._io._fields)
    for name, e, a, b in zip(names, eager, first, again):
        assert torch.equal(a, e), f"{name}: the graph differs from the eager half"
        assert torch.equal(a, b), f"{name}: two replays differ"
    _run_from(vo, snap, half, eager=False)


def test_torch_cuda_vo_p_launches_ba_kernels_once_an_iteration(device_vo):
    """P's window BA (B = 1) launches ba_schur once an LM iteration and
    ba_update once more (the initial cost)."""
    vo = device_vo
    snap = _run_from(vo, _engine_state(vo), 0, eager=False)
    n = vo.state.config.ba_iterations
    before = kernels.launch_counts()
    _run_from(vo, snap, 1, eager=True)
    after = kernels.launch_counts()
    assert (after["ba_schur"] - before["ba_schur"], after["ba_update"] - before["ba_update"]) == (
        n, n + 1)
    _run_from(vo, snap, 1, eager=False)


def test_torch_cuda_vo_captures_twice_and_never_again():
    """Two graphs after the first upload, none after 20 frames, and none
    after a blackout forces the host path and a re-upload."""
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's steps are captured CUDA graphs")
    seq = PlanesSequence(n_frames=26)
    vo = DeviceVO(VOConfig(), device="cuda")
    for k in range(20):
        vo.process_image(seq.render(k))
    assert vo.initialized and vo.captures == 2
    bufs = [a.data_ptr() for a in vo.map if a is not None]
    for k in range(20, 22):  # blank frames: tracking is lost
        vo.process_image(np.zeros((480, 640), np.float32))
    assert not vo._host_dirty  # the lost frames synced and uploaded
    for k in range(22, 26):
        vo.process_image(seq.render(k))
    st = vo.finalize()
    assert vo.captures == 2
    assert [a.data_ptr() for a in vo.map if a is not None] == bufs  # never rebound
    assert len(st.trajectory) == 26 and np.isfinite(st.poses()[1]).all()


def _city_vo(n_frames):
    """A DeviceVO on the card with the loop-closure campaign configuration
    (chip_smoke._city_cfg: the signature store and the ground controller in
    the graphs), ``n_frames`` CityLoop frames in."""
    import chip_smoke
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    seq, cfg = chip_smoke._city_cfg()
    vo = DeviceVO(cfg, device="cuda")
    for k in range(n_frames):
        vo.process_image(seq.render(k))
    return vo, seq


@pytest.fixture(scope="module")
def loop_vo():
    """The campaign-configured DeviceVO, 24 frames in, with the 25th
    frame's features in its input buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's steps are captured CUDA graphs")
    from cvsteer_tpu_torch.features.frontend import extract_features

    vo, seq = _city_vo(24)
    assert vo.map is not None and vo.captures == 2
    assert vo.map.sig is not None and vo.map.ground_hist is not None
    feats = extract_features(torch.from_numpy(seq.render(24)).cuda(),
                             cfg=vo.state.config.frontend)
    io = vo._io
    io.yx.copy_(feats.yx)
    io.desc.copy_(feats.desc)
    io.fvalid.copy_(feats.valid)
    kf = vo.state.keyframes[-1]
    io.pose.copy_(torch.from_numpy(np.concatenate([kf.R.reshape(9), kf.t])))
    return vo


@pytest.mark.parametrize("half", [0, 1], ids=["T", "P"])
def test_torch_cuda_vo_loop_graphs_equal_eager_and_replay(loop_vo, half):
    """With the signature store and the ground controller in them, each
    captured half equals the same half run eagerly, bit for bit, and two
    replays agree (test_torch_cuda_vo_graphs_equal_eager_and_replay's
    check)."""
    vo = loop_vo
    snap = _engine_state(vo)
    if half == 1:
        snap = _run_from(vo, snap, 0, eager=False)
    eager = _run_from(vo, snap, half, eager=True)
    first = _run_from(vo, snap, half, eager=False)
    again = _run_from(vo, snap, half, eager=False)
    names = [f for f, a in zip(vo.map._fields, vo.map) if a is not None] + list(vo._io._fields)
    for name, e, a, b in zip(names, eager, first, again):
        assert torch.equal(a, e), f"{name}: the graph differs from the eager half"
        assert torch.equal(a, b), f"{name}: two replays differ"
    _run_from(vo, snap, half, eager=False)


def test_torch_cuda_vo_closure_upload_keeps_buffers():
    """The device engine's Sim(3) closure event on the card (the stream of
    tests/test_loopclosure.py::test_device_vo_sim3_closure_end_to_end_scale_drift,
    built by chip_smoke's numpy helpers): the drifted state is adopted,
    tracking continues across the revisit, a closure is accepted and halves
    the keyframe ATE, and the upload writes into the captured buffers:
    every buffer keeps its address and no graph is captured again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's steps are captured CUDA graphs")
    import chip_smoke as cs
    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    X, desc = cs._loop_world()
    rng = np.random.default_rng(11)
    n_frames = 48
    gt = [cs._circle_pose(k, n_frames - 1) for k in range(n_frames)]
    frames = [cs._render_feats(X, desc, R, t, rng) for R, t in gt]
    cfg = VOConfig(intrinsics=Intrinsics(*cs.LOOP_K), kf_max_gap=4, window=6,
                   track_min_landmarks=40, min_parallax=0.01)
    vo = DeviceVO(cfg, device="cuda")
    for k in range(40):
        vo.process_frame(frames[k])
    st = vo.sync_host()
    assert cs._inject_scale_drift(st, rate=0.07) > 1.8
    before = cs._kf_ate(st, gt)
    cfg2 = cfg._replace(loop_closure=True, loop_closure_sim3=True, loop_min_gap=6,
                        loop_min_inliers=20)
    st.config = cfg2
    vo2 = DeviceVO(cfg2, device="cuda")
    vo2.adopt(st)
    assert vo2.captures == 2
    bufs = [a.data_ptr() for a in vo2.map if a is not None]
    for k in range(40, n_frames):
        vo2.process_frame(frames[k])
    final = vo2.finalize()
    assert vo2.closures_accepted >= 1
    assert cs._kf_ate(final, gt) < 0.5 * before
    assert vo2.captures == 2
    assert [a.data_ptr() for a in vo2.map if a is not None] == bufs


@pytest.mark.parametrize("kind", ["se3", "sim3"])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_torch_cuda_pose_graph_matches_cpu(cuda, kind, solver):
    """optimize_pose_graph / optimize_pose_graph_sim3 on the card against the
    same call on the CPU: final cost within 1e-4 relative, poses within
    1e-3 m and 1e-3 rad (the bars the CPU parity tests hold the port to
    against the JAX package)."""
    import chip_smoke as cs

    wd = cs.pgo_world(40, 3, sim3=kind == "sim3")
    out = {}
    for dev in ("cpu", "cuda"):
        opt, st = cs.pgo_call(wd, dev, kind=kind, iterations=15, solver=solver, cg_iterations=80)
        out[dev] = (opt.R.cpu(), opt.t.cpu(), float(st.cost), float(st.initial_cost))
    (Rc, tc, cc, c0), (Rg, tg, cg, _) = out["cpu"], out["cuda"]
    rot = float((Rc - Rg).abs().max())  # ~ the angle apart, rad
    print(f"pgo {kind} {solver}: cost {c0:.6g} -> cpu {cc:.6g}, cuda {cg:.6g}; "
          f"poses {float((tc - tg).abs().max()):.3e} m, {rot:.3e} rad apart (bars 1e-4 rel, 1e-3)")
    assert cc < 0.5 * c0
    assert abs(cc - cg) <= 1e-4 * max(abs(cc), 1e-12)
    assert float((tc - tg).abs().max()) < 1e-3 and rot < 1e-3


def test_torch_cuda_vo_first_window_ba_host_and_device(cuda, monkeypatch):
    """Where the two engines part (phase 5b of chip_smoke.py), on phase 5's
    40-frame scene: the host engine's first promotion (vo._kf_fused, its
    real arguments and result) against the device engine's first P (the
    map and buffers just before it; _promote up to its _window_ba). Both
    promote the same frame and build the same BA problem: the same
    cameras, landmarks and observations (checked), in other layouts: the
    host's has a column per feature of the previous keyframe, most of them
    empty. The test prints the new keyframe's camera center from each
    engine, and from the host's problem solved without its empty columns,
    after 1 LM iteration and after the configured ones; after 1 they agree
    within 1e-4 m. Then both engines run the 40 frames and the test prints
    each frame's distance between their tracked camera centers beside the
    promotions: where the gap opens."""
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam import vo as hostvo
    from cvsteer_tpu_torch.slam import vo_device as tvd
    from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust
    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo, process_image
    from cvsteer_tpu_torch.utils.precision import precise

    cfg = VOConfig()
    K = cfg.intrinsics
    seq = PlanesSequence(n_frames=40, image_hw=(480, 640), fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy,
                         seed=0)
    frames = [seq.render(k) for k in range(20)]
    host = {}
    kf_fused = hostvo._kf_fused

    def spy_host(*args, **kw):
        out = kf_fused(*args, **kw)
        host.setdefault("args", (args, kw, out))
        return out

    monkeypatch.setattr(hostvo, "_kf_fused", spy_host)
    st = init_vo(cfg, device="cuda")
    for k, img in enumerate(frames):
        process_image(st, img)
        if host:
            host["frame"] = k
            break
    vo = tvd.DeviceVO(cfg, device="cuda")
    snap = {}
    run_half = vo._run_half

    def spy_device(k, eager=False):  # the map and buffers just before the first P
        if k == 1 and not snap:
            snap["map"] = tvd.DeviceMap(*(None if a is None else a.clone() for a in vo.map))
            snap["io"] = tvd._IO(*(a.clone() for a in vo._io))
        return run_half(k, eager=eager)

    vo._run_half = spy_device
    for k, img in enumerate(frames):
        vo.process_image(img)
        if snap:
            snap["frame"] = k
            break
    assert host and snap and host["frame"] == snap["frame"]
    grabbed = {}
    window_ba = tvd._window_ba

    def grab(m, **kw):
        grabbed["m"] = m
        return window_ba(m, **kw)

    monkeypatch.setattr(tvd, "_window_ba", grab)
    m0, io = snap["map"], snap["io"]
    hd = cfg.huber_delta
    with precise():
        tvd._promote(m0, io.uv_new, io.desc, io.fvalid, io.idx, io.obs_pre, io.R, io.t,
                     tri_angle=cfg.tri_min_ray_angle_deg, iterations=cfg.ba_iterations,
                     huber_delta=hd)
    m = grabbed["m"]

    (R_pad, t_pad, X_pad, uv, mask_old, pot, fixed, *_), _, out = host["args"]
    ok, Xc = out[4], out[5]
    X = torch.cat([X_pad, torch.where(ok[:, None], Xc, 0.0)])
    mask = torch.cat([mask_old, pot & ok[None, :]], 1)
    c_new = int(mask.any(1).sum()) - 1  # real cameras first, the new one last
    keep = mask.any(0)
    # the same problem: the device window's observations, as (camera, point) -> uv
    live = torch.nonzero(m.kf_live).flatten()
    obs_ok = m.kf_fvalid & (m.kf_obs >= 0)
    dev_obs = sorted(
        (c, tuple(m.X[int(m.kf_obs[w, f])].tolist()), tuple(m.kf_uv[w, f].tolist()))
        for c, w in enumerate(live.tolist()) for f in torch.nonzero(obs_ok[w]).flatten().tolist())
    host_obs = sorted(
        (c, tuple(X[n].tolist()), tuple(uv[c, n].tolist()))
        for c, n in torch.nonzero(mask).tolist())
    assert dev_obs == host_obs

    def center(R, t):
        return (-(R.T @ t)).cpu().numpy()

    def solve(Xs, uvs, ms, its):
        with precise():
            fin, _ = bundle_adjust(BAState(R=R_pad, t=t_pad, X=Xs),
                                   BAProblem(uv=uvs, mask=ms, fixed_cameras=fixed, huber_delta=hd),
                                   iterations=its)
        return center(fin.R[c_new], fin.t[c_new])

    res = {}
    for its in (1, cfg.ba_iterations):
        with precise():
            dev = window_ba(m, iterations=its, huber_delta=hd)
        res[its] = dict(device=center(dev.kf_R[-1], dev.kf_t[-1]), host=solve(X, uv, mask, its),
                        compact=solve(X[keep], uv[:, keep], mask[:, keep], its))
    engine = center(out[0][c_new], out[1][c_new])

    def apart(a, b):
        return float(np.abs(a - b).max())

    print(f"first promotion (frame {host['frame']}, {c_new + 1} keyframes, {int(keep.sum())} "
          f"landmarks, {len(dev_obs)} observations in both engines' problems): the new "
          "keyframe's camera center, device vs host / host vs the host's problem without its "
          f"{int((~keep).sum())} empty columns: " + "; ".join(
              f"{its} it {apart(r['device'], r['host']):.3e} / {apart(r['host'], r['compact']):.3e} m"
              for its, r in res.items())
          + f"; the host engine's own result vs its re-solve "
          f"{apart(engine, res[cfg.ba_iterations]['host']):.3e} m")
    assert apart(res[1]["device"], res[1]["host"]) < 1e-4

    st_h, vo_d = init_vo(cfg, device="cuda"), tvd.DeviceVO(cfg, device="cuda")
    gaps, promoted, before_p = [], [], {}
    run_half_d = vo_d._run_half

    def spy_each_p(k, eager=False):  # the map and buffers just before every P
        if k == 1:
            before_p[len(gaps)] = (tvd.DeviceMap(*(None if a is None else a.clone() for a in vo_d.map)),
                                   tvd._IO(*(a.clone() for a in vo_d._io)))
        return run_half_d(k, eager=eager)

    vo_d._run_half = spy_each_p
    for k in range(40):
        img = seq.render(k)
        process_image(st_h, img)
        n_kf = len(vo_d.state.keyframes)
        vo_d.process_image(img)
        if len(vo_d.state.keyframes) > n_kf:
            promoted.append(k)
        (_, Rh, th), (_, Rd, td) = st_h.trajectory[-1], vo_d.state.trajectory[-1]
        gaps.append(float(np.abs(Rh.T @ th - Rd.T @ td).max()))
    first = next((k for k, g in enumerate(gaps) if g > 1e-4), None)
    print(f"tracked camera centers, host vs device engine: first above 1e-4 m at frame {first}; "
          f"device promotions at frames {promoted}; gap per frame (m): "
          + " ".join(f"{k}:{g:.1e}" for k, g in enumerate(gaps)))

    # The promotion where the gap jumps (first above 1e-3 m): its window as
    # the device built it, solved three ways. (1) _window_ba, the device
    # engine's BA. (2) bundle_adjust, the host engine's solver, on the same
    # observations laid out as the host lays out a window: the columns in
    # another order with empty columns between them. (3) _window_ba with the
    # new keyframe's start moved 1e-4 m, the tracked gap before the jump.
    jump = next((k for k in promoted if gaps[k] > 1e-3), None)
    if jump is None:
        print("no promotion parts the two engines by more than 1e-3 m")
        return
    m0, io = before_p[jump]
    with precise():
        tvd._promote(m0, io.uv_new, io.desc, io.fvalid, io.idx, io.obs_pre, io.R, io.t,
                     tri_angle=cfg.tri_min_ray_angle_deg, iterations=cfg.ba_iterations,
                     huber_delta=hd)
    m = grabbed["m"]
    W = m.kf_obs.shape[0]
    obs = {}  # (ring slot, landmark slot) -> uv; a keyframe's last feature on a slot wins
    ok_w = m.kf_live[:, None] & m.kf_fvalid & (m.kf_obs >= 0)
    for w, f in torch.nonzero(ok_w).tolist():
        obs[(w, int(m.kf_obs[w, f]))] = m.kf_uv[w, f]
    slots = sorted({s for _, s in obs})
    order = np.random.default_rng(0).permutation(len(slots))
    cols = [None] * len(slots)  # the host-like layout: shuffled, an empty column after each
    for n, o in enumerate(order):
        cols[n] = slots[o]
    cols = [c for s in cols for c in (s, None)]
    uv_h = torch.zeros(W, len(cols), 2, device="cuda")
    mask_h = torch.zeros(W, len(cols), dtype=torch.bool, device="cuda")
    X_h = torch.zeros(len(cols), 3, device="cuda")
    for n, s in enumerate(cols):
        if s is None:
            continue
        X_h[n] = m.X[s]
        for w in range(W):
            if (w, s) in obs:
                uv_h[w, n], mask_h[w, n] = obs[(w, s)], True
    first_real = W - int(m.kf_live.sum())
    fixed_h = (~m.kf_live) | (torch.arange(W, device="cuda") < first_real + 2)
    t_moved = m.kf_t.clone()
    t_moved[-1] += 1e-4 / np.sqrt(3.0)
    res = {}
    for its in (1, cfg.ba_iterations):
        with precise():
            dev = window_ba(m, iterations=its, huber_delta=hd)
            fin, _ = bundle_adjust(BAState(R=m.kf_R, t=m.kf_t, X=X_h),
                                   BAProblem(uv=uv_h, mask=mask_h, fixed_cameras=fixed_h,
                                             huber_delta=hd), iterations=its)
            moved = window_ba(m._replace(kf_t=t_moved), iterations=its, huber_delta=hd)
        res[its] = dict(device=center(dev.kf_R[-1], dev.kf_t[-1]),
                        host=center(fin.R[-1], fin.t[-1]),
                        moved=center(moved.kf_R[-1], moved.kf_t[-1]))
    print(f"promotion at frame {jump} (gap {gaps[jump - 1]:.1e} -> {gaps[jump]:.1e} m; "
          f"{len(slots)} landmarks, {len(obs)} observations, {int(m.kf_live.sum())} keyframes): "
          "the new keyframe's camera center, device BA vs the host's solver on the host-like "
          "layout / device BA vs itself from a start moved 1e-4 m: " + "; ".join(
              f"{its} it {apart(r['device'], r['host']):.3e} / {apart(r['device'], r['moved']):.3e} m"
              for its, r in res.items()))
    assert apart(res[1]["device"], res[1]["host"]) < 1e-4


# ---------------------------------------------------------------------------
# The measurement probes' kernels G, S, V and M (ops.cuda_probes)
# ---------------------------------------------------------------------------


def _probe_taps():
    bank = taps.g2h2_bank()  # width 4: 7 filters of 9 taps, the probes' bank
    return bank.xtaps, bank.ytaps


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("rows,lanes,dtype", [(307200, 16, torch.bfloat16), (38400, 256, torch.bfloat16),
                                              (1000, 7, torch.bfloat16), (999, 3, torch.float32),
                                              (50, 5, torch.uint8)])
def test_torch_cuda_probe_gather_rows_bit_equal(cuda, rows, lanes, dtype):
    """Kernel G, rows: the probe's 32 B and 512 B rows and rows of 14, 12
    and 5 bytes (8-, 4- and 1-byte pieces), with indices at the table's last
    row and past both ends (clamped), bit for bit against the plain gather."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    tbl = (torch.randn((rows, lanes), device=cuda, generator=gen).abs() * 50).to(dtype)
    m = 4096 if rows > 1000 else 301
    idx = torch.randint(0, rows, (m,), device=cuda, generator=gen, dtype=torch.int32)
    idx[:4] = torch.tensor([rows - 1, rows, rows + 100, -3], dtype=torch.int32)
    before = kernels.launch_counts()["probe_gather_rows"]
    got = cp.gather_rows(tbl, idx)
    assert kernels.launch_counts()["probe_gather_rows"] == before + 1
    want = cp.gather_rows_plain(tbl, idx)
    assert got.shape == (m, lanes) and torch.equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("h,w,ph,pw,dtype", [(480, 5120, 16, 256, torch.bfloat16),
                                             (37, 300, 5, 33, torch.bfloat16),
                                             (64, 96, 16, 32, torch.float32)])
def test_torch_cuda_probe_gather_patches_bit_equal(cuda, h, w, ph, pw, dtype):
    """Kernel G, patches: the probe's 2,048 16 x 256 bf16 patches, odd widths
    (element copies) and float32 patches, starts unaligned and at and past
    the bottom and right edges (clamped so the window fits)."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    img = torch.randn((h, w), device=cuda, generator=gen).to(dtype)
    k = 2048 if h == 480 else 97
    ys = torch.randint(0, h - ph, (k,), device=cuda, generator=gen, dtype=torch.int32)
    xs = torch.randint(0, (w - pw) // 8, (k,), device=cuda, generator=gen, dtype=torch.int32) * 8
    xs[::5] += 3
    ys[:3] = torch.tensor([h - ph, h - 1, h + 9], dtype=torch.int32)
    xs[:3] = torch.tensor([w - pw, w - 2, w + 40], dtype=torch.int32)
    before = kernels.launch_counts()["probe_gather_patches"]
    got = cp.gather_patches(img, ys, xs, ph, pw)
    assert kernels.launch_counts()["probe_gather_patches"] == before + 1
    want = cp.gather_patches_plain(img, ys, xs, ph, pw)
    assert got.shape == (k, ph, pw) and torch.equal(_bytes(got), _bytes(want))


PROBE_SHAPES = [(16, 512, 512), (2, 61, 83), (1, 130, 70), (1, 1), (3, 5)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_torch_cuda_probe_stages_bit_equal(cuda, shape):
    """Kernel S: every stage with both output conventions, bit for bit
    against the plain stage (correctly rounded sqrt on the card)."""
    xt, yt = _probe_taps()
    img = torch.from_numpy(_texture(shape, seed=11)).to(cuda)
    for outputs in cp.OUTPUTS:
        for stage in cp.STAGES:
            before = kernels.launch_counts()["probe_maps_stages"]
            got = cp.maps_stage(img, xt, yt, stage, outputs)
            assert kernels.launch_counts()["probe_maps_stages"] == before + 1
            want = cp.maps_stage_plain(img, xt, yt, stage, outputs)
            for g, w in zip(got, want):
                assert g.shape == img.shape and torch.equal(g, w), (stage, outputs, shape)


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_torch_cuda_probe_variants_bit_equal(cuda, shape):
    """Kernel V: every case it is built for, carried or not, bit for bit
    against the plain variant; sd is kernel E's tail, so it also equals E's
    fp32 maps."""
    xt, yt = _probe_taps()
    img = torch.from_numpy(np.rint(_texture(shape, seed=12))).to(cuda)
    for tail, carry, tile in sorted(cp.VARIANT_CASES):
        before = kernels.launch_counts()["probe_maps_variants"]
        got = cp.maps_variant(img, xt, yt, tail, carry=carry, tile_h=tile)
        assert kernels.launch_counts()["probe_maps_variants"] == before + 1
        want = cp.maps_variant_plain(img, xt, yt, tail)
        for g, w in zip(got, want):
            assert g.shape == img.shape and torch.equal(g, w), (tail, carry, tile, shape)
    sd = cp.maps_variant(img, xt, yt, "sd")
    assert all(torch.equal(a, b) for a, b in zip(sd, cf.g2_maps(img, xt, yt)))


@pytest.mark.parametrize("shape", PROBE_SHAPES[:3] + [(3, 200, 200)])
def test_torch_cuda_probe_mma_matches_plain(cuda, shape):
    """Kernel M against its plain version (the same bf16 splits and
    products, torch.matmul in fp32), within the tolerance stated in
    ops.cuda_probes (mma_agreement): the tensor cores sum in an order of
    their own, so the row stage (CUDA cores, plain order) is bit-equal, col
    and coeff agree to 1e-5 of scale (1e-4 after the rowmxu row pass), and
    the full maps, ill-conditioned where the orientation is not firm, to
    1e-5 of scale at most pixels and to 1e-3 where it is firm. Shapes: the
    probes' batch (1,024 tiles for the persistent blocks), a ragged one
    smaller than a tile, and widths that are not a multiple of the tile
    width (70, and 200 over four tiles of 64, with tiles inside the image)."""
    xt, yt = _probe_taps()
    img = torch.from_numpy(_texture(shape, seed=13)).to(cuda)
    for stage, row, col in sorted(cp.MMA_CASES):
        before = kernels.launch_counts()["probe_maps_mma"]
        got = cp.maps_mma(img, xt, yt, stage, row, col)
        assert kernels.launch_counts()["probe_maps_mma"] == before + 1
        want = cp.maps_mma_plain(img, xt, yt, stage, row, col)
        assert all(g.shape == img.shape for g in got)
        c3 = cp.maps_mma_plain(img, xt, yt, "coeff", row, col)[1] if stage == "full" else None
        res = cp.mma_agreement(got, want, stage, row, c3)
        assert res["ok"], (stage, row, col, res)


def test_torch_cuda_probe_mma_unaligned_input(cuda):
    """Kernel M on an image whose storage starts 4 bytes past a 16-byte
    boundary: every tile stages through the reflected 4-byte copies, and the
    maps equal those of the same image at an aligned address."""
    xt, yt = _probe_taps()
    img = torch.from_numpy(_texture((2, 200, 136), seed=14)).to(cuda)
    store = torch.empty(img.numel() + 1, device=cuda)
    odd = store[1:].view(img.shape)
    odd.copy_(img)
    assert odd.data_ptr() % 16 != 0
    for stage, row, col in sorted(cp.MMA_CASES):
        for a, b in zip(cp.maps_mma(odd, xt, yt, stage, row, col), cp.maps_mma(img, xt, yt, stage, row, col)):
            assert torch.equal(a, b), (stage, row, col)


def test_torch_cuda_probe_wrappers_raise(cuda):
    xt, yt = _probe_taps()
    img = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):  # the G2/H2 bank at width 4 only
        cp.maps_stage(img, np.zeros((7, 11)), np.zeros((7, 11)), "full")
    with pytest.raises(ValueError):
        cp.maps_variant(img, xt, yt, "tail16", carry=True)
    with pytest.raises(ValueError):
        cp.maps_mma(img, xt, yt, "row", "mma", "bf16x3")
    with pytest.raises(TypeError):
        cp.maps_stage(img.double(), xt, yt, "load")
    with pytest.raises(ValueError):  # int32 indices only
        cp.gather_rows(torch.zeros((4, 8), device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):  # a patch larger than the image
        z = torch.zeros(2, dtype=torch.int32, device=cuda)
        cp.gather_patches(torch.zeros((8, 8), device=cuda), z, z, 16, 4)


# ---------------------------------------------------------------------------
# Serving: the stacked fleet's two graphs (slam.vo_device.DeviceVOFleet)
# ---------------------------------------------------------------------------

FLEET_TICKS = 12  # every seed's stream is initialized and in the stack by then


@pytest.fixture(scope="module")
def serve_frames():
    """[FLEET_TICKS + 4, 8, 480, 640]: eight PlanesSequence seeds' first
    frames (chip_smoke.render_planes, in spawned processes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fleet's steps are captured CUDA graphs")
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke

    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn"),
                             initializer=chip_smoke.one_thread) as pool:
        frames = list(pool.map(chip_smoke.render_planes, [(s, FLEET_TICKS + 4) for s in range(8)]))
    return np.ascontiguousarray(np.stack(frames, 1))


def _fleet_tick(flt, stack):
    from cvsteer_tpu_torch.features.frontend import Features, extract_features

    batch = extract_features(torch.from_numpy(stack).cuda())
    flt.step([Features(*(x[i] for x in batch)) for i in range(stack.shape[0])])


FLEETS = {"S2-classic": (2, {}), "S8-classic": (8, {}),
          "S8-pipelined-cap2": (8, dict(pipeline=True, promote_cap=2))}


@pytest.fixture(scope="module", params=list(FLEETS))
def fleet(request, serve_frames):
    """A fleet on the card, FLEET_TICKS ticks in (every stream active, the
    graphs captured), with the next tick's features in its input buffers."""
    from cvsteer_tpu_torch.features.frontend import extract_features
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

    S, kw = FLEETS[request.param]
    flt = DeviceVOFleet(VOConfig(), n_streams=S, **kw)
    for k in range(FLEET_TICKS):
        _fleet_tick(flt, serve_frames[k, :S])
    flt._flush()
    assert flt.active.all() and flt.captures == 2
    batch = extract_features(torch.from_numpy(serve_frames[FLEET_TICKS, :S]).cuda())
    io = flt._io
    io.yx.copy_(batch.yx)
    io.desc.copy_(batch.desc)
    io.fvalid.copy_(batch.valid)
    io.active.fill_(True)
    for i, eng in enumerate(flt.engines):  # the classic tick's host inputs
        kf = eng.state.keyframes[-1]
        io.pose[i].copy_(torch.from_numpy(np.concatenate([kf.R.reshape(9), kf.t])))
    io.force[0] = True  # stream 0 promotes in FP (classic)
    if flt.aux is not None:  # pipelined: the gap counter forces it
        flt.aux.since_kf[0] = 100
        flt.aux.block[0] = False
    return flt


def _fleet_state(flt):
    return [a.clone() for t in (flt.stack, flt._io, flt.aux) if t is not None
            for a in t if a is not None]


def _fleet_run_from(flt, snap, half, eager):
    dsts = [a for t in (flt.stack, flt._io, flt.aux) if t is not None for a in t if a is not None]
    for dst, src in zip(dsts, snap):
        dst.copy_(src)
    flt._run_half(half, eager=eager)
    torch.cuda.synchronize()
    return _fleet_state(flt)


@pytest.mark.parametrize("half", [0, 1], ids=["FT", "FP"])
def test_torch_cuda_fleet_graphs_equal_eager_and_replay(fleet, half):
    """Each fleet graph gives the same stack and outputs as its half run
    eagerly on the same carried-in state, bit for bit, and two replays
    agree; FP runs on FT's outputs, with at least one stream promoting."""
    snap = _fleet_state(fleet)
    if half == 1:
        snap = _fleet_run_from(fleet, snap, 0, eager=False)
        assert bool(fleet._io.promote.any())
    eager = _fleet_run_from(fleet, snap, half, eager=True)
    first = _fleet_run_from(fleet, snap, half, eager=False)
    again = _fleet_run_from(fleet, snap, half, eager=False)
    for n, (e, a, b) in enumerate(zip(eager, first, again)):
        assert torch.equal(a, e), f"buffer {n}: the graph differs from the eager half"
        assert torch.equal(a, b), f"buffer {n}: two replays differ"
    _fleet_run_from(fleet, snap, half, eager=False)


def test_torch_cuda_fleet_fp_launches_ba_kernels_once_an_iteration(fleet):
    """FP's window BA over every stream (or the capped sub-batch) launches
    ba_schur once an LM iteration and ba_update once more (the initial
    cost), whatever S is."""
    snap = _fleet_run_from(fleet, _fleet_state(fleet), 0, eager=False)
    n = fleet.config.ba_iterations
    before = kernels.launch_counts()
    _fleet_run_from(fleet, snap, 1, eager=True)
    after = kernels.launch_counts()
    assert (after["ba_schur"] - before["ba_schur"], after["ba_update"] - before["ba_update"]) == (
        n, n + 1)
    _fleet_run_from(fleet, snap, 1, eager=False)


def test_torch_cuda_fleet_frontend_batch_bit_equal(serve_frames):
    """B, C and D at the fleet's batch, [8, 480, 640], bit for bit against
    their plain versions (chip_smoke.frontend_agreement)."""
    import chip_smoke
    from cvsteer_tpu_torch.features.frontend import FrontendConfig
    from cvsteer_tpu_torch.filters.g2 import g2_bank

    fe = chip_smoke.frontend_agreement(torch.from_numpy(serve_frames[0]).cuda(),
                                       FrontendConfig(), g2_bank())
    for k in ("pyr_down", "g2_features_full", "desc_sample"):
        assert fe[k][1], (k, fe[k][0])
    assert fe["p3_keep_agreement"] == 1.0


def test_torch_cuda_fleet_captures_twice_and_keeps_buffers(serve_frames):
    """The fleet captures its two graphs once and never again, its engines
    none; a blackout of one stream takes the event path (the row copied out
    into the engine's buffers, relocalized on the host, copied back): every
    stack and engine buffer keeps its address."""
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

    flt = DeviceVOFleet(VOConfig(), n_streams=2)
    for k in range(FLEET_TICKS):
        _fleet_tick(flt, serve_frames[k, :2])
    assert flt.captures == 2 and flt.active.all()
    stack = [a.data_ptr() for a in flt.stack if a is not None]
    bufs = [[a.data_ptr() for a in e._bufs if a is not None] for e in flt.engines]
    for k in range(2):  # stream 0 sees blank frames: lost, the host path
        frames = serve_frames[FLEET_TICKS + k, :2].copy()
        frames[0] = 0.0
        _fleet_tick(flt, frames)
    for k in range(FLEET_TICKS + 2, serve_frames.shape[0]):
        _fleet_tick(flt, serve_frames[k, :2])
    states = [flt.finalize(i) for i in range(2)]
    assert flt.captures == 2 and [e.captures for e in flt.engines] == [0, 0]
    assert [a.data_ptr() for a in flt.stack if a is not None] == stack
    assert [[a.data_ptr() for a in e._bufs if a is not None] for e in flt.engines] == bufs
    for st in states:
        assert st.frame_count == serve_frames.shape[0] and np.isfinite(st.poses()[1]).all()


def test_torch_cuda_fleet_closure_keeps_buffers():
    """A Sim(3) closure event of a fleet row (the drifted loop-world state
    of test_torch_cuda_vo_closure_upload_keeps_buffers, adopted by both
    engines of a 2-stream fleet): accepted through the fleet's event path,
    the keyframe ATE halved, and no buffer rebound, no graph captured
    again."""
    import copy

    import chip_smoke as cs
    from cvsteer_tpu_torch.geometry.camera import Intrinsics
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO, DeviceVOFleet

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fleet's steps are captured CUDA graphs")
    X, desc = cs._loop_world()
    rng = np.random.default_rng(11)
    n_frames = 48
    gt = [cs._circle_pose(k, n_frames - 1) for k in range(n_frames)]
    frames = [cs._render_feats(X, desc, R, t, rng) for R, t in gt]
    cfg = VOConfig(intrinsics=Intrinsics(*cs.LOOP_K), kf_max_gap=4, window=6,
                   track_min_landmarks=40, min_parallax=0.01)
    vo = DeviceVO(cfg, device="cuda")
    for k in range(40):
        vo.process_frame(frames[k])
    st = vo.sync_host()
    assert cs._inject_scale_drift(st, rate=0.07) > 1.8
    before = cs._kf_ate(st, gt)
    cfg2 = cfg._replace(loop_closure=True, loop_closure_sim3=True, loop_min_gap=6,
                        loop_min_inliers=20)
    st.config = cfg2
    flt = DeviceVOFleet(cfg2, n_streams=2)
    for eng in flt.engines:
        eng.adopt(copy.deepcopy(st))
    flt.step([frames[40], frames[40]])  # the adopted states enter the stack
    stack = [a.data_ptr() for a in flt.stack if a is not None]
    bufs = [[a.data_ptr() for a in e._bufs if a is not None] for e in flt.engines]
    for k in range(41, n_frames):
        flt.step([frames[k], frames[k]])
    finals = [flt.finalize(i) for i in range(2)]
    assert all(e.closures_accepted >= 1 for e in flt.engines)
    assert all(cs._kf_ate(f, gt) < 0.5 * before for f in finals)
    assert flt.captures == 2 and [e.captures for e in flt.engines] == [0, 0]
    assert [a.data_ptr() for a in flt.stack if a is not None] == stack
    assert [[a.data_ptr() for a in e._bufs if a is not None] for e in flt.engines] == bufs


@pytest.mark.parametrize("depth", [1, 3])
def test_torch_cuda_fleet_ring_hands_back_each_tick(serve_frames, depth):
    """With ``depth`` ticks in flight, the pinned ring slot the host reads
    for tick k holds tick k's fetch: each tick's output is also cloned on
    the device right after FP (stream-ordered, no wait) and compared with
    what the host read. Then the fleet tracks as the per-stream pipelined
    step does: equal keyframes and poses."""
    from cvsteer_tpu_torch.features.frontend import extract_features
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet

    S, boot = 4, 6

    def run(batched):
        flt = DeviceVOFleet(VOConfig(), n_streams=S, pipeline=True, promote_cap=2,
                            pipeline_depth=depth)
        sent, seen = [], []
        launch, process = flt._launch, flt._process

        def spy_launch(*a):
            launch(*a)
            sent.append(flt._io.pipe_out.clone())

        def spy_process(pending, *rest):
            pending[4].synchronize()  # the tick's fetch has landed
            seen.append(flt._ring[pending[2]].clone())
            process(pending, *rest)

        flt._launch, flt._process = spy_launch, spy_process
        for k in range(serve_frames.shape[0]):
            if batched and k >= boot and flt.active.all():
                b = extract_features(torch.from_numpy(serve_frames[k, :S]).cuda())
                flt.step_batched(b.yx, b.desc, b.valid)
            else:
                _fleet_tick(flt, serve_frames[k, :S])
        states = [flt.finalize(i) for i in range(S)]
        assert len(seen) == len(sent) > 0
        for k, (a, b) in enumerate(zip(sent, seen)):
            assert torch.equal(a.cpu(), b), f"tick {k}: the host read another tick's fetch"
        return states

    got, want = run(True), run(False)
    for a, b in zip(got, want):
        assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes]
        np.testing.assert_array_equal(a.poses()[1], b.poses()[1])


# ---------------------------------------------------------------------------
# The generic feature path: kernel D at the G4/H4 basis's 11 channels, and
# the device engine's chunk graph C
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,S", [(11, 16), (11, 40), (16, 16)])
def test_torch_cuda_sample_patches_levels_wide_bit_equal(cuda, C, S):
    """Kernel D with 11 channels (the G4/H4 basis; its window is sized by
    C) and with 16, the most it takes: ragged levels, clouds clipped at the
    corners and edges, scattered samples, bit for bit against the plain
    version; 17 channels raise."""
    shapes = [(40, 64), (61, 83), (16, 21), (3, 5), (1, 1)]
    counts = [37, 21, 0, 11, 3]
    bases = [torch.from_numpy(_texture((2, C) + s, seed=5 + i)).to(cuda) for i, s in enumerate(shapes)]
    ys, xs = _corner_clouds(cuda, shapes, counts, S, seed=6)
    got = cd.sample_patches_levels(bases, ys, xs, counts)
    want = cd.sample_patches_levels_plain(bases, ys, xs, counts)
    assert got.shape == (2, sum(counts), S, C) and torch.equal(got, want)
    with pytest.raises(ValueError):
        wide = [torch.zeros((2, 17) + s, device=cuda) for s in shapes]
        cd.sample_patches_levels(wide, ys, xs, counts)


@pytest.mark.parametrize("cfg_kw", [dict(order=4), dict(score="strength"), dict(order=4, nms_radius=1)],
                         ids=["g4", "g2_strength", "g4_nms1"])
def test_torch_cuda_extract_features_generic_equals_plain(cuda, cfg_kw):
    """The generic path on the card equals the same path with every kernel
    replaced by its plain version (chip_smoke.plain_kernels), field for
    field and bit for bit; one call launches B′ once, A once per level and
    D′ once."""
    import chip_smoke
    from cvsteer_tpu_torch.features.frontend import FrontendConfig, extract_features

    cfg = FrontendConfig(**cfg_kw)
    x = torch.from_numpy(_texture((3, 120, 160), seed=8)).to(cuda)
    kernels.reset_launch_counts()
    got = extract_features(x, cfg=cfg)
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    assert (n["pyr_down"], n["filter_bank"], n["desc_sample"]) == (1, cfg.levels, 1)
    with chip_smoke.plain_kernels():
        want = extract_features(x, cfg=cfg)
    assert int(got.valid.sum()) > 300
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def _chunk_run(frames, chunk, cfg=None):
    """(sequential DeviceVO, chunked DeviceVO) over the feature rows; one
    chunk length, so C is captured once."""
    from cvsteer_tpu_torch.slam.vo import VOConfig
    from cvsteer_tpu_torch.slam.vo_device import DeviceVO

    cfg = cfg or VOConfig()
    seq, vo = DeviceVO(cfg), DeviceVO(cfg)
    for f in frames:
        seq.process_frame(f)
    k = 0
    while k < len(frames):
        if vo.map is None or len(frames) - k < chunk:  # bootstrap, or a short tail
            vo.process_frame(frames[k])
            k += 1
            continue
        span = chunk
        part = frames[k:k + span]
        rows = vo.issue_chunk(*(torch.stack([getattr(f, a) for f in part])
                                for a in ("yx", "desc", "valid")))
        for j in range(vo.complete_chunk(part, rows), span):
            vo.process_frame(part[j])
        k += span
    return seq, vo


def test_torch_cuda_vo_chunk_graph_equals_sequential_and_eager(cuda):
    """Graph C: 32 rendered frames in chunks of 4 give the sequential
    engine's keyframes and poses bit for bit; the engine holds 3 graphs;
    C's replay equals the same chunk run eagerly from the same state."""
    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam import vo_device as tvd

    seq_r = PlanesSequence(n_frames=32)
    imgs = torch.from_numpy(np.stack([seq_r.render(k) for k in range(32)])).to(cuda)
    batch = extract_features(imgs)
    frames = [Features(*(f[k] for f in batch)) for k in range(32)]
    seq, vo = _chunk_run(frames, 4)
    a, b = seq.finalize(), vo.finalize()
    assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes]
    assert len(b.keyframes) >= 3 and vo.captures == 3
    for (fa, Ra, ta), (fb, Rb, tb) in zip(a.trajectory, b.trajectory):
        assert fa == fb and np.array_equal(Ra, Rb) and np.array_equal(ta, tb)

    ch, graph, _ = vo._chunks[4]
    live = [t for t in vo.map if t is not None] + list(vo._io) + list(ch)
    snap = [t.clone() for t in live]

    def run(eager):
        for dst, src in zip(live, snap):
            dst.copy_(src)
        if eager:
            track, promote = tvd._step_kwargs(vo.state.config)
            with tvd._step_math(vo.device):
                tvd._chunk_half(vo.map, vo._io, ch, track=track, promote=promote)
        else:
            graph.replay()
        torch.cuda.synchronize()
        return [t.clone() for t in live]

    for e, r in zip(run(True), run(False)):
        assert torch.equal(e, r)


def test_torch_cuda_vo_chunk_graph_with_speed_clamp_equals_sequential(cuda, monkeypatch):
    """Graph C with the speed clamp on (speed_prior_band (0.9, 1.1),
    keyframes at most 2 frames apart, chunks of 8: C leaves the map as it
    was after a chunk's first promotion): the clamp fires on the same
    frames as in the sequential engine, and the keyframes and poses are
    the sequential engine's bit for bit."""
    from cvsteer_tpu_torch.features.frontend import Features, extract_features
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.slam import vo as hostvo
    from cvsteer_tpu_torch.slam.vo import VOConfig

    fired = []
    apply = hostvo.apply_speed_prior

    def spy(state, fresh_ids=None):
        hit = apply(state, fresh_ids=fresh_ids)
        if hit:
            fired.append((id(state), state.frame_count))
        return hit
    monkeypatch.setattr(hostvo, "apply_speed_prior", spy)
    seq_r = PlanesSequence(n_frames=32)
    imgs = torch.from_numpy(np.stack([seq_r.render(k) for k in range(32)])).to(cuda)
    batch = extract_features(imgs)
    frames = [Features(*(f[k] for f in batch)) for k in range(32)]
    seq, vo = _chunk_run(frames, 8, VOConfig(speed_prior_band=(0.9, 1.1), kf_max_gap=2))
    by = {id(seq.state): [], id(vo.state): []}
    for key, frame in fired:
        by[key].append(frame)
    assert by[id(seq.state)] and by[id(seq.state)] == by[id(vo.state)]
    a, b = seq.finalize(), vo.finalize()
    assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes]
    assert vo.captures == 3
    for (fa, Ra, ta), (fb, Rb, tb) in zip(a.trajectory, b.trajectory):
        assert fa == fb and np.array_equal(Ra, Rb) and np.array_equal(ta, tb)

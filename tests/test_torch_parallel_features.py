"""Sharded feature extraction (parallel.sharded_extract_features) in one
4-rank gloo world on the CPU: the reference's tests/test_parallel_features.py
(:41, :69, :98) at its own shapes and blurred-noise scenes, on 4 ranks.

The single-device reference of the sharded path is the port's generic path
(features.frontend._extract_features_generic), computed on rank 0: the
sharded Features equal it bit for bit, over {data: 2, space: 2} and
{space: 4}, at orders 2 and 4, with levels sharded and levels replicated,
and with keypoints whose descriptor clouds clamp at the global borders.
Every rank of a space group returns the same Features. One cross-package
case holds the gathered result to JAX's single-device extract_features (its
generic path off the TPU) at the generic bar: >= 98 % of keypoints within
0.5 px at the same level, matched descriptors within 2e-2. The ranks import
neither jax nor OpenCV.
"""

import numpy as np
import pytest

WORLD = 4
# name: (data, space, rows, FrontendConfig overrides, seed)
CASES = {
    # level 0 and 1 sharded (48- and 24-row slabs), 2 and 3 replicated
    "g2_data2_space2": (2, 2, 96, dict(levels=4, keypoints_per_level=64, threshold=1e-4), 11),
    # 32-row slabs at S = 4, level 1 (16 rows) replicated
    "g2_space4": (1, 4, 128, dict(levels=2, keypoints_per_level=64, threshold=1e-4), 11),
    "g4_space4": (1, 4, 96, dict(levels=2, keypoints_per_level=32, order=4, threshold=1e-5), 7),
    "g4_data2_space2": (2, 2, 128, dict(levels=3, keypoints_per_level=32, order=4,
                                        threshold=1e-5), 7),
    # strong blobs at rows 4 and H - 5: descriptor clouds clamp at the image edge
    "border_space4": (1, 4, 128, dict(levels=1, keypoints_per_level=32, threshold=1e-6), 3),
}


def _blur(imgs: np.ndarray) -> np.ndarray:
    """Band-limited random texture (the reference test's scene)."""
    k = (np.hanning(9) / np.hanning(9).sum()).astype(np.float32)
    out = imgs
    for ax in (1, 2):
        out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, out)
    return out


def _scene(name):
    data, space, h, _, seed = CASES[name]
    rng = np.random.default_rng(seed)
    b = 1 if name.startswith("border") else 2
    imgs = _blur(rng.standard_normal((b, h, 128)).astype(np.float32) * 40.0)
    if name.startswith("border"):
        imgs[0, 4, 20] += 300.0
        imgs[0, h - 5, 100] += 300.0
        imgs = _blur(imgs)
    return np.ascontiguousarray(imgs, dtype=np.float32)


def _rank_cases(rank):
    import torch

    from cvsteer_tpu_torch.features.frontend import FrontendConfig, _extract_features_generic
    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4
    from cvsteer_tpu_torch.parallel import (
        gather_blocks, make_mesh, shard_batch, sharded_extract_features,
    )

    out = {}
    for name, (data, space, _, kw, _) in CASES.items():
        cfg = FrontendConfig(**kw)
        imgs = _scene(name)
        mesh = make_mesh({"data": data, "space": space}, "cpu")
        local = sharded_extract_features(shard_batch(imgs, mesh), mesh, cfg)
        full = gather_blocks(local, mesh, row_dim=None)
        res = {"local": [x.numpy() for x in local], "coords": mesh.get_coordinate()}
        if rank == 0:
            fm = fg4 if cfg.order == 4 else fg2
            bank = fm.g4_bank() if cfg.order == 4 else fm.g2_bank()
            basis_fn = (lambda im: fm.g4_basis(im, bank)) if cfg.order == 4 else (
                lambda im: fm.g2_basis(im, bank))
            ref = _extract_features_generic(torch.from_numpy(imgs), cfg, basis_fn=basis_fn,
                                            coeff_fn=fm.energy_coefficients)
            res["full"] = [x.numpy() for x in full]
            res["ref"] = [x.numpy() for x in ref]
        out[name] = res
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from cvsteer_tpu_torch.parallel.launch import spawn_world

    return spawn_world(_rank_cases, WORLD, device_type="cpu", workdir=str(tmp_path_factory.mktemp("world")))


FIELDS = ("yx", "score", "theta", "level", "desc", "valid")


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_sharded_features_equal_generic_path(world, name):
    got, want = world[0][name]["full"], world[0][name]["ref"]
    valid = want[FIELDS.index("valid")]
    assert valid.any(), "test scene produced no keypoints"
    for field, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=f"field {field}")
    if name.startswith("border"):
        rows = want[0][0, valid[0], 0]
        assert rows.min() < 8 and rows.max() > 120, "border blobs not detected"


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_sharded_features_replicated_over_space(world, name):
    """Every rank of a data block's space group holds the same Features."""
    by_data = {}
    for r in world:
        d = r[name]["coords"][0]
        by_data.setdefault(d, []).append(r[name]["local"])
    for blocks in by_data.values():
        for other in blocks[1:]:
            for a, b in zip(blocks[0], other):
                np.testing.assert_array_equal(a, b)


def test_torch_sharded_features_match_jax(world):
    """The gathered sharded Features against the reference's single-device
    extract_features (generic off the TPU) at the generic bar."""
    import jax
    import jax.numpy as jnp

    from cvsteer_tpu.features.frontend import FrontendConfig as JConfig
    from cvsteer_tpu.features.frontend import extract_features as j_extract

    name = "g2_data2_space2"
    cfg = JConfig(**CASES[name][3])
    fj = jax.jit(lambda im: j_extract(im, cfg=cfg))(jnp.asarray(_scene(name)))
    yx, _, _, level, desc, valid = world[0][name]["full"]
    for b in range(valid.shape[0]):
        vj, vt = np.asarray(fj.valid)[b], valid[b]
        assert vj.sum() > 80
        yj, yt = np.asarray(fj.yx)[b][vj], yx[b][vt]
        lj, lt = np.asarray(fj.level)[b][vj], level[b][vt]
        d = np.linalg.norm(yj[:, None] - yt[None], axis=-1) + 1e3 * (lj[:, None] != lt[None])
        near = d.min(1) < 0.5
        assert near.mean() >= 0.98 and abs(int(vj.sum()) - int(vt.sum())) <= 0.02 * vj.sum()
        dj, dt = np.asarray(fj.desc)[b][vj][near], desc[b][vt][d.argmin(1)[near]]
        assert np.abs(dj - dt).max() < 2e-2

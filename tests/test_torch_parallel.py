"""The port's mesh, halo exchange and sharded maps (cvsteer_tpu_torch.parallel)
in one 4-rank gloo world on the CPU: the reference's tests/test_parallel.py
(:21-79, :169, :276) on torch.distributed.

Every case runs in the one world the module fixture spawns; each rank
returns numpy results and the parent asserts them case by case. The ranks
import neither jax nor OpenCV (jax is imported inside the tests, in the
parent):

- make_mesh's shapes, the -1 inference, and its errors word for word with
  the reference's over the same count of devices;
- halo rows equal to REFLECT_101 rows of the whole image at space sizes 4,
  2 and 1;
- sharded_g2_maps, sharded_g4_maps and sharded_filter_bank (G4) against the
  port's single-device pipeline computed on rank 0, over {data: 4},
  {data: 2, space: 2} and {space: 4}, at the reference's bar (bit-equality
  is printed);
- the gathered sharded G2 maps against JAX's steerable_pipeline_g2
  (method="xla") at tests/test_torch_maps.py's bar.
"""

import numpy as np
import pytest
import torch

from cvsteer_tpu_torch.ops.sepconv import filter_bank_xla, reflect_pad_2d

WORLD = 4
MESHES = {"data4": {"data": 4}, "data2_space2": {"data": 2, "space": 2}, "space4": {"space": 4}}
HALO_MESHES = {4: {"space": 4}, 2: {"data": 2, "space": 2}, 1: {"data": 4, "space": 1}}
MESH_ERRORS = [{"data": 3, "space": 2}, {"data": -1, "space": -1}, {"data": -1, "space": 3}]
HALO_R = 4


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _rank_cases(rank):
    """Every case of this file on one rank of the world."""
    import torch.distributed as dist

    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4
    from cvsteer_tpu_torch.filters.taps import g4h4_bank
    from cvsteer_tpu_torch.parallel import (
        gather_blocks, halo_exchange_rows, make_mesh, shard_batch, sharded_filter_bank,
        sharded_g2_maps, sharded_g4_maps,
    )
    from cvsteer_tpu_torch.parallel.mesh import mesh_axis

    out = {"meshes": {}, "errors": [], "halo": {}, "maps": {}, "bank": {}}
    for axes in ({"data": 2, "space": 2}, {"data": -1, "space": 2}, {"space": -1}):
        m = make_mesh(axes, "cpu")
        out["meshes"][str(axes)] = (m.mesh_dim_names, tuple(m.mesh.shape), m.mesh.tolist())
    for axes in MESH_ERRORS:
        try:
            make_mesh(axes, "cpu")
            out["errors"].append(None)
        except ValueError as e:
            out["errors"].append(str(e))

    x = _images(1, (4, 64, 16))
    for size, axes in HALO_MESHES.items():
        mesh = make_mesh(axes, "cpu")
        _, _, group = mesh_axis(mesh, "space")
        blk = halo_exchange_rows(shard_batch(x, mesh), HALO_R, group)
        out["halo"][size] = (mesh_axis(mesh, "data")[:2], mesh_axis(mesh, "space")[:2], blk.numpy())

    imgs = _images(2, (4, 64, 48))
    t = torch.from_numpy(imgs)
    g4b = g4h4_bank()
    for name, axes in MESHES.items():
        mesh = make_mesh(axes, "cpu")
        blk = shard_batch(imgs, mesh)
        g2 = gather_blocks(sharded_g2_maps(blk, mesh), mesh)
        g4 = gather_blocks(sharded_g4_maps(blk, mesh), mesh)
        bank = gather_blocks(sharded_filter_bank(blk, g4b.xtaps, g4b.ytaps, mesh), mesh)
        if rank == 0:
            r2 = fg2.steerable_pipeline_g2(t)
            r4 = fg4.steerable_pipeline_g4(t)
            ref4 = (fg2.find_edges(r4.magnitude, r4.phase), fg2.find_dark_lines(r4.magnitude, r4.phase),
                    fg2.find_bright_lines(r4.magnitude, r4.phase))
            out["maps"][name] = {
                2: ([m.numpy() for m in g2], [r2.edges.numpy(), r2.lines_dark.numpy(),
                                              r2.lines_bright.numpy()]),
                4: ([m.numpy() for m in g4], [m.numpy() for m in ref4]),
            }
            out["bank"][name] = (bank.numpy(), filter_bank_xla(t, g4b.xtaps, g4b.ytaps).numpy())
    out["world"] = dist.get_world_size()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from cvsteer_tpu_torch.parallel.launch import spawn_world

    return spawn_world(_rank_cases, WORLD, device_type="cpu", workdir=str(tmp_path_factory.mktemp("world")))


def test_torch_make_mesh_shapes(world):
    got = world[0]["meshes"]
    assert got[str({"data": 2, "space": 2})] == (("data", "space"), (2, 2), [[0, 1], [2, 3]])
    assert got[str({"data": -1, "space": 2})][1] == (2, 2)
    assert got[str({"space": -1})][:2] == (("space",), (4,))
    assert all(r["meshes"] == world[0]["meshes"] and r["world"] == WORLD for r in world)


def test_torch_make_mesh_errors_match_reference(world):
    """The same ValueErrors as the reference's make_mesh over as many devices."""
    import jax

    from cvsteer_tpu.parallel import make_mesh as jmake_mesh

    want = []
    for axes in MESH_ERRORS:
        with pytest.raises(ValueError) as e:
            jmake_mesh(axes, devices=jax.devices()[:WORLD])
        want.append(str(e.value))
    assert world[0]["errors"] == want
    assert want[0] == "mesh {'data': 3, 'space': 2} != 4 devices"


@pytest.mark.parametrize("space", sorted(HALO_MESHES))
def test_torch_halo_exchange_matches_reflect_pad(world, space):
    """Each rank's haloed block == the REFLECT_101-padded image's rows."""
    x = _images(1, (4, 64, 16))
    padded = np.pad(x, ((0, 0), (HALO_R, HALO_R), (0, 0)), mode="reflect")
    for r in world:
        (nd, d), (ns, s), blk = r["halo"][space]
        assert ns == space
        b, h = 4 // nd, 64 // ns
        np.testing.assert_array_equal(blk, padded[d * b:(d + 1) * b, s * h: s * h + h + 2 * HALO_R])


def test_torch_filter_bank_valid_rows_matches_padded():
    """The bank on rows that carry their halo == the padded bank, bit for bit
    (the reference checks 1e-5; the shift-and-add loop sums in one order)."""
    from cvsteer_tpu_torch.filters.g2 import g2_bank

    bank = g2_bank()
    img = torch.from_numpy(np.random.default_rng(3).standard_normal((24, 40)).astype(np.float32))
    full = filter_bank_xla(img, bank.xtaps, bank.ytaps)
    pre = reflect_pad_2d(img, bank.radius, axes=(True, False))
    valid = filter_bank_xla(pre, bank.xtaps, bank.ytaps, pad_axes=(False, True))
    assert valid.shape == full.shape == (7, 24, 40)
    assert torch.equal(valid, full)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_torch_sharded_maps_match_single_device(world, mesh, order):
    """The reference's bars: G2 rtol 1e-5 / atol 1e-4 (test_parallel.py:65-77),
    G4 rtol 1e-4 / atol 1e-3 (:276)."""
    got, want = world[0]["maps"][mesh][order]
    tol = dict(rtol=1e-5, atol=1e-4) if order == 2 else dict(rtol=1e-4, atol=1e-3)
    for g, w in zip(got, want):
        assert g.shape == (4, 64, 48)
        np.testing.assert_allclose(g, w, **tol)
    print(f"\nsharded G{order} maps over {mesh}: bit-equal "
          f"{all(np.array_equal(g, w) for g, w in zip(got, want))}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_torch_sharded_filter_bank_g4(world, mesh):
    got, want = world[0]["bank"][mesh]
    assert got.shape == (4, 11, 64, 48)
    np.testing.assert_array_equal(got, want)


def test_torch_sharded_g2_maps_match_jax(world):
    """The gathered sharded maps against the reference's fp32 pipeline at
    tests/test_torch_maps.py's bar, max |d| / mean |ref| < 5e-3."""
    import jax.numpy as jnp

    from cvsteer_tpu.filters import g2 as jg2

    m = jg2.steerable_pipeline_g2(jnp.asarray(_images(2, (4, 64, 48))), jg2.g2_bank(), method="xla")
    got, _ = world[0]["maps"]["data2_space2"][2]
    for g, w in zip(got, (m.edges, m.lines_dark, m.lines_bright)):
        w = np.asarray(w)
        assert np.abs(g - w).max() / (np.abs(w).mean() + 1e-6) < 5e-3

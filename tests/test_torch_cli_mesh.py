"""``cli --mesh`` (the reference's tests/test_cli.py:73-153) on the port, in
one 4-rank gloo world on the CPU whose ranks are given torchrun's
environment and join through ``env://`` (parallel.make_mesh's path).

- data=2,space=2: every rank runs the CLI on the same list and rank 0 alone
  writes; G2 and G4. The sharded path makes fp32 maps, as the reference's:
  its PNGs equal the port's single-device fp32 pipeline quantized the same
  way. The unsharded CLI writes bfloat16 maps (kernels E/E4), and the two
  classes part by 2 grey levels at a few pixels (a 2^-9 rounding of each
  pixel and of the normalizing max; up to 9e-5 of the pixels here, as
  tests/test_torch_cli.py found against the reference): the sharded PNGs
  are within 2 levels of the unsharded ones, and within 1 at >= 99.9 % of
  the pixels;
- the fish (185 rows, a batch of 1) cannot shard: its line reads "mesh
  skipped ... not divisible" and its PNGs are written all the same;
- 'data', 'data=x' and 'rows=8' are rejected with SystemExit, as is a mesh
  that does not cover the world;
- --mesh space=1 without torchrun makes its own 1-rank world.
"""

import contextlib
import io
import os
import pathlib
import pickle
import socket

import numpy as np
import pytest

WORLD = 4
REPO = pathlib.Path(__file__).resolve().parent.parent
FISH = REPO / "cvsteer_tpu_torch" / "io" / "golden" / "fish.png"
MAPS = ("edges", "lines_dark", "lines_bright")


def _write_inputs(root: pathlib.Path) -> pathlib.Path:
    from cvsteer_tpu_torch.io.imageio import imwrite_u8

    rng = np.random.default_rng(5)
    names = []
    for i in range(4):
        p = root / f"im{i}.png"
        imwrite_u8(str(p), rng.integers(0, 255, (64, 128), dtype=np.uint8))
        names.append(str(p))
    lst = root / "in.txt"
    lst.write_text("\n".join(names + [str(FISH)]) + "\n")
    return lst


def _rank_cli(rank, lst, out):
    """Run the CLI on this rank as torchrun would: G2 and G4 sharded, and a
    mesh that does not cover the world. The world is joined first, through
    ``env://`` as under torchrun, so the CLI calls share it (a CLI that made
    the world ends it, and a new one on the same port would race)."""
    import torch.distributed as dist

    from cvsteer_tpu_torch import cli
    from cvsteer_tpu_torch.parallel import make_mesh

    make_mesh({"data": 2, "space": 2}, "cpu")
    res = {"backend": dist.get_backend()}
    for filters in ("g2", "g4"):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            res[filters] = cli.main(["--input", lst, "--output", f"{out}/{filters}", "--filters",
                                     filters, "--mesh", "data=2,space=2", "--device", "cpu"])
        res[filters + "_err"] = err.getvalue()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["--input", lst, "--mesh", "data=3", "--device", "cpu"])
        res["bad_world"] = None
    except SystemExit as e:
        res["bad_world"] = e.code
    return res


def _torchrun_rank(rank, port, lst, out):
    """One rank under torchrun's environment (a localhost rendezvous on
    ``port``): ``_rank_cli``'s result pickled beside ``out``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the host's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        res = _rank_cli(rank, lst, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out}_rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _spawn_torchrun_world(lst, out):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_torchrun_rank, args=(port, lst, out), nprocs=WORLD, start_method="spawn")
    ranks = []
    for rank in range(WORLD):
        with open(f"{out}_rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _fp32_pngs(lst, filters):
    """The 8-bit maps of the port's single-device fp32 pipeline on the
    list's 64x128 images."""
    import torch

    from cvsteer_tpu_torch.filters import g2 as fg2
    from cvsteer_tpu_torch.filters import g4 as fg4
    from cvsteer_tpu_torch.utils.imageproc import normalize_minmax_u8

    imgs = torch.from_numpy(np.stack([_read(p) for p in lst.read_text().split()[:4]]).astype(np.float32))
    if filters == "g2":
        m = fg2.steerable_pipeline_g2(imgs)
        maps = (m.edges, m.lines_dark, m.lines_bright)
    else:
        m = fg4.steerable_pipeline_g4(imgs)
        maps = (fg2.find_edges(m.magnitude, m.phase), fg2.find_dark_lines(m.magnitude, m.phase),
                fg2.find_bright_lines(m.magnitude, m.phase))
    return [normalize_minmax_u8(x, axes=(-2, -1)).numpy().astype(int) for x in maps]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from cvsteer_tpu_torch import cli

    root = tmp_path_factory.mktemp("cli_mesh")
    lst = _write_inputs(root)
    ranks = _spawn_torchrun_world(str(lst), str(root / "mesh"))
    for filters in ("g2", "g4"):
        assert cli.main(["--input", str(lst), "--output", str(root / "ref" / filters),
                         "--filters", filters, "--device", "cpu"]) == 0
    return root, ranks


def _read(p):
    from cvsteer_tpu_torch.io.imageio import imread_gray_f32

    img = imread_gray_f32(str(p))
    assert img is not None, p
    return img.astype(int)


@pytest.mark.parametrize("filters", ["g2", "g4"])
def test_torch_cli_mesh_matches_unsharded(run, filters):
    root, ranks = run
    assert all(r[filters] == 0 for r in ranks)
    fp32 = _fp32_pngs(root / "in.txt", filters)
    for i in range(4):
        for k, m in enumerate(MAPS):
            a = _read(root / "mesh" / filters / f"im{i}_{m}.png")
            b = _read(root / "ref" / filters / f"im{i}_{m}.png")
            assert a.shape == (64, 128)
            np.testing.assert_array_equal(a, fp32[k][i])
            assert np.abs(a - b).max() <= 2 and (np.abs(a - b) <= 1).mean() >= 0.999
    # only rank 0 writes and prints
    assert sorted(p.name for p in (root / "mesh" / filters).iterdir()) == sorted(
        f"{n}_{m}.png" for n in ("fish", "im0", "im1", "im2", "im3") for m in MAPS)
    assert all(r[filters + "_err"] == "" for r in ranks[1:])


@pytest.mark.parametrize("filters", ["g2", "g4"])
def test_torch_cli_mesh_skip_reason(run, filters):
    """The fish cannot shard: the reference's reason, word for word, and
    the unsharded maps."""
    root, ranks = run
    err = ranks[0][filters + "_err"]
    assert err == "mesh skipped for batch (1, 185, 256): batch 1 not divisible by data=2\n"
    for m in MAPS:
        np.testing.assert_array_equal(_read(root / "mesh" / filters / f"fish_{m}.png"),
                                      _read(root / "ref" / filters / f"fish_{m}.png"))


@pytest.mark.parametrize("bad", ["data", "data=x", "rows=8"])
def test_torch_cli_mesh_rejects_bad_values(bad):
    from cvsteer_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["--input", str(FISH), "--mesh", bad, "--device", "cpu"])


def test_torch_cli_mesh_rejects_a_mesh_off_the_world(run):
    assert all(r["bad_world"] == 2 and r["backend"] == "gloo" for r in run[1])


def test_torch_cli_mesh_one_rank_without_torchrun(tmp_path, monkeypatch):
    """--mesh space=1 makes (and then ends) a 1-rank world of its own."""
    import torch.distributed as dist

    from cvsteer_tpu_torch import cli

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert cli.main(["--input", str(FISH), "--output", str(tmp_path / "a"), "--mesh", "space=1",
                     "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    assert cli.main(["--input", str(FISH), "--output", str(tmp_path / "b"), "--device", "cpu"]) == 0
    for m in MAPS:
        a, b = _read(tmp_path / "a" / f"fish_{m}.png"), _read(tmp_path / "b" / f"fish_{m}.png")
        assert np.abs(a - b).max() <= 2 and (np.abs(a - b) <= 1).mean() >= 0.999

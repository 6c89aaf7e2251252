"""The port's cvsteer-run CLI (cvsteer_tpu_torch.cli) on CPU.

- The golden test's bars (tests/test_golden.py) on the port's CLI output
  for the embedded fish image: mean L1 <= 1.0 after JPEG recode, <= 2.5
  without.
- The same 8-bit maps as the reference's cli.main, to within 1 gray level.
- List files with an unreadable entry, --gain vs normalize, --filters g4,
  --mesh refused, and no silent CPU run without --device cpu.
- The numpy + zlib PNG writer, and the committed lossless PNG copies of the
  fish image and the goldens (the GPU machine has no JPEG decoder).
"""

import pathlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu import cli as jcli
from cvsteer_tpu.filters.g2 import g2_bank as j_g2_bank
from cvsteer_tpu.filters.g2 import g2_output_maps as j_g2_output_maps
from cvsteer_tpu.utils.imageproc import normalize_minmax_u8 as j_normalize
from cvsteer_tpu_torch import cli, cli_vo
from cvsteer_tpu_torch.io.imageio import imread_gray_f32, imwrite_u8

from oracle import recode_jpeg

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSETS = ROOT / "tests" / "assets"
GOLDEN = ROOT / "cvsteer_tpu_torch" / "io" / "golden"
FISH_PNG = GOLDEN / "fish.png"
MAPS = ("edges", "lines_dark", "lines_bright")


def _run(tmp_path, *extra, name="out", src=FISH_PNG):
    out = tmp_path / name
    assert cli.main(["--input", str(src), "--output", str(out), "--device", "cpu", *extra]) == 0
    return out


def _report(record_property, what, figures, fmt):
    """Print a measured figure (shown under pytest -s) and record it (kept
    by --junitxml): PERF.md quotes these numbers."""
    text = " / ".join(fmt.format(x) for x in figures)
    print(f"\nparity {what}: {text}")
    record_property(what, text)


def _read(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def test_torch_golden_assets_equal_the_jpegs():
    for name in ("fish", "golden_edges", "golden_lines_dark", "golden_lines_bright"):
        want = cv2.imread(str(ASSETS / f"{name}.jpg"), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(_read(GOLDEN / f"{name}.png"), want)
        np.testing.assert_array_equal(imread_gray_f32(str(GOLDEN / f"{name}.png")), want.astype(np.float32))


def test_torch_cli_fish_meets_golden_bars(tmp_path, goldens, record_property):
    out = _run(tmp_path)
    l1 = {"recoded": [], "direct": []}
    for name in MAPS:
        u8 = _read(out / f"fish_{name}.png")
        assert u8.shape == (185, 256) and u8.dtype == np.uint8 and u8.max() == 255
        gold = goldens[name].astype(np.float64)
        l1["recoded"].append(np.abs(recode_jpeg(u8).astype(np.float64) - gold).mean())
        l1["direct"].append(np.abs(u8.astype(np.float64) - gold).mean())
    for how, figures in l1.items():
        _report(record_property, f"golden mean L1, {how}", figures, "{:.4f}")
    for name, recoded, direct in zip(MAPS, l1["recoded"], l1["direct"]):
        assert recoded <= 1.0, f"{name}: mean L1 {recoded:.3f} after recode"
        assert direct <= 2.5, f"{name}: mean L1 {direct:.3f} without recode"


@pytest.mark.parametrize("filters", ["g2", "g4"])
def test_torch_cli_matches_reference_cli(tmp_path, filters, record_property):
    """Port CLI vs the reference's cli.main on the same image.

    Both write bf16-class maps on their accelerator branch; on the CPU the
    reference's branch is its fp32 pipeline, and its own fast (bf16) class
    differs from that by 2 levels at a few pixels (a 2^-9 rounding of each
    pixel and of the normalizing max). So for G2 the port is held to within
    1 level of the reference's fast class everywhere (its CLI's accelerator
    branch: g2_output_maps(accuracy="fast", out_dtype=bfloat16), then
    normalize_minmax_u8), and to within 1 level of cli.main wherever the
    reference's two classes agree to within 1."""
    port = _run(tmp_path, "--filters", filters, name="port")
    ref = tmp_path / "ref"
    assert jcli.main(["--input", str(ASSETS / "fish.jpg"), "--output", str(ref), "--filters", filters]) == 0
    fast = None
    if filters == "g2":
        fish = cv2.imread(str(ASSETS / "fish.jpg"), cv2.IMREAD_GRAYSCALE).astype(np.float32)
        maps = j_g2_output_maps(jnp.asarray(fish), j_g2_bank(), accuracy="fast", out_dtype=jnp.bfloat16)
        fast = [np.asarray(j_normalize(m)).astype(int) for m in maps]
    got = [_read(port / f"fish_{name}.png").astype(int) for name in MAPS]
    if fast is not None:
        _report(record_property, "8-bit G2 maps vs the reference's fast class, max diff",
                [np.abs(g - f).max() for g, f in zip(got, fast)], "{}")
        _report(record_property, "8-bit G2 maps vs the reference's fast class, equal",
                [(g == f).mean() for g, f in zip(got, fast)], "{:.5f}")
    for k, name in enumerate(MAPS):
        want = _read(ref / f"fish_{name}.png").astype(int)
        agree = np.ones(want.shape, bool)
        if fast is not None:
            assert np.abs(got[k] - fast[k]).max() <= 1, name
            assert (got[k] == fast[k]).mean() >= 0.999, name
            agree = np.abs(fast[k] - want) <= 1
            assert agree.mean() >= 0.999
        assert np.abs(got[k] - want)[agree].max() <= 1, name
        assert (got[k] == want).mean() >= 0.95, name


def test_torch_cli_list_file_skips_unreadable(tmp_path, capsys):
    rng = np.random.default_rng(0)
    names = []
    for i in range(3):  # two shapes: two batches, the first one full
        p = tmp_path / f"im{i}.png"
        imwrite_u8(str(p), rng.integers(0, 256, (24, 40) if i < 2 else (17, 23), dtype=np.uint8))
        names.append(str(p))
    lst = tmp_path / "inputs.txt"
    lst.write_text("\n".join([names[0], str(tmp_path / "missing.png"), *names[1:]]) + "\n")
    out = _run(tmp_path, "--batch", "2", "--verbose", src=lst)
    assert "missing.png" in capsys.readouterr().err  # skipped with a note, not a crash
    for i, shape in enumerate([(24, 40), (24, 40), (17, 23)]):
        for name in MAPS:
            assert _read(out / f"im{i}_{name}.png").shape == shape
    # a batch holds the same images as the one-image runs
    single = _run(tmp_path, src=pathlib.Path(names[1]), name="single")
    np.testing.assert_array_equal(_read(out / "im1_edges.png"), _read(single / "im1_edges.png"))


def test_torch_cli_gain_vs_normalize(tmp_path):
    norm = _read(_run(tmp_path, name="a") / "fish_edges.png")
    gain = _read(_run(tmp_path, "--gain", "0.05", name="b") / "fish_edges.png")
    assert norm.max() == 255  # normalized fills the range
    assert gain.max() < 255  # a small fixed gain does not saturate
    assert not np.array_equal(norm, gain)


def test_torch_cli_g4_filter_path(tmp_path):
    out = _run(tmp_path, "--filters", "g4")
    for name in MAPS:
        img = _read(out / f"fish_{name}.png")
        assert img.shape == (185, 256) and img.max() > 100


def test_torch_cli_refuses_unported_mesh(tmp_path, capsys):
    """--mesh is ported (parallel/); without torchrun the world is one rank,
    so a mesh of 2 is refused with the reference's message, as a mesh that
    does not cover the devices (tests/test_torch_cli_mesh.py runs it)."""
    with pytest.raises(SystemExit):
        cli.main(["--input", str(FISH_PNG), "--device", "cpu", "--mesh", "data=2"])
    assert "invalid --mesh 'data=2': mesh {'data': 2} != 1 devices" in capsys.readouterr().err


def test_torch_clis_refuse_to_run_without_a_gpu(tmp_path, monkeypatch, capsys):
    """Without CUDA neither CLI falls back to the CPU silently: they exit
    non-zero unless --device cpu is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--input", str(FISH_PNG), "--output", str(tmp_path / "o")]) != 0
    fixture = str(ASSETS / "tum_fixture")
    assert cli_vo.main(["--input", fixture, "--max-frames", "2"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
    assert cli.main(["--input", str(FISH_PNG), "--output", str(tmp_path / "o"), "--device", "cpu"]) == 0


def test_torch_png_writer_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    for shape in [(1, 1), (7, 3), (185, 256)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f"w{shape[0]}.png")
        imwrite_u8(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(imread_gray_f32(path), img.astype(np.float32))
    with pytest.raises(ValueError):
        imwrite_u8(str(tmp_path / "x.jpg"), img)

"""The port's zlib-only PNG codec (io/native/codec.c through
io/native_codec.py) against its plain numpy + zlib version
(io/imageio.py::_decode_png, _encode_png), on CPU; the codec is built from
the repository's source at first use.

- decode: PNGs written here with each of the five scanline filters, and
  with all five mixed row by row over several IDAT chunks, in gray, gray +
  alpha, RGB and RGBA: equal to the numpy decoder (bit for bit: integral
  gray, BT.601 luma rounded half to even), gray also to OpenCV;
- write and read back; garbage, truncated data and JPEG give None;
- the committed goldens and the TUM fixture decode as before;
- a thread pool decodes in parallel (the calls release the GIL), and a
  source that does not compile raises with the compiler's message.
"""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from cvsteer_tpu_torch.io import imageio, native_codec

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _filter_row(kind, cur, prev, bpp):
    """PNG's forward filter of one scanline (uint8 arrays) as int32."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (a + prev) >> 1
    else:
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    return (cur - pred) & 255


def _png(px, ctype, filters, n_idat=1):
    """PNG bytes of ``px [H, W, C]`` uint8, row y filtered with
    filters[y % len(filters)], the deflate stream cut into n_idat chunks."""
    h, w, bpp = px.shape
    rows, prev = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        cur = px[y].reshape(-1)
        kind = filters[y % len(filters)]
        rows.append(np.concatenate([[kind], _filter_row(kind, cur, prev, bpp)]).astype(np.uint8))
        prev = cur
    z = zlib.compress(np.concatenate(rows).tobytes(), 6)
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)
    out = imageio._PNG_SIG + imageio._png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += imageio._png_chunk(b"IDAT", z[a:b])
    return out + imageio._png_chunk(b"IEND", b"")


def _pixels(seed, h, w, bpp):
    rng = np.random.default_rng(seed)
    smooth = cv2.GaussianBlur(rng.random((h, w, bpp)).astype(np.float32), (0, 0), 2.0)
    noisy = smooth.reshape(h, w, bpp) * 200 + rng.integers(0, 56, (h, w, bpp))
    return np.clip(noisy, 0, 255).astype(np.uint8).reshape(h, w, bpp)


def _same(data):
    got, want = native_codec.imdecode_gray(data), imageio._decode_png(data)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_torch_codec_decodes_each_filter_as_numpy(kind, tmp_path):
    px = _pixels(kind, 23, 37, 1)
    data = _png(px, 0, [kind])
    got = _same(data)
    np.testing.assert_array_equal(got, px[..., 0].astype(np.float32))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6], ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_torch_codec_decodes_colour_types_as_numpy(ctype):
    px = _pixels(10 + ctype, 31, 45, CHANNELS[ctype])
    _same(_png(px, ctype, [0, 1, 2, 3, 4, 4, 3, 1], n_idat=3))


def test_torch_codec_write_and_read_back(tmp_path):
    img = _pixels(20, 40, 57, 1)[..., 0]
    path = str(tmp_path / "w.png")
    imageio.imwrite_u8(path, img)
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(imageio._decode_png(data), img.astype(np.float32))
    np.testing.assert_array_equal(imageio.imread_gray_f32(path), img.astype(np.float32))
    np.testing.assert_array_equal(native_codec.imread_gray(path), img.astype(np.float32))
    np.testing.assert_array_equal(_same(imageio._encode_png(img)), img.astype(np.float32))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)


def test_torch_codec_refuses_garbage(tmp_path):
    good = _png(_pixels(30, 16, 16, 3), 2, [4])
    ok, jpg = cv2.imencode(".jpg", _pixels(31, 16, 16, 1)[..., 0])
    bad_zlib = good[:45] + bytes(20) + good[65:]
    bad_filter = _png(_pixels(32, 8, 8, 1), 0, [0])
    raw = bytearray(zlib.decompress(bad_filter[8 + 25 + 8:-12 - 4]))
    raw[0] = 7  # no such filter
    bad_filter = (imageio._PNG_SIG + bad_filter[8:8 + 25]
                  + imageio._png_chunk(b"IDAT", zlib.compress(bytes(raw)))
                  + imageio._png_chunk(b"IEND", b""))
    for data in (b"", b"\x89PNG", np.random.default_rng(0).bytes(500), good[:60], bad_zlib,
                 bad_filter, jpg.tobytes()):
        assert native_codec.imdecode_gray(data) is None
    assert native_codec.imread_gray(str(tmp_path / "missing.png")) is None


def test_torch_codec_decodes_committed_images_as_before():
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(root, "cvsteer_tpu_torch", "io", "golden", "*.png")))
    paths += sorted(glob.glob(os.path.join(root, "tests", "assets", "tum_fixture", "rgb", "*.png")))[:8]
    assert len(paths) == 12
    for p in paths:
        with open(p, "rb") as f:
            got = _same(f.read())
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32))


def test_torch_codec_threads_and_build_failure(tmp_path, monkeypatch):
    datas = [_png(_pixels(40 + i, 64, 96, 3), 2, [i % 5]) for i in range(16)]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(native_codec.imdecode_gray, datas))
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(g, imageio._decode_png(d))
    bad = tmp_path / "codec.c"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native_codec, "_SRC", str(bad))
    monkeypatch.setattr(native_codec, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building the PNG codec failed"):
        native_codec.build()

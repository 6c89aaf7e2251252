"""Image IO: grayscale read (the counterpart of cvsteer_tpu.io.imageio).

8-bit PNG (grayscale, gray+alpha, RGB, RGBA; not interlaced) and binary
PGM decode with numpy and zlib alone, so sequences read on machines that
have neither OpenCV nor PIL. Other formats go to OpenCV or PIL when one is
installed. All reads return float32 grayscale in [0, 255].
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None/Sub/Up/Average/Paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        else:  # Sub / Average / Paeth depend on the left neighbour: scalar loop
            ln, up, cur_l = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (ln[x] + p) & 255
            cur = np.asarray(cur_l, np.int32)
        out[y] = cur
        prev = cur
    return out


def _decode_png(data: bytes) -> Optional[np.ndarray]:
    pos, chunks, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            chunks.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        return None
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        return None
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(chunks)), h, w, bpp).reshape(h, w, bpp)
    px = px.astype(np.float32)
    if bpp >= 3:  # ITU-R BT.601 luma, as cv2.IMREAD_GRAYSCALE
        return np.round(0.299 * px[..., 0] + 0.587 * px[..., 1] + 0.114 * px[..., 2])
    return px[..., 0]


def _decode_pgm(data: bytes) -> Optional[np.ndarray]:
    parts, pos = [], 2
    while len(parts) < 3:
        while data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        parts.append(int(data[pos:end]))
        pos = end
    w, h, maxval = parts
    if maxval > 255:
        return None
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w).astype(np.float32)


def imread_gray_f32(path: str) -> Optional[np.ndarray]:
    """Read an image as float32 grayscale (0..255); None if unreadable."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    img = None
    try:
        if data.startswith(_PNG_SIG):
            img = _decode_png(data)
        elif data.startswith(b"P5"):
            img = _decode_pgm(data)
    except (ValueError, IndexError, zlib.error, struct.error):
        img = None
    if img is not None:
        return img
    try:
        import cv2

        out = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if out is not None:
            return out.astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.float32)
    except (ImportError, OSError, ValueError):
        return None

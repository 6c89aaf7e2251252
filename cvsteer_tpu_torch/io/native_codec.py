"""ctypes bindings of the zlib-only PNG codec (io/native/codec.c).

The port's counterpart of cvsteer_tpu.io.native_codec. The library is built
at first use from the source in the repository, with the system C compiler
and zlib, into ``cvsteer_tpu_torch/kernels/_build/`` (gitignored), named by
a hash of the source and flags. ctypes releases the GIL for each call, so
the CLI's decode pool and cli_vo's serving decode run in parallel.

PNG only (8-bit gray, gray + alpha, RGB, RGBA; not interlaced): JPEG is
not supported, and ``imdecode_gray`` returns None for it as for any other
data the codec cannot decode. A build that fails raises with the
compiler's message (``available()`` is then False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "codec.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "kernels", "_build")
#: C compiler flags; -ffp-contract=off keeps the luma sum's multiplies and
#: adds separately rounded, as numpy computes them
CFLAGS = ("-O2", "-std=c99", "-fPIC", "-shared", "-ffp-contract=off", "-fvisibility=hidden")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libcvsteer_codec_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the codec if the library for this source is missing (into a
    temporary name, then renamed into place); raises with the compiler's
    message when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("the PNG codec needs a C compiler (cc or gcc) and zlib")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *CFLAGS, "-o", tmp, _SRC, "-lz"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the PNG codec failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
            lib.cvs_png_info.argtypes = (u8p, ctypes.c_size_t, ip, ip)
            lib.cvs_png_decode_gray.argtypes = (u8p, ctypes.c_size_t,
                                                ctypes.POINTER(ctypes.c_float),
                                                ctypes.c_int, ctypes.c_int)
            lib.cvs_png_write_gray.argtypes = (ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int)
            for fn in (lib.cvs_png_info, lib.cvs_png_decode_gray, lib.cvs_png_write_gray):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the codec builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def imdecode_gray(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> float32 gray ``[H, W]`` (0..255); None when the data is
    not a PNG the codec decodes (JPEG included) or is corrupt."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.cvs_png_info(src, buf.size, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    dst = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if lib.cvs_png_decode_gray(src, buf.size, dst, w.value, h.value) != 0:
        return None
    return out


def imread_gray(path: str) -> Optional[np.ndarray]:
    """A PNG file as float32 gray; None when unreadable. The bytes are read
    once and decoded from memory, so the size probe and the decode see the
    same data."""
    _load()
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode_gray(data)


def imwrite_png_gray(path: str, img: np.ndarray) -> bool:
    """Write an 8-bit gray ``[H, W]`` image as PNG; whether it was written."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"imwrite_png_gray: expected [H, W], got {img.shape}")
    h, w = img.shape
    src = img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.cvs_png_write_gray(os.fsencode(path), src, w, h) == 0

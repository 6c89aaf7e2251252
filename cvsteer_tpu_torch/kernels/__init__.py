"""Hand-written Hopper kernels: build, load and launch accounting.

The CUDA C++ sources under ``csrc/`` are compiled on first use with ``nvcc``
for ``sm_90a`` into ONE shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``_build/`` (listed in .gitignore), named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached library. Nothing here runs at import time:
the CPU-only test suite imports every module of the package.

Every kernel wrapper (ops.cuda_frontend, ops.cuda_desc) adds one to its
launch count right where it launches its kernel; :func:`launch_counts` and
:func:`reset_launch_counts` let a run show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: nvcc flags. ``--fmad=false`` keeps every multiply and add separately
#: rounded, as PyTorch's elementwise ops are, so a kernel and its plain
#: version agree to the bit where they sum in the same order.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

KERNELS = ("filter_bank", "pyr_down", "g2_features_full", "desc_sample")

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_lib = None
_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _sources():
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcvsteer_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing.

    Compiles into a temporary file and renames it into place, so a
    concurrent build never loads a half-written library."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    if verbose:
        cmd.insert(1, "--ptxas-options=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # in, out, n, h, w, k, t, xtaps(host), ytaps(host), stream
    "cvs_filter_bank": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # in, out, n, h, w, stream
    "cvs_pyr_down": (_P, _P, _I, _I, _I, _P),
    # basis, score, ct, st, n, h, w, stream
    "cvs_g2_maps": (_P, _P, _P, _P, _I, _I, _I, _P),
    # score, p3, dy, dx, n, h, w, threshold, nms_radius, stream
    "cvs_g2_select": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # basis, ys, xs, out, b, c, h, w, k, s, stream
    "cvs_desc_sample": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cvs_error_string.argtypes = (ctypes.c_int,)
            lib.cvs_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().cvs_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

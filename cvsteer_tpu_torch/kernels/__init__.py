"""Hand-written Hopper kernels: build, load and launch accounting.

The CUDA C++ sources under ``csrc/`` are compiled on first use with ``nvcc``
for ``sm_90a`` (one ``nvcc -c`` per source, all started together) and linked
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``_build/`` (listed in .gitignore), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library. Nothing here runs at import time: the CPU-only
test suite imports every module of the package.

Every kernel wrapper (ops.cuda_frontend, ops.cuda_desc, ops.cuda_probes)
adds one to its launch count right where it launches its kernel;
:func:`launch_counts` and :func:`reset_launch_counts` let a run show which
kernels its main path went through.
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

#: nvcc compile flags. ``--fmad=false`` keeps every multiply and add
#: separately rounded, as PyTorch's elementwise ops are, so a kernel and its
#: plain version agree to the bit where they sum in the same order.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

KERNELS = (
    "filter_bank", "pyr_down", "g2_features_full", "desc_sample",
    "g2_maps", "g4_maps", "filter_bank_adj", "g2_feature_maps",
    # the measurement probes' kernels (ops.cuda_probes)
    "probe_gather_rows", "probe_gather_patches", "probe_maps_stages",
    "probe_maps_variants", "probe_maps_mma",
)

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


def _run_all(cmds, verbose: bool) -> None:
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}"
        elif verbose and err:
            print(err)
    if failed:
        raise RuntimeError(failed)


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing.

    Compiles every source to an object in parallel, links them into a
    temporary file and renames it into place, so a concurrent build never
    loads a half-written library."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    extra = ["--ptxas-options=-v"] if verbose else []
    units = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in units]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", o, s]
                  for s, o in zip(units, objs)], verbose)
        _run_all([[nvcc, "-shared", "-o", f"{out}.{tag}", *objs]], verbose)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(f"{out}.{tag}", out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # in, out, n, h, w, k, t, xtaps(host), ytaps(host), stream
    "cvs_filter_bank": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # in, out (levels 1.. one after another), tickets, n, h, w, levels, stream
    "cvs_pyr_down_levels": (_P, _P, _P, _I, _I, _I, _I, _P),
    # ptrs [L, 7] int64 (host), hw [L, 2] int32 (host), n_levels, n, t,
    # xtaps(host), ytaps(host), threshold, nms_radius, stream
    "cvs_g2_features": (_P, _P, _I, _I, _I, _P, _P, _F, _I, _P),
    # bases [L] int64 (host), hw [L, 2] int32 (host), counts [L] int32
    # (host), n_levels, ys, xs, out, b, c, k, s, stream
    "cvs_desc_sample": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # in, edges, dark, bright, n, h, w, t, xtaps(host), ytaps(host), bf16, stream
    "cvs_maps_g2": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P),
    # ... as cvs_maps_g2, with the G4 product list before bf16: (i, j, slot)
    # [n_terms, 3] int32 (host), weights [n_terms] float32 (host), n_terms
    "cvs_maps_g4": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P),
    # in, score, ct, st, n, h, w, t, xtaps(host), ytaps(host), stream
    "cvs_features_g2": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # grad, out, n, h, w, k, t, xtaps(host), ytaps(host), stream
    "cvs_filter_bank_adj": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # tbl, idx, out, n_tbl, m, row_bytes, stream
    "cvs_gather_rows": (_P, _P, _P, _I, _I, _I, _P),
    # img, ys, xs, out, k, h, w, ph, pw, elem_bytes, stream
    "cvs_gather_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # in, m0, m1, m2, n, h, w, t, xtaps(host), ytaps(host), stage, outputs, stream
    "cvs_probe_stages": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P),
    # ... as cvs_probe_stages up to ytaps, then tail, carry, tile_h, stream
    "cvs_probe_variants": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    # ... as cvs_probe_stages up to ytaps, then stage, row_mma, x3, stream
    "cvs_probe_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P),
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

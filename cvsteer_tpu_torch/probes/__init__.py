"""The measurement probes, on the card: the port of the TPU probe scripts.

Each module is the counterpart of one script of the reference's
``scripts/`` and keeps its names, so a reader finds each counterpart;
``scripts/`` itself stays the reference's (JAX, TPU):

- :mod:`.probe_dma_gather` — the descriptor gathers' rate: rows of 32 B and
  512 B and 16 x 256 bf16 patches (kernel G), beside ``torch.index_select``
  and one advanced-indexing call;
- :mod:`.profile_v2_stages` and :mod:`.profile_frontend` — kernel E cut at
  each stage, with the two scripts' outputs (kernel S), and E's own time;
- :mod:`.probe_r3_variants` — CUDA-core variants of E's algebra and the
  carried row passes at four tile heights (kernel V), each with its error
  against the fp32 maps;
- :mod:`.profile_variants` — the matrix-unit variants (kernel M) and the
  baseline and factored algebra (kernel V).

Run one on the card with ``python -m cvsteer_tpu_torch.probes.<name>``: the
first line is the card's name and power limit, then the script's table of
device times (utils.profiling.device_ms). Without a GPU a probe exits
non-zero unless ``--device cpu`` is given; it then times the kernels'
plain versions on the host clock and says so. ``measure()`` in each module
returns the table's rows (chip_smoke.py runs each once); inside
:func:`untimed` it walks its probe's path once and times nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np

#: H100 SXM data sheet: HBM3 bandwidth at the 700 W limit
HBM_BYTES_PER_S = 3.35e12


def card_line(device: str) -> str:
    """The card's name and power limit (``nvidia-smi``), or the CPU note."""
    if device != "cuda":
        return "cpu: the kernels' plain versions, host clock (no device time)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    import torch

    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def parser(description: str, shapes: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which times the plain versions on the host")
    if shapes:
        ap.add_argument("--batch", type=int, default=16)
        ap.add_argument("--size", type=int, default=512)
    return ap


def device_or_exit(args) -> Optional[str]:
    """The device to run on, or None after a message when there is none."""
    import torch

    if args.device not in ("cuda", "cpu"):
        print(f"FAIL: --device {args.device}: cuda or cpu", file=sys.stderr)
        return None
    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA GPU; the probes measure the card (--device cpu times the plain "
              "versions)", file=sys.stderr)
        return None
    return args.device


_untimed = False


@contextlib.contextmanager
def untimed():
    """Inside, :func:`time_ms` calls its function once and returns NaN: a
    probe's ``measure()`` then makes each call of its path once, so the
    launches it counts do not depend on how often the timer repeats a
    window."""
    global _untimed
    _untimed = True
    try:
        yield
    finally:
        _untimed = False


def time_ms(fn: Callable[[], object], device: str, names: Sequence[str] = (),
            per_call: int = 1, reps: int = 25) -> float:
    """ms of one call: on the card the device time of the CUDA functions
    ``names`` (or of every device event), utils.profiling.device_ms; on the
    CPU the host clock's median of 3 calls."""
    if _untimed:
        fn()
        return float("nan")
    if device == "cuda":
        from cvsteer_tpu_torch.utils.profiling import device_ms

        return device_ms(fn, names, per_call, reps=reps)[0]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[1]


def g2_taps():
    """The G2/H2 bank at width 4 (7 x 9 taps), the scripts' bank."""
    from cvsteer_tpu_torch.filters.g2 import g2_bank

    bank = g2_bank()
    return bank.xtaps, bank.ytaps


def uniform_batch(batch: int, size: int, device: str, integers: bool = False):
    """The scripts' input: numpy default_rng(0), uniform on [0, 255) (or
    the integers 0..255), [batch, size, size] float32 on ``device``."""
    import torch

    rng = np.random.default_rng(0)
    shape = (batch, size, size)
    img = rng.integers(0, 256, shape) if integers else rng.uniform(0, 255, shape)
    return torch.from_numpy(img.astype(np.float32)).to(device)


def maps_bound_ms(pixels: int) -> float:
    """The bytes bound of a maps probe: the image in and three fp32 maps out,
    16 bytes a pixel, at the HBM bandwidth."""
    return 16.0 * pixels / HBM_BYTES_PER_S * 1e3


def max_rel_to_mean(got, want) -> float:
    """max over the maps of max |got - want| / mean |want|
    (probe_r3_variants.py's measure)."""
    return max(float((g - w).abs().max() / w.abs().mean()) for g, w in zip(got, want))


def max_rel_to_scale(got, want) -> float:
    """max over the maps of max |got - want|, over the largest |want| of all
    maps (profile_variants.py's measure)."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale

"""The descriptor gathers' rate on the card: kernel G against PyTorch's gathers.

The port of scripts/probe_dma_gather.py, at its shapes and from its inputs
(numpy default_rng(0)):

  row32     65,536 rows of 32 B (16 bf16) from a 307,200-row table;
  row512    8,192 rows of 512 B from a 38,400-row table;
  patch     2,048 patches of 16 x 256 bf16 (8 KB) from a 480 x 5120 image
            (640 px x 8 channels, channels-last), start columns multiples of 8.

For each it prints device us, ns per row and GB/s (payload bytes over the
time, as the script did) for kernel G (ops.cuda_probes.gather_rows,
gather_patches), and for the library yardstick: ``torch.index_select``
(rows) and one advanced-indexing call (patches), timed here and used by no
kernel path. The tables (9.8 MB, 19.7 MB, 4.9 MB) fit in the 50 MB L2, so
back-to-back calls read them from there; the kernel's rows are also timed
with the L2 flushed before each call (a 256 MB write).

    python -m cvsteer_tpu_torch.probes.probe_dma_gather [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from cvsteer_tpu_torch import probes

R_ROWS, LANES, M = 307200, 16, 65536  # level-0 pair table rows; 16 bf16 lanes = 32 B
PATCH_H, PATCH_W, N_PATCHES = 16, 256, 2048
IMG_H, IMG_W = 480, 8 * 640


def inputs(device: str) -> dict:
    """The script's arrays, drawn in its order from default_rng(0)."""
    import torch

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    as_bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(bf).to(device)  # noqa: E731
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa: E731
    tbl = as_bf16(rng.standard_normal((R_ROWS, LANES)))
    idx = as_i32(rng.integers(0, R_ROWS, M))
    tbl512 = as_bf16(rng.standard_normal((R_ROWS // 8, 256)))
    idx512 = as_i32(rng.integers(0, R_ROWS // 8, M // 8))
    img = as_bf16(rng.standard_normal((IMG_H, IMG_W)))
    ys = as_i32(rng.integers(0, IMG_H - PATCH_H, N_PATCHES))
    xs = as_i32(rng.integers(0, 600, N_PATCHES) * 8)
    return dict(tbl=tbl, idx=idx, tbl512=tbl512, idx512=idx512, img=img, ys=ys, xs=xs)


def patches_by_indexing(img, ys, xs, ph: int = PATCH_H, pw: int = PATCH_W):
    """The library yardstick for the patches: one advanced-indexing call."""
    import torch

    dy = torch.arange(ph, device=img.device)
    dx = torch.arange(pw, device=img.device)
    return img[ys.long()[:, None, None] + dy[None, :, None], xs.long()[:, None, None] + dx[None, None, :]]


def measure(device: str = "cuda", reps: int = 25) -> list:
    """Rows of the table: dicts with case, route, us, rows, bytes_per_row."""
    import torch

    from cvsteer_tpu_torch.ops import cuda_probes as cp

    a = inputs(device)
    cases = [
        ("row32", "index_select", lambda: torch.index_select(a["tbl"], 0, a["idx"]), (), M, 32),
        ("row32", "kernel G", lambda: cp.gather_rows(a["tbl"], a["idx"]), ("gather_rows_kernel",), M, 32),
        ("row512", "index_select", lambda: torch.index_select(a["tbl512"], 0, a["idx512"]), (),
         M // 8, 512),
        ("row512", "kernel G", lambda: cp.gather_rows(a["tbl512"], a["idx512"]),
         ("gather_rows_kernel",), M // 8, 512),
        ("patch16x256", "indexing", lambda: patches_by_indexing(a["img"], a["ys"], a["xs"]), (),
         N_PATCHES, PATCH_H * PATCH_W * 2),
        ("patch16x256", "kernel G", lambda: cp.gather_patches(a["img"], a["ys"], a["xs"]),
         ("gather_patches_kernel",), N_PATCHES, PATCH_H * PATCH_W * 2),
    ]
    if device == "cuda":
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=device)  # 256 MB, past the L2
        cold = lambda fn: (lambda: (flush.zero_(), fn()))  # noqa: E731
        cases += [
            ("row32", "kernel G, L2 flushed", cold(cases[1][2]), ("gather_rows_kernel",), M, 32),
            ("row512", "kernel G, L2 flushed", cold(cases[3][2]), ("gather_rows_kernel",), M // 8, 512),
        ]
    rows = []
    for case, route, fn, names, n_rows, nbytes in cases:
        ms = probes.time_ms(fn, device, names, 1, reps)
        rows.append(dict(case=case, route=route, us=1e3 * ms, rows=n_rows, bytes_per_row=nbytes))
    return rows


def main(argv=None) -> int:
    ap = probes.parser(__doc__.split("\n")[0], shapes=False)
    args = ap.parse_args(argv)
    device = probes.device_or_exit(args)
    if device is None:
        return 1
    print(probes.card_line(device))
    rows = measure(device)
    unit = "device us" if device == "cuda" else "host us (plain versions)"
    print(f"| case | route | {unit} | ns/row | GB/s |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['case']} | {r['route']} | {r['us']:.2f} | {r['us'] / r['rows'] * 1e3:.3f} | "
              f"{r['rows'] * r['bytes_per_row'] / r['us'] / 1e3:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""cvsteer-run on PyTorch: batch steerable-filter edge/line analysis of images.

The port of cvsteer_tpu.cli (the reference library's example/steer.cpp):

  --input    one image, or a .txt / extensionless newline-delimited list of
             image paths; unreadable entries are skipped with a note on stderr
  --output   output directory: <base>_edges.png, <base>_lines_dark.png,
             <base>_lines_bright.png per image
  --gain     fixed 8-bit gain; <= 0 means per-image min-max normalization
  --filters  g2 (default) or g4
  --width / --spacing  bank half-width and tap spacing (default 4 / 0.67
             for g2, 6 / 0.5 for g4)
  --batch    images per device batch (default 16)
  --device   cuda (default) or cpu; without a GPU the CLI refuses to run
             unless --device cpu is given
  --mesh     e.g. 'data=4,space=2' (-1 infers one axis): shards each batch
             over 'data' and its image rows over 'space' across the ranks
             of a torch.distributed world (parallel.make_mesh)

  python -m cvsteer_tpu_torch.cli --input list.txt --output out/ --filters g4
  torchrun --nproc-per-node 4 -m cvsteer_tpu_torch.cli --input list.txt \
      --output out/ --mesh data=2,space=2

Same-shaped images batch into one call of the fused maps kernel (G2:
filters.g2.g2_output_maps(accuracy="fast"), G4: ops.cuda_frontend.g4_maps),
with bfloat16 maps quantized to 8 bits on the device. A thread pool decodes
ahead, at most 3 batches are in flight, a batch's result is fetched only
when it is drained, and PNG writes run on the pool: decode, device compute
and writes overlap. On the CPU the wrappers run their plain versions, so
the same code runs on either device.

Under ``--mesh`` every rank decodes the same files; a batch that shards
runs parallel.sharded_g2_maps / sharded_g4_maps (fp32 maps, as the
reference's) on each rank's block, the blocks are gathered to rank 0, and
rank 0 alone quantizes, writes the PNGs and prints. A batch that cannot
shard runs the unsharded path on rank 0, its reason on stderr.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import numpy as np

MAX_INFLIGHT = 3  # bounds device memory on long file lists


def _expand_inputs(inp: str) -> List[str]:
    """Single file, or newline-delimited list if .txt / no extension."""
    p = Path(inp)
    if inp.endswith(".txt") or "." not in p.name:
        with open(inp) as f:
            return [line.strip() for line in f if line.strip()]
    return [inp]


def _basename(path: str) -> str:
    name = Path(path).name
    return name.rsplit(".", 1)[0] if "." in name else name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cvsteer-run-torch",
        description="Steerable-filter edge/line analysis (G2/H2 or G4/H4 quadrature pair).",
    )
    ap.add_argument("--input", required=True, help="input image or newline-delimited list file")
    ap.add_argument("--output", default="", help="output directory")
    ap.add_argument("--gain", type=float, default=0.0, help="gain for 8-bit output; <=0 = minmax normalize")
    ap.add_argument("--filters", choices=["g2", "g4"], default="g2")
    ap.add_argument("--width", type=int, default=None, help="kernel half-width (default: 4 for g2, 6 for g4)")
    ap.add_argument("--spacing", type=float, default=None, help="tap spacing (default: 0.67 g2, 0.5 g4)")
    ap.add_argument(
        "--mesh",
        default="",
        help="multi-device mesh, e.g. 'data=4,space=2' (-1 infers one axis); "
        "shards the batch over 'data' and image rows over 'space'. A run of N ranks is "
        "launched as: torchrun --nproc-per-node N -m cvsteer_tpu_torch.cli --mesh "
        "data=..,space=.. (without torchrun the world is this one process)",
    )
    ap.add_argument("--batch", type=int, default=16, help="images per device batch")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device (default: cuda; cpu runs the kernels' plain versions and must be asked for)",
    )
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    axes = {}
    if args.mesh:
        try:
            for part in args.mesh.split(","):
                name, _, size = part.partition("=")
                name = name.strip()
                if name not in ("data", "space"):
                    raise ValueError(f"unknown mesh axis {name!r} (expected data/space)")
                axes[name] = int(size)
        except ValueError as e:
            ap.error(f"invalid --mesh {args.mesh!r}: {e}")

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    mesh, own_world = None, False
    if axes:
        import torch.distributed as dist

        from cvsteer_tpu_torch.parallel import gather_blocks, make_mesh, shard_batch
        from cvsteer_tpu_torch.parallel.mesh import mesh_axis, rank_device

        own_world = not dist.is_initialized()
        try:
            mesh = make_mesh(axes, device.type)
        except ValueError as e:
            ap.error(f"invalid --mesh {args.mesh!r}: {e}")
        device = rank_device(mesh)
    root = mesh is None or dist.get_rank() == 0

    from cvsteer_tpu_torch.io.imageio import imread_gray_f32, imwrite_u8
    from cvsteer_tpu_torch.utils.imageproc import convert_scale_u8, normalize_minmax_u8

    if args.filters == "g2":
        from cvsteer_tpu_torch.filters.g2 import g2_bank, g2_output_maps
        from cvsteer_tpu_torch.parallel.frontend_sharded import sharded_g2_maps as sharded

        bank = g2_bank(args.width or 4, args.spacing or 0.67)

        def maps(batch):
            return g2_output_maps(batch, bank, accuracy="fast", out_dtype=torch.bfloat16)
    else:
        from cvsteer_tpu_torch.filters.g4 import g4_bank
        from cvsteer_tpu_torch.ops.cuda_frontend import g4_maps
        from cvsteer_tpu_torch.parallel.frontend_sharded import sharded_g4_maps as sharded

        bank = g4_bank(args.width or 6, args.spacing or 0.5)

        def maps(batch):
            return g4_maps(batch, bank.xtaps, bank.ytaps, out_dtype=torch.bfloat16)

    def mesh_skip_reason(b, h):
        """None if the batch can shard; otherwise the human-readable reason."""
        nd, ns = mesh_axis(mesh, "data")[0], mesh_axis(mesh, "space")[0]
        if b % nd != 0:
            return f"batch {b} not divisible by data={nd}"
        if h % ns != 0:
            return f"rows {h} not divisible by space={ns}"
        if (h // ns) <= bank.radius:
            return f"row block {h // ns} <= kernel radius {bank.radius}"
        return None

    if args.gain > 0:
        to8 = lambda x: convert_scale_u8(x, args.gain)  # noqa: E731
    else:
        to8 = lambda x: normalize_minmax_u8(x, axes=(-2, -1))  # noqa: E731

    filenames = _expand_inputs(args.input)
    if args.output:
        os.makedirs(args.output, exist_ok=True)

    t0 = time.time()
    n_done = 0
    pending = defaultdict(list)  # shape -> [(file index, image)]
    inflight = []  # (file indices, shape, device u8 maps)

    def flush(shape):
        entries = pending.pop(shape)
        idxs = [i for i, _ in entries]
        batch = np.stack([im for _, im in entries])
        reason = None if mesh is None else mesh_skip_reason(*batch.shape[:2])
        if mesh is not None and reason is None:  # every rank: its block, then the gather
            full = gather_blocks(sharded(shard_batch(batch, mesh), mesh, bank), mesh)
            if root:
                inflight.append((idxs, shape, tuple(to8(m) for m in full)))
            return
        if mesh is not None and root:
            print(f"mesh skipped for batch {batch.shape}: {reason}", file=sys.stderr)
        if root:
            result = maps(torch.from_numpy(batch).to(device))
            inflight.append((idxs, shape, tuple(to8(m) for m in result)))

    def write_maps(i, edges8, dark8, bright8):
        base = os.path.join(args.output, _basename(filenames[i]))
        imwrite_u8(base + "_edges.png", edges8)
        imwrite_u8(base + "_lines_dark.png", dark8)
        imwrite_u8(base + "_lines_bright.png", bright8)

    with ThreadPoolExecutor() as pool:
        write_futs = []

        def drain_one():
            nonlocal n_done
            idxs, shape, result = inflight.pop(0)
            edges8, dark8, bright8 = (m.cpu().numpy() for m in result)
            for j, i in enumerate(idxs):
                n_done += 1
                if args.verbose:
                    print(f"[{n_done}/{len(filenames)}] {filenames[i]} {shape}")
                if args.output:
                    write_futs.append(pool.submit(write_maps, i, edges8[j], dark8[j], bright8[j]))

        for i, img in enumerate(pool.map(imread_gray_f32, filenames)):
            if img is None:
                if root:
                    print(f"skip unreadable: {filenames[i]}", file=sys.stderr)
                continue
            pending[img.shape].append((i, img))
            if len(pending[img.shape]) >= args.batch:
                flush(img.shape)
            while len(inflight) > MAX_INFLIGHT:
                drain_one()
        for shape in list(pending):
            flush(shape)
        while inflight:
            drain_one()
        for f in write_futs:
            f.result()
    if args.verbose and root:
        dt = time.time() - t0
        print(f"processed {n_done} images in {dt:.3f}s ({n_done / max(dt, 1e-9):.1f} im/s)")
    if own_world:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

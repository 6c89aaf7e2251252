"""Matrix-unit and algebra variants of kernel E's maps: device us/frame and error.

The port of scripts/profile_variants.py, with its cases and the three its
``build`` also makes:

  presplit:row / :col / :coeff   kernel M cut at a stage (fp32 row pass
                                 split hi/lo, bf16x3 column pass on the
                                 tensor cores; the v2 stage outputs)
  presplit                       kernel M, full: the maps (sqrt steering)
  baseline                       kernel V "sqrt": fp32 row and column
                                 passes, the sqrt steering (_maps_from_basis)
  rowmxu                         kernel M, row="mma": the row pass as taps
                                 split hi/lo times the bf16 image on the
                                 tensor cores, bf16x3 column pass
  factored                       kernel V "factored": c2, c3 by the harmonic
                                 factorization, the sqrt steering

on a [batch, size, size] batch from default_rng(0) (uniform 0..255). The
error of a variant that makes the maps is max |out - ref| over the largest
|ref| (the script's measure) against the fp32 maps of ops.cuda_frontend.
g2_maps_plain; the stage cuts make no maps and have none. Prints
``| variant | device us/frame | max rel err |``.

    python -m cvsteer_tpu_torch.probes.profile_variants [--batch 16] [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from cvsteer_tpu_torch import probes

B, H, W = 16, 512, 512
#: variant -> (kernel, keyword arguments of its wrapper)
CASES = [
    ("presplit:row", "M", dict(stage="row")),
    ("presplit:col", "M", dict(stage="col")),
    ("presplit:coeff", "M", dict(stage="coeff")),
    ("presplit", "M", dict(stage="full")),
    ("baseline", "V", dict(tail="sqrt")),
    ("rowmxu", "M", dict(stage="full", row="mma")),
    ("factored", "V", dict(tail="factored")),
]


def measure(device: str = "cuda", batch: int = B, size: int = H, reps: int = 25) -> list:
    """[(variant, kernel, us per frame, max rel err or None)]."""
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.ops import cuda_probes as cp

    xt, yt = probes.g2_taps()
    img = probes.uniform_batch(batch, size, device)
    ref = cf.g2_maps_plain(img, xt, yt)
    rows = []
    for variant, kernel, kw in CASES:
        if kernel == "M":
            fn = lambda kw=kw: cp.maps_mma(img, xt, yt, **kw)  # noqa: E731
            names = ("mma_maps_kernel",)
        else:
            fn = lambda kw=kw: cp.maps_variant(img, xt, yt, **kw)  # noqa: E731
            names = ("maps_kernel",)
        us = 1e3 * probes.time_ms(fn, device, names, 1, reps) / batch
        makes_maps = kw.get("stage", "full") == "full"
        rows.append((variant, kernel, us, probes.max_rel_to_scale(fn(), ref) if makes_maps else None))
    return rows


def main(argv=None) -> int:
    args = probes.parser(__doc__.split("\n")[0]).parse_args(argv)
    device = probes.device_or_exit(args)
    if device is None:
        return 1
    print(probes.card_line(device))
    unit = "device us/frame" if device == "cuda" else "host us/frame (plain versions)"
    print(f"# variants: B={args.batch} {args.size}x{args.size}")
    print(f"| variant | kernel | {unit} | max rel err |")
    print("|---|---|---|---|")
    for variant, kernel, us, err in measure(device, args.batch, args.size):
        print(f"| {variant} | {kernel} | {us:.3f} | {'n/a (stage cut)' if err is None else f'{err:.2e}'} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where kernel E's time goes: E cut at each stage, profile_frontend.py's outputs.

The port of scripts/profile_frontend.py: kernel S (ops.cuda_probes.
maps_stage, outputs "frontend") at each stage of kernel E

  load   stage the tile, write (x, 2x, 3x)                (the script's "dma")
  row    + the row passes: filters 0-2's row-pass values
  col    + the column passes: (g2a, g2b, h2a)
  coeff  + the energy's second harmonic: (c2, c3, g2a)
  full   + the sqrt / cos / sin steering: the three maps

then the script's precision experiment, "full/col_default": the full maps
with the column pass as one bf16 product on the tensor cores (the TPU's
Precision.DEFAULT; kernel M, ops.cuda_probes.maps_mma col="bf16x1"), then
kernel E's own time on the same batch and the bytes bound.

    python -m cvsteer_tpu_torch.probes.profile_frontend [--batch 16] [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from cvsteer_tpu_torch import probes
from cvsteer_tpu_torch.probes import profile_v2_stages

B, H, W = 16, 512, 512


def measure(device: str = "cuda", batch: int = B, size: int = H, reps: int = 25) -> dict:
    """profile_v2_stages.measure's result with the frontend outputs, plus
    "col_default_us"."""
    from cvsteer_tpu_torch.ops import cuda_probes as cp

    res = profile_v2_stages.measure(device, batch, size, outputs="frontend", reps=reps)
    xt, yt = probes.g2_taps()
    img = probes.uniform_batch(batch, size, device)
    fn = lambda: cp.maps_mma(img, xt, yt, "full", row="fp32", col="bf16x1")  # noqa: E731
    res["col_default_us"] = 1e3 * probes.time_ms(fn, device, ("mma_maps_kernel",), 1, reps) / batch
    return res


def main(argv=None) -> int:
    args = probes.parser(__doc__.split("\n")[0]).parse_args(argv)
    device = probes.device_or_exit(args)
    if device is None:
        return 1
    print(probes.card_line(device))
    res = measure(device, args.batch, args.size)
    profile_v2_stages.print_table(res, device, args.batch, args.size,
                                  extra=[("full/col_default (kernel M, bf16x1)", res["col_default_us"])])
    return 0


if __name__ == "__main__":
    sys.exit(main())

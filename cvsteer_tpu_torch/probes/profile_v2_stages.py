"""Where kernel E's time goes: E cut at each stage, profile_v2_stages.py's outputs.

The port of scripts/profile_v2_stages.py: kernel S (ops.cuda_probes.
maps_stage, outputs "v2") runs kernel E's grid, tile and output traffic
(three fp32 maps) and one more part of E's work per stage:

  load   stage the tile, write (x, 2x, 3x)                (the script's "dma")
  row    + the row passes: sums of the bf16 hi and lo parts of the 7 filters
  col    + the column passes: (sum of the basis, g2a - g2b, g2c - h2a)
  coeff  + the energy's second harmonic: (c2, c3, c2 + c3)
  full   + the sqrt-free steering (the script's form): the three maps

on a [batch, size, size] batch drawn from default_rng(0) (uniform 0..255),
and prints ``| stage | device us/frame | delta us |``, then kernel E's own
time (ops.cuda_frontend.g2_maps, fp32 maps) on the same batch, and the
bytes bound every stage shares (16 B a pixel).

    python -m cvsteer_tpu_torch.probes.profile_v2_stages [--batch 16] [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from cvsteer_tpu_torch import probes

B, H, W = 16, 512, 512
OUTPUTS = "v2"


def measure(device: str = "cuda", batch: int = B, size: int = H, outputs: str = OUTPUTS,
            reps: int = 25) -> dict:
    """{"stages": [(stage, us per frame)], "entry_us": E's us per frame,
    "bound_us": the bytes bound per frame}."""
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.ops import cuda_probes as cp

    xt, yt = probes.g2_taps()
    img = probes.uniform_batch(batch, size, device)
    per_frame = lambda ms: 1e3 * ms / batch  # noqa: E731
    stages = []
    for stage in cp.STAGES:
        fn = lambda stage=stage: cp.maps_stage(img, xt, yt, stage, outputs)  # noqa: E731
        names = ("maps_kernel", "stage_rows_kernel")
        stages.append((stage, per_frame(probes.time_ms(fn, device, names, 1, reps))))
    entry = per_frame(probes.time_ms(lambda: cf.g2_maps(img, xt, yt), device, ("maps_kernel",), 1, reps))
    return dict(stages=stages, entry_us=entry, bound_us=1e3 * probes.maps_bound_ms(size * size))


def print_table(res: dict, device: str, batch: int, size: int, extra=()) -> None:
    unit = "device us/frame" if device == "cuda" else "host us/frame (plain versions)"
    print(f"# stage isolation: B={batch} {size}x{size}")
    print(f"| stage | {unit} | delta us |")
    print("|---|---|---|")
    prev = 0.0
    for stage, us in res["stages"]:
        print(f"| {stage} | {us:.3f} | {us - prev:+.3f} |")
        prev = us
    for label, us in extra:
        print(f"| {label} | {us:.3f} | |")
    print(f"| entry: kernel E (g2_maps, fp32 maps) | {res['entry_us']:.3f} | |")
    print(f"\nbytes bound (image in, three fp32 maps out, 16 B/px at "
          f"{probes.HBM_BYTES_PER_S / 1e12:.2f} TB/s): {res['bound_us']:.3f} us/frame")


def main(argv=None) -> int:
    args = probes.parser(__doc__.split("\n")[0]).parse_args(argv)
    device = probes.device_or_exit(args)
    if device is None:
        return 1
    print(probes.card_line(device))
    res = measure(device, args.batch, args.size)
    print_table(res, device, args.batch, args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())

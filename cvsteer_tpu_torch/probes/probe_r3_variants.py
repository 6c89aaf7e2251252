"""CUDA-core variants of kernel E's maps: device us/frame and error.

The port of scripts/probe_r3_variants.py: kernel V (ops.cuda_probes.
maps_variant) with the script's composable flags, on its cases

  tile 64:  base, sd, tail16, sd+tail16, carry, carry+sd+tail16;
  then carry+sd+tail16 at tile heights 96, 128 and 32,

where sd reuses g2a +- g2c (kernel E's own tail), tail16 runs the steering
chains in bf16, and carry has one block walk a column of tiles keeping the
row passes' overlap rows. The input is the script's: integers 0..255 from
default_rng(0), [batch, size, size]. The error is max over the maps of
max |out - ref| / mean |ref| against the fp32 maps of
ops.cuda_frontend.g2_maps_plain. Prints ``| tile | variant | us/frame |
max-rel-to-mean |``.

    python -m cvsteer_tpu_torch.probes.probe_r3_variants [--batch 16] [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from cvsteer_tpu_torch import probes

B, H, W = 16, 512, 512
#: (tile height, the script's variant) in its order
CASES = [(64, v) for v in ("", "sd", "tail16", "sd+tail16", "carry", "carry+sd+tail16")] + [
    (96, "carry+sd+tail16"), (128, "carry+sd+tail16"), (32, "carry+sd+tail16")]


def variant_args(variant: str):
    """The script's flags -> (tail, carry) of kernel V."""
    flags = set(filter(None, variant.split("+")))
    tail = {frozenset(): "base", frozenset({"sd"}): "sd", frozenset({"tail16"}): "tail16",
            frozenset({"sd", "tail16"}): "sd_tail16"}[frozenset(flags - {"carry"})]
    return tail, "carry" in flags


def measure(device: str = "cuda", batch: int = B, size: int = H, reps: int = 25) -> list:
    """[(tile, variant, us per frame, max-rel-to-mean)] in CASES' order."""
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.ops import cuda_probes as cp

    xt, yt = probes.g2_taps()
    img = probes.uniform_batch(batch, size, device, integers=True)
    ref = cf.g2_maps_plain(img, xt, yt)
    rows = []
    for tile, variant in CASES:
        tail, carry = variant_args(variant)
        fn = lambda: cp.maps_variant(img, xt, yt, tail, carry=carry, tile_h=tile)  # noqa: E731
        ms = probes.time_ms(fn, device, ("maps_kernel", "carry_kernel"), 1, reps)
        rows.append((tile, variant or "base", 1e3 * ms / batch, probes.max_rel_to_mean(fn(), ref)))
    return rows


def main(argv=None) -> int:
    args = probes.parser(__doc__.split("\n")[0]).parse_args(argv)
    device = probes.device_or_exit(args)
    if device is None:
        return 1
    print(probes.card_line(device))
    unit = "us/frame" if device == "cuda" else "host us/frame (plain versions)"
    print(f"| tile | variant | {unit} | max-rel-to-mean |")
    print("|---|---|---|---|")
    for tile, variant, us, err in measure(device, args.batch, args.size):
        print(f"| {tile} | {variant} | {us:.3f} | {err:.2e} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

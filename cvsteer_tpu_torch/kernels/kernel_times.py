"""Device time of kernels B and F by CUDA function, at their paths' shapes.

    python -m cvsteer_tpu_torch.kernels.kernel_times [--reps 25]

Two wrapper calls: kernel B's 5-level pyramid of a 480x640 frame (one
``pyr_down_levels`` call; in a tree that has only the one-step
``pyr_down``, its four steps) and kernel F's adjoint with the G2/H2 (K 7,
T 9) and G4/H4 (K 11, T 13) banks at 1x480x640. For each CUDA function a
call launches it prints one JSON line: its launches per call (from the
device trace) and its device ms per call (utils.profiling.device_ms). So it
also splits a kernel that is more than one function, such as a kernel F
of two launches. The first line is the card's name and power limit. Needs
an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys


def _functions(call) -> dict:
    """{CUDA function name: launches per call} from one traced call."""
    from cvsteer_tpu_torch.utils.profiling import device_window

    with device_window() as win:
        call()
    win.check()
    counts = {}
    for evt in win.events:
        m = re.search(r"(\w+)(?=[<(])", evt.name())
        if m and not evt.name().startswith(("Memcpy", "Memset")):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", file=sys.stderr)
        return 1
    from cvsteer_tpu_torch.filters.g2 import g2_bank
    from cvsteer_tpu_torch.filters.g4 import g4_bank
    from cvsteer_tpu_torch.io.render import PlanesSequence
    from cvsteer_tpu_torch.ops import cuda_frontend as cf
    from cvsteer_tpu_torch.utils.profiling import device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    frame = torch.from_numpy(PlanesSequence(n_frames=1, seed=0).render(0)).cuda()[None].contiguous()
    if hasattr(cf, "pyr_down_levels"):
        calls = {"B pyramid, 5 levels": lambda: cf.pyr_down_levels(frame, 5)}
    else:
        def steps():
            x = frame
            for _ in range(4):
                x = cf.pyr_down(x)
        calls = {"B pyramid, 5 levels": steps}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, bank in (("G2", g2_bank()), ("G4", g4_bank())):
        g = torch.randn((1, bank.xtaps.shape[0], 480, 640), device="cuda", generator=gen)
        calls[f"F {name} 1x480x640"] = lambda g=g, b=bank: cf.filter_bank_adjoint(g, b.xtaps, b.ytaps)
    for unit, call in calls.items():
        call()
        torch.cuda.synchronize()
        for fn, n in sorted(_functions(call).items()):
            ms, seen = device_ms(call, (fn,), n, reps=args.reps)
            print(json.dumps(dict(call=unit, function=fn, launches_per_call=n, device_ms=ms,
                                  events_seen_per_call=seen, card=torch.cuda.get_device_name(0))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

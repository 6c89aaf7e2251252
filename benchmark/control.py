"""The control of the front-end comparison, and the readings its limits come from.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--ticks 4]

For each seed: the cell's frames are made as a run makes them, the
program's ``extract_features`` runs on ``--ticks`` of the cell's batches
drawn from the seed (its own batch size: the fleet's S-frame stack or the
extraction's B frames), and both the program and the control are judged against the
float64 reference by benchmark.judge. The control is the reference itself
put in the program's place and computed one precision step below what the
configuration states: float32 with every filter-bank and quadratic-form
product in TF32 (benchmark.reference, ``precision="tf32"``). One JSON line
per seed: the program's numbers (the sound readings) and the control's.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ticks", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness, judge, reference
    from benchmark.run import find_cell, load_spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = load_spec()
    cell, _, cfg, traffic = find_cell(spec, args.workload)
    dev = torch.device("cuda")
    from cvsteer_tpu_torch.features.frontend import extract_features

    levels = int(cfg["frontend"].get("levels", 5))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cfg, traffic, seed, dev)
        if cfg["serve"] == "fleet":
            pool = harness._fleet_frames(run)[0]
        else:
            pool = harness._extract_pool(run)
        fcfg = harness._features_config(cfg)
        out = {"seed": seed}
        prog, refs, ctrl = [], [], []
        block = int(traffic.get("reference_block", 4))
        rows_drawn = np.random.default_rng(seed).choice(pool.shape[0], args.ticks, replace=False)
        for k in rows_drawn:
            imgs = pool[int(k)].to(dev)
            prog += harness._rows(extract_features(imgs, cfg=fcfg))
            with torch.no_grad():
                for lo in range(0, imgs.shape[0], block):
                    refs += reference.features(imgs[lo: lo + block], cfg["frontend"], "float64")
                    ctrl += reference.features(imgs[lo: lo + block], cfg["frontend"], "tf32")
        out["program"] = judge.frontend_numbers(prog, refs, levels)
        out["control"] = judge.frontend_numbers([reference.as_frame(c) for c in ctrl], refs, levels)
        out["frames"] = len(prog)
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

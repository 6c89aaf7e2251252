"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic
are found by name through BENCHMARK.json (benchmark/configs/<config>.json,
benchmark/traffic/<traffic>.json); each per-layer metric is read by
benchmark/metrics/<metric>.py. The run sets up (frames rendered on the
card, the program built and warmed up), measures for ``--seconds``, with
``--trace 1`` traces a further fixed stretch, judges what the timed path
produced against the plain reference, and prints as its last line one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, and with --trace 1
breakdown. It exits non-zero, printing no result, without a CUDA card, and
when the process holds jax, jaxlib, flax or cvsteer_tpu once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
#: modules the process may not hold, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "cvsteer_tpu")
#: the process's CPU threads: the card does the arithmetic, and few threads
#: keep a run's host load (and so its spread) small
HOST_THREADS = 4


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str, root: str = ROOT):
    """(cell, configuration entry, configuration file, traffic file) by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, conf, cfg, traffic


def metrics_for(spec: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, run, root: str = ROOT):
    """benchmark/metrics/<name>.py's read(run): a number, or None where it
    found nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's fixed cache directories; the kernel library builds into
    # cvsteer_tpu_torch/kernels/_build/ inside the checkout
    cache = os.path.join(BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    spec = load_spec()
    cell, _, cfg, traffic = find_cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    torch.set_num_threads(HOST_THREADS)

    from benchmark import harness, judge

    dev = torch.device("cuda", 0)
    run = harness.run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace), T_START, dev)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    wanted = metrics_for(spec, cell["name"], kind)
    if args.trace:
        values = {m["name"]: read_metric(m["name"], run) for m in wanted}
    else:
        values = harness.end_to_end(run, [m["name"] for m in wanted])
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    correct, rows = judge.verdict(run.numbers)
    attempted = run.counters.get("poses_attempted", run.frames + run.trace_frames)
    failed = run.counters.get("poses_failed", 0)
    correct = correct and failed == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if args.trace:
        tr = run.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in tr.top_ops()],
                            "idle_gaps": [[n, s] for n, s in tr.gaps()]}
    # a number that could not be read (no keypoint matched, no pose pair)
    # is printed as a string: JSON has no infinity
    compared = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                for name, v, lim in rows}
    compared["failed_answers"] = {"value": int(failed), "limit": 0}
    out["compared"] = compared
    print(json.dumps({"card": _power_limit(), "counters": run.counters,
                      "window_s": run.window_s, "frames": run.frames}, default=str))
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

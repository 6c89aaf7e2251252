"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as files only: the harness finds each by its name."""

import json
import os
import shutil

from benchmark.run import find_cell, load_spec, metrics_for, read_metric
from benchmark.tests.conftest import ROOT


def test_bench_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "tum_vga_fleet.json").read_text())
    cfg.update(name="tum_vga_fleet_s8", streams=8)
    (bench / "configs" / "tum_vga_fleet_s8.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "staggered_xyz.json").read_text())
    tr.update(name="staggered_desk", motion=dict(tr["motion"], speed_mps=0.413, rot_speed_dps=23.327))
    (bench / "traffic" / "staggered_desk.json").write_text(json.dumps(tr))
    (bench / "metrics" / "ticks_traced.py").write_text(
        "def read(run):\n    return None if run.trace is None else float(run.trace_ticks)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tum_vga_fleet_s8", "source": "https://example.org/x",
                            "file": "benchmark/configs/tum_vga_fleet_s8.json", "reduced": [],
                            "why": "eight cameras"})
    spec["workloads"].append({"name": "tum_fleet_s8_desk", "config": "tum_vga_fleet_s8",
                              "traffic": "staggered_desk", "chips": 1, "why": "faster motion"})
    spec["per_layer"].append({"name": "ticks_traced", "unit": "ticks", "better": "higher",
                              "source": "program_counter", "layer": "fleet host",
                              "moves": "frames_per_s", "workloads": ["tum_fleet_s8_desk"]})
    spec["end_to_end"][1]["workloads"].append("tum_fleet_s8_desk")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = load_spec(str(root))
    cell, conf, cfg2, tr2 = find_cell(spec, "tum_fleet_s8_desk", str(root))
    assert cell["traffic"] == "staggered_desk" and cfg2["streams"] == 8
    assert tr2["motion"]["speed_mps"] == 0.413
    names = [m["name"] for m in metrics_for(spec, "tum_fleet_s8_desk", "per_layer")]
    assert names == ["ticks_traced"]
    e2e = [m["name"] for m in metrics_for(spec, "tum_fleet_s8_desk", "end_to_end")]
    assert e2e == ["frames_per_s", "tick_p95_ms", "peak_mem_gib", "setup_s"]

    class _Run:
        trace, trace_ticks = object(), 30

    assert read_metric("ticks_traced", _Run(), str(root)) == 30.0


def test_bench_every_named_file_exists():
    spec = load_spec()
    for w in spec["workloads"]:
        cell, conf, cfg, tr = find_cell(spec, w["name"])
        assert conf["file"].startswith("benchmark/configs/") and cfg["name"] == conf["name"]
        assert tr["name"] == w["traffic"]
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))

"""The spans and counts of DeviceVOFleet.step and extract_features, on CPU.

A fleet of S = 4 streams on tests/assets/tum_fixture's frames (stream s
joins at tick s, its frames offset by s): one ``fleet.step`` a call with
the classic tick's children, ``fp_rows`` S on the ticks FP ran and 0 on
the others, the summed ``promoted`` equal to the keyframes the stacked
engines added, every attribute an int, float or str; the pipelined tick's
``fleet.launch`` and ``fleet.process``, its counts on the step that
processed the fetched tick. extract_features on the fused G2 and the
generic G4 path: ``features.extract`` with ``frames`` and ``path`` and
its stage spans."""

import pathlib
import time

import pytest
import torch

from cvsteer_tpu_torch.features.frontend import Features, FrontendConfig, extract_features
from cvsteer_tpu_torch.geometry.camera import Intrinsics
from cvsteer_tpu_torch.io.datasets import open_sequence
from cvsteer_tpu_torch.io.imageio import imread_gray_f32
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.slam.vo_device import DeviceVOFleet
from cvsteer_tpu_torch.utils import profiling

torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).resolve().parents[1] / "tests" / "assets" / "tum_fixture"
S = 4
CFG = VOConfig(intrinsics=Intrinsics(300.0, 300.0, 160.0, 120.0), min_parallax=0.005,
               kf_max_gap=4, window=6)
CLASSIC_CHILDREN = {"fleet.enter", "fleet.stage", "fleet.ft", "fleet.wait", "fleet.fp",
                    "fleet.complete", "fleet.event"}


@pytest.fixture(scope="module")
def features():
    paths = open_sequence(str(FIXTURE)).image_paths
    imgs = torch.stack([torch.from_numpy(imread_gray_f32(p)) for p in paths])
    return extract_features(imgs, cfg=CFG.frontend)


def _run(feats, n_ticks, **kw):
    """Step a fleet n_ticks, then once with no frame (a pipelined fleet
    drains); (its step spans with their children, and per tick the
    keyframes the engines on the stack before the tick added)."""
    fleet = DeviceVOFleet(CFG, n_streams=S, device="cpu", **kw)
    t0 = time.time_ns()
    added = []
    for T in range(n_ticks + 1):
        on = fleet.active.copy()
        kf = [len(e.state.keyframes) for e in fleet.engines]
        fleet.step([Features(*(x[T - s] for x in feats)) if s <= T < n_ticks else None
                    for s in range(S)])
        added.append(sum(len(e.state.keyframes) - kf[i] for i, e in enumerate(fleet.engines)
                         if on[i] and fleet.active[i]))
    mine = [s for s in profiling.spans() if s.start_ns >= t0]
    kids = {}
    for s in mine:
        kids.setdefault(s.parent, []).append(s)
    steps = [s for s in mine if s.name == "fleet.step"]
    return fleet, steps, kids, added, mine


def _descendants(kids, s):
    out = []
    for c in kids.get(s.index, []):
        out += [c] + _descendants(kids, c)
    return out


def test_torch_fleet_classic_tick_spans_and_counts(features):
    n = 16
    fleet, steps, kids, added, mine = _run(features, n)
    assert [s.attrs["tick"] for s in steps] == list(range(n + 1))
    assert all(s.parent == -1 for s in steps)
    for s in mine:
        assert all(type(v) in (int, float, str) for v in s.attrs.values()), s
    for s in steps:
        a = s.attrs
        names = [c.name for c in kids.get(s.index, [])]
        assert set(names) <= CLASSIC_CHILDREN and names[0] == "fleet.enter"
        waits = [c.attrs["fetch"] for c in kids.get(s.index, []) if c.name == "fleet.wait"]
        if a["stepped"]:
            assert names[1:4] == ["fleet.stage", "fleet.ft", "fleet.wait"]
            assert names[-1] == "fleet.complete"
        else:
            assert names == ["fleet.enter"]
        assert a["fp_rows"] in (0, S)
        assert (a["fp_rows"] == S) == ("fleet.fp" in names) == (waits == [1, 2])
        assert 0 <= a["promoted"] <= (a["stepped"] if a["fp_rows"] else 0)
        events = [c for c in _descendants(kids, s) if c.name == "fleet.event"]
        assert len(events) == a["event_paths"]
    # every stream bootstraps on the host once, then stays on the stack
    assert sum(s.attrs["bootstrapped"] for s in steps) >= S
    assert fleet.active.all()
    assert [s.attrs["promoted"] for s in steps] == added
    assert sum(added) > 0
    fp = [s.attrs["fp_rows"] for s in steps if s.attrs["stepped"]]
    assert S in fp and 0 in fp  # ticks with FP and a tick without


def test_torch_fleet_pipelined_tick_spans_and_counts(features):
    n = 12
    fleet, steps, kids, added, _ = _run(features, n, pipeline=True)
    for s in steps:
        names = [c.name for c in kids.get(s.index, [])]
        assert names[0] == "fleet.enter" and set(names) <= {"fleet.enter", "fleet.launch",
                                                           "fleet.process"}
        assert s.attrs["fp_rows"] == (S if "fleet.launch" in names else 0)
    # the fetched ticks' promotions, counted where they were processed
    assert sum(s.attrs["promoted"] for s in steps) == sum(added) > 0
    assert sum(s.attrs["stepped"] for s in steps) == sum(
        s.attrs["stepped"] for s in steps if s.attrs["fp_rows"])


@pytest.mark.parametrize("order,path", [(2, "fused"), (4, "generic")])
def test_torch_extract_features_spans(order, path):
    cfg = FrontendConfig(order=order, levels=3, keypoints_per_level=32)
    imgs = torch.rand(3, 48, 64) * 255
    t0 = time.time_ns()
    extract_features(imgs, cfg=cfg)
    extract_features(imgs[0], cfg=cfg)
    mine = [s for s in profiling.spans() if s.start_ns >= t0]
    calls = [s for s in mine if s.name == "features.extract"]
    assert [(c.attrs["frames"], c.attrs["path"]) for c in calls] == [(3, path), (1, path)]
    for c in calls:
        kids = [s for s in mine if s.parent == c.index]
        names = [k.name for k in kids]
        levels = ["features.level"] * (cfg.levels if path == "generic" else 1)
        assert names == ["features.pyramid", *levels, "features.descriptors", "features.assemble"]
        if path == "generic":
            assert [k.attrs["level"] for k in kids[1:-2]] == list(range(cfg.levels))
        else:
            assert kids[1].attrs == {}
        assert all(c.start_ns <= k.start_ns <= k.end_ns <= c.end_ns for k in kids)

"""The run's verdict with the timed path broken underneath: each fault a
cell can have must turn ``correct`` false. The harness runs on the CPU at a
small size (the look for a card is skipped; everything after it runs as on
the card), the program's kernels in their plain versions.

Faults: a fleet step that returns each stream's state unchanged (the pose
of the previous frame again), for every stream or for every other stream
only; half of a batch left out (the front-end run
on half the frames, its features repeated for the rest); an answer altered
where it is produced (every descriptor turned a little). The cells run on
one card, so no exchange between cards can be left out.
"""

import pytest
import torch

from benchmark import judge
from benchmark.tests.small import run_small, small_extract, small_fleet

SEED = 2_147_483_911


def _correct(run):
    ok, _ = judge.verdict(run.numbers)
    return ok and run.counters.get("poses_failed", 0) == 0


def _half_batch(extract):
    def broken(images, bank=None, cfg=None):
        n = images.shape[0]
        half = extract(images[: max(n // 2, 1)], bank, cfg)
        idx = torch.arange(n) % max(n // 2, 1)
        return type(half)(*(f[idx] for f in half))
    return broken


def _altered(extract):
    def broken(images, bank=None, cfg=None):
        f = extract(images, bank, cfg)
        d = f.desc + 3e-3 * torch.sin(torch.arange(f.desc.shape[-1], dtype=f.desc.dtype))
        return f._replace(desc=torch.where(f.valid[..., None], d / d.norm(dim=-1, keepdim=True), 0.0))
    return broken


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_bench_extract_faults_fail(monkeypatch, fault):
    from cvsteer_tpu_torch.features import frontend

    cfg, tr = small_extract()
    wrap = {"half_batch": _half_batch, "altered": _altered}[fault]
    monkeypatch.setattr(frontend, "extract_features", wrap(frontend.extract_features))
    assert not _correct(run_small(cfg, tr, SEED, 2.0))


def test_bench_extract_sound_run_is_correct():
    cfg, tr = small_extract()
    run = run_small(cfg, tr, SEED, 2.0)
    assert run.counters["frames_compared"] >= 8
    assert _correct(run), run.numbers


def _stuck_step(step, every=1):
    def broken(self, frames):
        step(self, frames)
        for i, (eng, f) in enumerate(zip(self.engines, frames)):
            traj = eng.state.trajectory
            if i % every == every - 1 and f is not None and len(traj) >= 2:
                traj[-1] = (traj[-1][0], traj[-2][1], traj[-2][2])
    return broken


@pytest.mark.parametrize("fault", ["stuck_step", "stuck_every_other", "half_batch", "altered"])
def test_bench_fleet_faults_fail(monkeypatch, fault):
    from cvsteer_tpu_torch.features import frontend
    from cvsteer_tpu_torch.slam import vo_device

    cfg, tr = small_fleet()
    if fault.startswith("stuck"):
        every = 2 if fault == "stuck_every_other" else 1
        monkeypatch.setattr(vo_device.DeviceVOFleet, "step",
                            _stuck_step(vo_device.DeviceVOFleet.step, every))
    else:
        wrap = {"half_batch": _half_batch, "altered": _altered}[fault]
        monkeypatch.setattr(frontend, "extract_features", wrap(frontend.extract_features))
    run = run_small(cfg, tr, SEED, 24.0)
    assert not _correct(run), run.numbers


def test_bench_fleet_sound_run_is_correct():
    cfg, tr = small_fleet()
    run = run_small(cfg, tr, SEED, 24.0)
    assert run.counters["frames_compared"] >= 2
    assert _correct(run), run.numbers

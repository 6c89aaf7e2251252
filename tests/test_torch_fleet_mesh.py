"""The port's stacked fleet sharded over a mesh axis
(cvsteer_tpu_torch.slam.vo_device.DeviceVOFleet(mesh=)) on the CPU: the
reference's tests/test_vo_device.py:581-616 on torch.distributed.

The parent renders the reference test's worlds (tests/test_vo.py's
_make_world(seed=50 + s), _render_features with default_rng(60 + s):
kf_max_gap 5, window 8, track_min_landmarks 30, 20 frames, 4 streams) and
runs the unsharded fleet; one spawned 2-rank gloo world (2 streams a rank)
runs the sharded fleets on numpy copies of the frames, importing no jax:

1. classic ticks over {data: 2}: every stream's frames and keyframes equal
   the unsharded fleet's and its poses are within atol 1e-5 (the
   reference's bar); a 1-rank mesh (make_mesh in the parent) is the
   unsharded fleet bit for bit;
2. pipelined with promote_cap = 1 over {data: 2}: the cap and the rotating
   origin stay the whole fleet's (one gather of the requests a tick), so
   each stream's keyframe indices equal the unsharded capped fleet's and
   its poses are within 1e-5;
3. 3 streams over 2 ranks raise the reference's ValueError, word for word,
   and an axis the mesh lacks is refused.

vmap's per-stream fallback warning is an error, in the parent and the
ranks.
"""

import os

import numpy as np
import pytest
import torch

from cvsteer_tpu_torch.slam import vo_device as tvd
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

S, RANKS, N_FRAMES = 4, 2, 20
CFG = dict(kf_max_gap=5, window=8, track_min_landmarks=30)
RUNS = {"classic": {}, "capped": dict(pipeline=True, promote_cap=1)}
POSE_ATOL = 1e-5  # tests/test_vo_device.py:614-615


def _features(f):
    from cvsteer_tpu_torch.features.frontend import Features

    return Features(**{k: torch.from_numpy(v) for k, v in f.items()})


def _run(cfg, ticks, **kw):
    """The fleet over the ticks, then each stream's (frame ids, keyframe
    indices, R, t)."""
    flt = tvd.DeviceVOFleet(cfg, n_streams=S, device="cpu", **kw)
    for tick in ticks:
        flt.step([_features(f) for f in tick])
    out = []
    for s in range(S):
        st = flt.finalize(s)
        R, t = st.poses()
        out.append(([f for f, _, _ in st.trajectory], [kf.index for kf in st.keyframes], R, t))
    return out, flt


def _rank_fleets(rank, cfg, ticks):
    """The sharded fleets of this file on one rank."""
    import warnings

    from cvsteer_tpu_torch.parallel import make_mesh

    warnings.filterwarnings("error", "There is a performance drop")
    mesh = make_mesh({"data": RANKS}, "cpu")
    out = {}
    for name, kw in RUNS.items():
        res, flt = _run(cfg, ticks, mesh=mesh, **kw)
        out[name] = dict(streams=res, engines=len(flt.engines), captures=flt.captures,
                         n_states=len(flt.states))
    # the unsharded reference of one run a rank, in a process like the
    # sharded one's (MKL's sgemm rounds by operand alignment otherwise)
    name = sorted(RUNS)[rank]
    out["single"] = (name, _run(cfg, ticks, **RUNS[name])[0])
    for key, kw in (("error", dict(n_streams=3)), ("no_axis", dict(n_streams=4, mesh_axis="streams"))):
        try:
            tvd.DeviceVOFleet(cfg, mesh=mesh, device="cpu", **kw)
        except ValueError as e:
            out[key] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import test_vo as ref  # the reference test's synthetic world (jax: the parent only)

    from cvsteer_tpu_torch.parallel.launch import spawn_world

    cfg = VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG)
    worlds = [ref._make_world(seed=50 + s) for s in range(S)]
    rngs = [np.random.default_rng(60 + s) for s in range(S)]
    ticks = []
    for k in range(N_FRAMES):
        R, t = ref._gt_pose(k, N_FRAMES)
        ticks.append([{f: np.array(a) for f, a in zip(
            ("yx", "score", "theta", "level", "desc", "valid"),
            ref._render_features(worlds[s][0], worlds[s][1], R, t, rngs[s]))}
            for s in range(S)])
    cbwr = os.environ.get("MKL_CBWR")
    os.environ["MKL_CBWR"] = "COMPATIBLE"
    try:
        ranks = spawn_world(_rank_fleets, RANKS, args=(cfg, ticks), device_type="cpu",
                            workdir=str(tmp_path_factory.mktemp("world")))
    finally:
        if cbwr is None:
            os.environ.pop("MKL_CBWR")
        else:
            os.environ["MKL_CBWR"] = cbwr
    return dict(cfg=cfg, ticks=ticks, ranks=ranks, single=dict(r["single"] for r in ranks))


def _held(got, want, what):
    worst = 0.0
    for s, ((fa, ka, Ra, ta), (fb, kb, Rb, tb)) in enumerate(zip(got, want)):
        assert fa == fb == list(range(N_FRAMES)), (what, s)
        assert ka == kb, (what, s, ka, kb)
        np.testing.assert_allclose(Ra, Rb, atol=POSE_ATOL)
        np.testing.assert_allclose(ta, tb, atol=POSE_ATOL)
        worst = max(worst, float(np.abs(Ra - Rb).max()), float(np.abs(ta - tb).max()))
    return worst


@pytest.mark.parametrize("name", sorted(RUNS))
def test_torch_fleet_mesh_matches_unsharded(runs, name):
    ranks = runs["ranks"]
    for r in ranks:
        assert r[name]["engines"] == S // RANKS and r[name]["n_states"] == S
    # every rank returns every stream: the owner's state
    for r in ranks[1:]:
        for a, b in zip(r[name]["streams"], ranks[0][name]["streams"]):
            assert a[:2] == b[:2]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
    worst = _held(ranks[0][name]["streams"], runs["single"][name], name)
    print(f"parity fleet {name} S = {S} over {{data: {RANKS}}}: keyframes "
          f"{[s[1] for s in ranks[0][name]['streams']]}, max pose difference {worst:.3e} "
          f"(bar {POSE_ATOL})")


def test_torch_fleet_one_rank_mesh_is_the_fleet(runs):
    """A 1-rank mesh (make_mesh in this process, torn down after) runs the
    sharded code path, the requests' gather included: bit for bit the
    unsharded fleet in the same process."""
    import torch.distributed as dist

    from cvsteer_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_mesh({"data": 1}, "cpu")
        got = {name: _run(runs["cfg"], runs["ticks"], mesh=mesh, **kw)[0]
               for name, kw in RUNS.items()}
    finally:
        dist.destroy_process_group()
    for name, kw in RUNS.items():
        for a, b in zip(got[name], _run(runs["cfg"], runs["ticks"], **kw)[0]):
            assert a[:2] == b[:2]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])


def test_torch_fleet_mesh_refuses_uneven_streams(runs):
    want = "n_streams=3 must divide over mesh axis data=2"
    assert [r["error"] for r in runs["ranks"]] == [want] * RANKS
    assert runs["ranks"][0]["no_axis"] == "mesh has no axis 'streams': ('data',)"

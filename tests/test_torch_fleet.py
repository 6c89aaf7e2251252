"""The port's stacked fleet (cvsteer_tpu_torch.slam.vo_device.DeviceVOFleet)
against the JAX package's, on CPU, where its two halves (FT, FP) run
eagerly. vmap's fallback to a per-stream loop ("There is a performance
drop ...") is an error here: every op of the batched phases must have a
batching rule, or the card would run S times the kernels.

1. Functions: ``vo_core.predict_const_velocity`` against the reference's
   on carried states (both guards, the fallbacks); ``_fleet_promote`` on a
   stack of small maps (tests/test_torch_vo_device.py's) for random
   promote masks, caps and fair-serve offsets: the served set and the
   compaction equal to the JAX function's, and each served row's ring
   poses within 1e-3 (one BA iteration); one pipelined tick (FT then FP)
   started from the JAX fleet's own stacked state (carried over by
   utils/convert.device_map and fleet_aux), against the JAX tick.
2. The fleet: 2 streams of tests/test_vo.py's synthetic world over 25
   frames, classic (uncapped) and pipelined (promote_cap 1), against the
   JAX DeviceVOFleet on the same frames: equal frame ids and keyframes,
   poses within rotation 1e-5 and translation 5e-4 on every frame before
   the first promotion after initialization (past it the window BA
   amplifies float32 differences: trajectories, not bits), each ATE
   < 0.08. Both fleets start from one state: the JAX fleet bootstraps, the
   port's engines adopt its states (two-view RANSAC draws differ between
   the packages). Then pipelined against classic and promote_cap
   (tests/test_vo_device.py:704, 866) on those runs, and a fleet row's
   ground prior (the host path) against the JAX fleet's: the same
   corrections, ratios within 1e-4. tests/test_torch_fleet_streams.py has
   the reference's other fleet tests on the port.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_vo as ref  # the reference test's synthetic world
from cvsteer_tpu.features.frontend import Features as JFeatures
from cvsteer_tpu.geometry.camera import Intrinsics as JIntrinsics
from cvsteer_tpu.slam import vo_core as jvo_core
from cvsteer_tpu.slam import vo_device as jvd
from cvsteer_tpu.slam.vo import VOConfig as JVOConfig
from cvsteer_tpu_torch.slam import vo_core as tvo_core
from cvsteer_tpu_torch.slam import vo_device as tvd
from cvsteer_tpu_torch.slam.evaluate import ate_rmse
from cvsteer_tpu_torch.slam.vo import VOConfig
from cvsteer_tpu_torch.utils import convert
from test_torch_vo_device import BA, FX, CX, CY, TRACK, _jax_map, _small_map

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

CFG = dict(kf_max_gap=5, window=8, track_min_landmarks=30)
N_FRAMES = 25


def _cfg():
    return VOConfig(intrinsics=convert.intrinsics(ref.K), **CFG)


def _blank():
    z = jnp.zeros(ref.N_CAP)
    return JFeatures(yx=jnp.zeros((ref.N_CAP, 2)), score=z, theta=z,
                     level=jnp.zeros(ref.N_CAP, jnp.int32),
                     desc=jnp.zeros((ref.N_CAP, ref.DESC_DIM)), valid=jnp.zeros(ref.N_CAP, bool))


def _ticks(world_seed, rng_seed, n_streams, n_frames, blackout=(), join=False):
    """Per tick, each stream's JAX Features (None before stream s joins
    at tick s when ``join``), and the ground truth."""
    worlds = [ref._make_world(seed=world_seed + s) for s in range(n_streams)]
    rngs = [np.random.default_rng(rng_seed + s) for s in range(n_streams)]
    gt = [ref._gt_pose(k, n_frames) for k in range(n_frames)]
    ticks = []
    for k, (R, t) in enumerate(gt):
        row = []
        for s in range(n_streams):
            if s == 0 and k in blackout:
                row.append(_blank())
            elif join and k < s:
                row.append(None)
            else:
                row.append(ref._render_features(worlds[s][0], worlds[s][1], R, t, rngs[s]))
        ticks.append(row)
    return ticks, np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt])


def _port(tick):
    return [None if f is None else convert.features(f, device="cpu") for f in tick]


def _port_fleet(ticks, **kw):
    flt = tvd.DeviceVOFleet(_cfg(), n_streams=len(ticks[0]), device="cpu", **kw)
    for tick in ticks:
        flt.step(_port(tick))
    return flt, [flt.finalize(s) for s in range(len(ticks[0]))]


def _ate(state, gR, gt, offset=0):
    Rs, ts = state.poses()
    ids = [f + offset for f, _, _ in state.trajectory]
    return ate_rmse(Rs, ts, gR[ids], gt[ids])


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def _rot(axis, deg):
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def test_torch_predict_const_velocity_matches_jax():
    rng = np.random.default_rng(3)
    kfR, kft = _rot([0, 1, 0], 5.0), np.float32([0.1, 0.0, 0.2])
    R0, t0 = _rot([0, 1, 0], 7.0), np.float32([0.3, 0.01, 0.4])
    cases = {
        "constant velocity": (_rot([0, 1, 0], 9.0), np.float32([0.4, 0.02, 0.5]), 2),
        "one pose": (_rot([0, 1, 0], 9.0), np.float32([0.4, 0.02, 0.5]), 1),
        "rotation gate": (_rot([1, 0, 0], 45.0) @ R0, t0, 2),
        "shift gate": (R0, t0 + np.float32([20.0, 0, 0]), 2),
        "not finite": (R0, np.float32([np.nan, 0, 0]), 2),
        "random": (_rot(rng.normal(size=3) / np.sqrt(3), 12.0) @ R0,
                   t0 + rng.normal(0, 0.1, 3).astype(np.float32), 2),
    }
    for name, (R1, t1, n) in cases.items():
        args = (R1, t1, R0, t0, np.int32(n), kfR, kft)
        jR, jt = jvo_core.predict_const_velocity(*(jnp.asarray(a) for a in args))
        tR, tt = tvo_core.predict_const_velocity(*(torch.as_tensor(a) for a in args))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, err_msg=name)
        fell_back = np.array_equal(np.asarray(jt), kft)
        assert fell_back == (name not in ("constant velocity", "random")), name
    assert tvo_core.MAX_PRED_ROT_DEG == jvo_core.MAX_PRED_ROT_DEG
    assert tvo_core.MAX_PRED_SHIFT == jvo_core.MAX_PRED_SHIFT


PROMOTE_S = 4


@functools.lru_cache(maxsize=None)
def _promote_inputs():
    """A stack of PROMOTE_S small maps (each stream's frame tracked at a
    pose moved a little, so that every row's promotion differs) and the
    tracked frames, as numpy."""
    m, (yx, desc, valid), _ = _small_map()
    K = JIntrinsics(FX, FX, CX, CY)
    R3, t3 = m.kf_R[3], m.kf_t[3]
    tr = jax.jit(lambda *a: jvd._track_phase(*a, K=K, **TRACK))(
        _jax_map(m), jnp.asarray(yx), jnp.asarray(desc), jnp.asarray(valid),
        jnp.asarray(R3), jnp.asarray(t3), jnp.asarray(False),
    )
    S = PROMOTE_S
    stack = jvd.DeviceMap(*(None if a is None else np.stack([np.asarray(a)] * S) for a in m))
    tr_np = {f: np.stack([np.asarray(getattr(tr, f))] * S)
             for f in ("uv_new", "idx", "obs_pre", "R", "t")}
    tr_np["t"] = tr_np["t"] + np.float32(0.02) * np.arange(S, dtype=np.float32)[:, None]
    return stack, tr_np, np.stack([desc] * S), np.stack([valid] * S)


@functools.lru_cache(maxsize=None)
def _jax_fleet_promote(cap):
    return jax.jit(functools.partial(
        jvd._fleet_promote, ba_iterations=1, huber_delta=BA["huber_delta"], tri_angle=0.35,
        promote_cap=cap,
    ))


@pytest.mark.parametrize("cap", [0, 2])
def test_torch_fleet_promote_matches_jax(cap):
    stack, tr, desc, valid = _promote_inputs()
    S = PROMOTE_S
    jtr = jvd._TrackOut(**{f: jnp.asarray(a) for f, a in tr.items()},
                        n=None, n_valid=None, lost=None, promote=None, ground_h=None)
    io = SimpleNamespace(**{f: torch.from_numpy(np.array(a)) for f, a in tr.items()},
                         desc=torch.from_numpy(desc), fvalid=torch.from_numpy(valid))
    tstack = convert.device_map(stack, device="cpu")
    rng = np.random.default_rng(cap)
    masks = [np.ones(S, bool), np.zeros(S, bool)] + [rng.random(S) < 0.6 for _ in range(4)]
    for mask in masks:
        offset = int(rng.integers(0, S))
        jms, jserved, jcomp = _jax_fleet_promote(cap)(
            jvd.DeviceMap(*(None if a is None else jnp.asarray(a) for a in stack)),
            jnp.asarray(mask), jtr, jnp.asarray(desc), jnp.asarray(valid), None,
            jnp.int32(offset),
        )
        out, served, comp = tvd._fleet_promote(
            tstack, torch.from_numpy(mask), io, torch.tensor(offset, dtype=torch.int32),
            iterations=1, huber_delta=BA["huber_delta"], tri_angle=0.35, promote_cap=cap,
        )
        np.testing.assert_array_equal(served.numpy(), np.asarray(jserved))
        np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
        assert served.sum() == min(mask.sum(), cap or S)
        tm = dict(zip(tvd._carried(tstack), out))
        for f in ("kf_live", "kf_fvalid"):
            np.testing.assert_array_equal(tm[f].numpy(), np.asarray(getattr(jms, f)))
        for f in ("kf_R", "kf_t"):
            np.testing.assert_allclose(tm[f].numpy(), np.asarray(getattr(jms, f)), atol=1e-3)
        if not cap:
            continue
        # a sharded fleet: each half of the stack is one rank's, ranked
        # against the whole fleet's requests (gdo) from its first stream (lo)
        half, hserved = S // 2, []
        for lo in (0, half):
            sl = slice(lo, lo + half)
            hout, hs, _ = tvd._fleet_promote(
                type(tstack)(*(None if a is None else a[sl] for a in tstack)),
                torch.from_numpy(mask[sl]),
                SimpleNamespace(**{f: a[sl] for f, a in vars(io).items()}),
                torch.tensor(offset, dtype=torch.int32), iterations=1,
                huber_delta=BA["huber_delta"], tri_angle=0.35, promote_cap=cap,
                gdo=torch.from_numpy(mask), lo=lo,
            )
            hserved.append(hs.numpy())
            hm = dict(zip(tvd._carried(tstack), hout))
            for f in ("kf_live", "kf_fvalid"):
                np.testing.assert_array_equal(hm[f].numpy(), np.asarray(getattr(jms, f))[sl])
            for f in ("kf_R", "kf_t"):
                np.testing.assert_allclose(hm[f].numpy(), np.asarray(getattr(jms, f))[sl],
                                           atol=1e-3)
        np.testing.assert_array_equal(np.concatenate(hserved), np.asarray(jserved))


# ---------------------------------------------------------------------------
# the fleet against the JAX fleet
# ---------------------------------------------------------------------------


def _jax_kw(cfg, promote_cap):
    return dict(
        K=cfg.intrinsics, ratio=cfg.match_ratio, track_iters=10, huber_delta=cfg.huber_delta,
        min_track=cfg.track_min_landmarks, kf_max_gap=cfg.kf_max_gap,
        motion_model=cfg.motion_model, ba_iterations=cfg.ba_iterations,
        local_map=cfg.track_local_map, loop_min_gap=cfg.loop_min_gap,
        loop_cands=cfg.loop_max_candidates, tri_angle=cfg.tri_min_ray_angle_deg,
        rescue_radius=cfg.rescue_radius_norm, rescue_min_cos=cfg.rescue_min_cos,
        kf_min_flow=cfg.kf_min_flow_norm, ground_prior=cfg.ground_height_m > 0,
        promote_cap=promote_cap,
    )


SNAP_TICK = 7  # both streams ask to promote here; with cap 1 one defers


@pytest.fixture(scope="module")
def world():
    """The 2-stream stream of tests/test_vo_device.py's pipelined test."""
    return _ticks(50, 60, 2, N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    """The JAX and the port fleets on ``world``, classic (uncapped) and
    pipelined (promote_cap 1). Both start from one state: the JAX fleet
    bootstraps its streams on the host (two-view RANSAC draws differ
    between the packages), then each port engine adopts its JAX engine's
    state (utils/convert.vo_state) and both fleets step on. For the
    pipelined JAX fleet also its stacked state before tick SNAP_TICK and
    that tick's own output."""
    ticks, gR, gt = world
    out = dict(gR=gR, gt=gt)
    for name, kw in (("classic", {}), ("pipelined", dict(pipeline=True, promote_cap=1))):
        jcfg = JVOConfig(intrinsics=ref.K, **CFG)
        jf = jvd.DeviceVOFleet(jcfg, n_streams=2, **kw)
        flt = tvd.DeviceVOFleet(_cfg(), n_streams=2, device="cpu", **kw)
        start = None
        for k, tick in enumerate(ticks):
            if start is None and jf.active.all():
                start = k
                for eng, jeng in zip(flt.engines, jf.engines):
                    eng.adopt(convert.vo_state(jeng.state, device="cpu"))
            if name == "pipelined" and k == SNAP_TICK:
                prio = jf._promote_rr
                inputs = (jnp.ones(2, bool), *(jnp.stack([getattr(f, a) for f in tick])
                                                for a in ("yx", "desc", "valid")))
                res = jvd._fleet_step_pipe(jf.stack, jf.aux, *inputs, jnp.int32(prio),
                                           **_jax_kw(jcfg, 1))
                out["snap"] = jax.device_get((jf.stack, jf.aux, inputs, prio, res))
            jf.step(tick)
            if start is not None:
                flt.step(_port(tick))
        out[name] = [flt.finalize(s) for s in range(2)]
        out["jax_" + name] = [jf.finalize(s) for s in range(2)]
        out["start_" + name] = start
    return out


@pytest.mark.parametrize("mode", ["classic", "pipelined"])
def test_torch_fleet_matches_jax_fleet(runs, mode):
    start = runs["start_" + mode]
    assert start is not None and start < SNAP_TICK
    for s, (tst, jst) in enumerate(zip(runs[mode], runs["jax_" + mode])):
        assert [f for f, _, _ in tst.trajectory] == [f for f, _, _ in jst.trajectory]
        kfs = [kf.index for kf in tst.keyframes]
        assert kfs == [kf.index for kf in jst.keyframes], s
        first = kfs[2]  # the first promotion after the two-view initialization
        assert start < first
        (tR, tt), (jR, jt) = tst.poses(), jst.poses()
        dR = np.abs(tR[:first] - jR[:first]).max()
        dt = np.abs(tt[:first] - jt[:first]).max()
        ate = _ate(tst, runs["gR"], runs["gt"])
        print(f"parity fleet {mode} stream {s}: frames {start}-{first - 1} R {dR:.2e} t {dt:.2e};"
              f" ATE {ate:.4f} (JAX {_ate(jst, runs['gR'], runs['gt']):.4f})")
        assert dR < 1e-5 and dt < 5e-4, (s, dR, dt)
        assert ate < 0.08, (s, ate)


def test_torch_fleet_tick_from_jax_state_matches_jax(runs):
    """One pipelined tick (FT then FP, promote_cap 1) from the JAX fleet's
    own stacked map and control state before SNAP_TICK."""
    (jstack, jaux, inputs, prio, (jms, jaux2, jout)) = runs["snap"]
    flt = tvd.DeviceVOFleet(_cfg(), n_streams=2, pipeline=True, promote_cap=1, device="cpu")
    stack = convert.device_map(jstack, device="cpu")._replace(ground_hist=None)
    flt._ensure_stack(tvd.DeviceMap(*(None if a is None else a[0] for a in stack)))
    for dst, src in zip(flt.stack, stack):
        if dst is not None:
            dst.copy_(src)
    for dst, src in zip(flt.aux, convert.fleet_aux(jaux, device="cpu")):
        dst.copy_(src)
    io = flt._io
    for dst, src in zip((io.active, io.yx, io.desc, io.fvalid), inputs):
        dst.copy_(torch.as_tensor(np.array(src)))
    io.prio.fill_(prio)
    flt._run_half(0)
    flt._run_half(1)
    rows = flt._rows(io.t_out.numpy(), io.p_out.numpy())
    assert np.asarray(jout.promoted).tolist() == [r.promoted for r in rows]
    assert np.asarray(jout.promoted).sum() == 1  # the cap deferred one promoter
    assert np.asarray(jout.row_stream).tolist() == io.pipe_out.numpy()[
        2 * (flt._sizes["n_t"] + flt._sizes["n_p"]):][:1].tolist()
    for s, r in enumerate(rows):
        assert r.lost == bool(jout.lost[s]) and abs(r.n_tracked - int(jout.n_tracked[s])) <= 1
        np.testing.assert_allclose(r.R, np.asarray(jout.R[s]), atol=1e-4)
        np.testing.assert_allclose(r.t, np.asarray(jout.t[s]), atol=1e-4)
        if r.promoted:
            np.testing.assert_allclose(r.kf_R, np.asarray(jout.kf_R[s]), atol=1e-3)
            np.testing.assert_allclose(r.kf_t, np.asarray(jout.kf_t[s]), atol=1e-3)
    for f in ("traj_n", "since_kf", "block"):
        np.testing.assert_array_equal(getattr(flt.aux, f).numpy(), np.asarray(getattr(jaux2, f)))
    np.testing.assert_allclose(flt.aux.t1.numpy(), np.asarray(jaux2.t1), atol=1e-3)
    np.testing.assert_array_equal(flt.stack.kf_live.numpy(), np.asarray(jms.kf_live))


# ---------------------------------------------------------------------------
# the reference's fleet tests that need the JAX-started runs
# ---------------------------------------------------------------------------


def test_torch_fleet_pipelined_matches_classic(runs):
    for s, (sp, sc) in enumerate(zip(runs["pipelined"], runs["classic"])):
        assert sp.initialized and len(sp.trajectory) == len(sc.trajectory)
        ate_p, ate_c = (_ate(x, runs["gR"], runs["gt"]) for x in (sp, sc))
        assert ate_p < 0.08, f"stream {s}: pipelined ATE {ate_p:.4f} m"
        assert ate_p < max(2.5 * ate_c, 0.05), (s, ate_p, ate_c)
        assert abs(len(sp.keyframes) - len(sc.keyframes)) <= 2


def test_torch_fleet_promote_cap(world, runs):
    """One promotion a tick for 2 streams that ask together: the cap defers
    one, never drops it."""
    ticks, gR, gt = world
    _, capped = _port_fleet(ticks, promote_cap=1)
    for s, (a, b) in enumerate(zip(capped, runs["classic"])):
        assert _ate(a, gR, gt) < 0.08, s
        assert abs(len(a.keyframes) - len(b.keyframes)) <= 2
    # the deferral happened: the streams' keyframes differ in timing
    assert [kf.index for kf in capped[0].keyframes] != [kf.index for kf in capped[1].keyframes]


def test_torch_fleet_refusals():
    # a mesh whose axis does not divide the streams: the reference's words
    mesh = SimpleNamespace(mesh_dim_names=("data",), size=lambda dim: 2,
                           get_local_rank=lambda name: 0, get_group=lambda name: None,
                           device_type="cpu")
    with pytest.raises(ValueError, match=r"^n_streams=3 must divide over mesh axis data=2$"):
        tvd.DeviceVOFleet(_cfg(), n_streams=3, mesh=mesh, device="cpu")
    flt = tvd.DeviceVOFleet(_cfg(), n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="pipeline=True"):
        flt.step_batched(None, None, None)
    with pytest.raises(ValueError, match="frames for 2 streams"):
        flt.step([None])


def test_torch_fleet_ground_prior_matches_jax_fleet():
    """A fleet row's ground prior takes the host path in both packages (no
    in-step controller in a fleet): on tests/test_vo.py's 30-frame stream
    with ground_height_m 1.5, from one adopted post-bootstrap state, the
    port's 1-stream fleet makes the JAX fleet's corrections (the same
    frames, ratios within 1e-4) and keyframes, and both track (ATE < 0.08).
    The port hands the row over exactly when a correction applies
    (vo_device._ground_corrects)."""
    X, desc = ref._make_world()
    rng = np.random.default_rng(42)
    frames = [ref._render_features(X, desc, *ref._gt_pose(k, 30), rng) for k in range(30)]
    jcfg = JVOConfig(intrinsics=ref.K, **CFG, ground_height_m=1.5)
    jf = jvd.DeviceVOFleet(jcfg, n_streams=1)
    flt = tvd.DeviceVOFleet(convert.vo_config(jcfg), n_streams=1, device="cpu")
    jf.engines[0].state.diag = []
    for f in frames:
        if flt.engines[0].state.diag is None and jf.active.all():
            flt.engines[0].adopt(convert.vo_state(jf.engines[0].state, device="cpu"))
            flt.engines[0].state.diag = []
            start = len(jf.engines[0].state.diag)
        jf.step([f])
        if flt.engines[0].state.diag is not None:
            flt.step(_port([f]))
    a, b = flt.finalize(0), jf.finalize(0)
    ga = [(e["f"], e["r"]) for e in a.diag if e["ev"] == "ground"]
    gb = [(e["f"], e["r"]) for e in b.diag[start:] if e["ev"] == "ground"]
    print(f"parity fleet ground prior: {len(ga)} corrections / JAX {len(gb)}")
    assert gb and [f for f, _ in ga] == [f for f, _ in gb]
    np.testing.assert_allclose([r for _, r in ga], [r for _, r in gb], atol=1e-4)
    assert [kf.index for kf in a.keyframes] == [kf.index for kf in b.keyframes]
    gt = [ref._gt_pose(k, 30) for k in range(30)]
    gR, gT = np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt])
    assert _ate(a, gR, gT) < 0.08 and _ate(b, gR, gT) < 0.08

"""Order-4 VO: the port's host engine against the JAX host engine on the VO
scene of chip_smoke.py (PlanesSequence seed 0, the 40-frame path, 480x640,
default VOConfig with frontend.order = 4), on CPU.

Both engines take the same G4/H4 features, the reference's (the port's own
are held to them in tests/test_torch_vo_g4.py and
tests/test_torch_features_generic.py), and the port takes the reference's
RANSAC draws (jax.random.key(frame) through the reference's sampler,
injected as ``sets``):

1. The bootstrap (frame 3). Its RANSAC inputs are bit-equal in the two
   engines, and so are the draws; the fp32 eight-point solutions are not:
   the smallest eigenvector of the 9x9 normal matrix squares the minimal
   system's condition. A float64 witness (the SVD of each set's 8x9 row
   matrix, numpy) sides with neither package: each counts other inliers
   than float64 on about 190 of the 512 hypotheses, and the three argmaxes
   are three different hypotheses. The test holds the inputs and prints
   the witness and the parting.
2. Both engines from frame 0, every draw the float64 winner's set: the
   bootstrap's inliers equal the float64 RANSAC's (the port's
   ransac_essential in float64 on the reference's draws), its E is within
   1e-5 of that RANSAC's, and the two engines' bootstrap poses agree; then
   keyframes and tracked poses agree up to the first promotion.
3. From the JAX engine's state after its own bootstrap
   (utils/convert.vo_state) both engines step the next frames. The keyframe
   ids are held, and so is every tracked pose (the PnP result each engine
   hands to its keyframe decision, with its tracked count) up to and at the
   first promotion after initialization (rotation 1e-5, translation 5e-4,
   tests/test_torch_vo_device_options.py's bars). On this scene that
   promotion is the next frame: tracking sits at track_min_landmarks. The
   gap of the poses after the promotion's window BA is printed: that BA
   turns float32 differences into centimetres (ROADMAP §3).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.features.frontend import FrontendConfig as JConfig
from cvsteer_tpu.geometry import epipolar as jep
from cvsteer_tpu.slam import vo as jvo
from cvsteer_tpu_torch.io.render import PlanesSequence
from cvsteer_tpu_torch.slam import vo as tvo
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)
FRAMES = 6  # the bootstrap at frame 3, the first promotion after it at frame 4
WINNER_FRAMES = 8  # from the float64 winner's bootstrap the first promotion is at frame 7
JCFG = jvo.VOConfig(frontend=JConfig(order=4))
TH = JCFG.ransac_threshold


@pytest.fixture(scope="module")
def feats():
    seq = PlanesSequence(n_frames=40, image_hw=(480, 640), seed=0)  # chip_smoke's VO cell
    return [jvo._extract_features_jit(jnp.asarray(seq.render(k)), JCFG.frontend)
            for k in range(max(FRAMES, WINNER_FRAMES))]


@pytest.fixture()
def reference_draws(monkeypatch):
    """The port's bootstrap RANSAC takes the reference engine's draws for
    the same frame; both engines' RANSAC inputs are recorded."""
    seen = {}
    port_ransac, jax_ransac = tvo.ransac_essential, jvo.ransac_essential

    def port(p0, p1, v, gen, **kw):
        key = jax.random.key(gen.initial_seed())
        sets = np.array(jep._sample_minimal_sets(key, jnp.asarray(v.cpu().numpy()),
                                                 kw["num_hypotheses"], 8))
        seen["port"] = (p0.numpy().copy(), p1.numpy().copy(), v.numpy().copy(), sets)
        return port_ransac(p0, p1, v, None, sets=torch.from_numpy(sets), **kw)

    def ref(p0, p1, v, key, **kw):
        seen["jax"] = tuple(np.array(a) for a in (p0, p1, v))
        return jax_ransac(p0, p1, v, key, **kw)

    monkeypatch.setattr(tvo, "ransac_essential", port)
    monkeypatch.setattr(jvo, "ransac_essential", ref)
    return seen


@pytest.fixture()
def tracked(monkeypatch):
    """Each engine's tracked (R, t, n_tracked) per frame, as handed to its
    keyframe decision."""
    seen = {"port": {}, "jax": {}}
    for name, mod in (("port", tvo), ("jax", jvo)):
        def decide(state, feats, R, t, n_tracked, *a, _name=name, _orig=mod._decide_keyframe, **kw):
            seen[_name][state.frame_count] = (np.array(R), np.array(t), int(n_tracked))
            return _orig(state, feats, R, t, n_tracked, *a, **kw)
        monkeypatch.setattr(mod, "_decide_keyframe", decide)
    return seen


def _float64_scores(p0, p1, v, sets):
    """The float64 witness of the bootstrap's hypotheses, numpy alone: each
    minimal set solved by the SVD of its 8x9 row matrix, projected to an
    essential matrix and scored as both packages score (inlier count less
    the MSAC tie-break). Returns (counts [S], scores [S])."""
    h0 = np.concatenate([p0.astype(np.float64), np.ones((len(p0), 1))], 1)
    h1 = np.concatenate([p1.astype(np.float64), np.ones((len(p1), 1))], 1)
    A = (h1[sets][..., :, None] * h0[sets][..., None, :]).reshape(len(sets), 8, 9)
    e = np.linalg.svd(A)[2][:, -1].reshape(-1, 3, 3)
    U, S, Vt = np.linalg.svd(e)
    s = 0.5 * (S[:, 0] + S[:, 1])
    E = (U * np.stack([s, s, np.zeros_like(s)], -1)[:, None, :]) @ Vt
    Ep1 = h0 @ E.transpose(0, 2, 1)  # [S, N, 3]
    Etp2 = h1 @ E
    num = np.sum(h1 * Ep1, -1) ** 2
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return _scores(num / np.maximum(den, 1e-12), v)


def _scores(err, v):
    counts = ((err < TH) & v).sum(1)
    msac = np.where(v, np.minimum(err, TH), 0.0).sum(1)
    return counts, counts - msac / (TH * max(int(v.sum()), 1))


def _landmark_gaps(ts, js, p0, p1):
    """The bootstrap's landmarks in each engine against the float64 DLT
    (the packages' least-squares form with w = 1, numpy) of the same
    correspondences ``p0``, ``p1`` under the JAX engine's keyframe pose (the
    two engines' agree to 3e-7). Returns (count, port median, port max, JAX
    median, JAX max relative error, landmarks the port has closer)."""
    kf0, kf1 = js.keyframes[0], js.keyframes[1]
    feat = np.nonzero(np.asarray(kf0.landmark_ids) >= 0)[0]
    ids = np.asarray(kf0.landmark_ids)[feat]
    x1, x2 = p0[feat].astype(np.float64), p1[feat].astype(np.float64)
    P2 = np.concatenate([np.asarray(kf1.R, np.float64), np.asarray(kf1.t, np.float64)[:, None]], 1)
    P1 = np.eye(3, 4)
    A = np.stack([x1[:, :1] * P1[2] - P1[0], x1[:, 1:] * P1[2] - P1[1],
                  x2[:, :1] * P2[2] - P2[0], x2[:, 1:] * P2[2] - P2[1]], 1)
    B, c = A[..., :3], A[..., 3]  # the packages' inhomogeneous DLT, w = 1
    X = np.linalg.solve(np.einsum("nij,nik->njk", B, B), -np.einsum("nij,ni->nj", B, c)[..., None])
    X = X[..., 0]
    depth = np.linalg.norm(X, axis=1)
    et = np.linalg.norm(np.asarray(ts.landmarks)[ids] - X, axis=1) / depth
    ej = np.linalg.norm(np.asarray(js.landmarks)[ids] - X, axis=1) / depth
    return len(ids), np.median(et), et.max(), np.median(ej), ej.max(), int((et < ej).sum())


def _gaps(a, b):
    return (float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()),
            float(np.abs(np.asarray(a[2]) - np.asarray(b[2])).max()))


def test_torch_vo_g4_bootstrap_inputs_equal(feats, reference_draws):
    js = jvo.init_vo(JCFG)
    ts = tvo.init_vo(convert.vo_config(JCFG), device="cpu")
    for k in range(4):
        js = jvo.process_frame(js, feats[k])
        ts = tvo.process_frame(ts, convert.features(feats[k], device="cpu"))
    assert js.initialized and ts.initialized and js.frame_count == ts.frame_count == 4
    p0, p1, v, sets = reference_draws["port"]
    for got, want in zip((p0, p1, v), reference_draws["jax"]):
        np.testing.assert_array_equal(got, want)
    from cvsteer_tpu_torch.geometry import epipolar as tep

    w = torch.zeros((sets.shape[0], p0.shape[0]))
    w.scatter_(1, torch.from_numpy(sets).long(), 1.0)
    t_err = tep.sampson_error(tep.eight_point_essential(torch.from_numpy(p0), torch.from_numpy(p1), w),
                              torch.from_numpy(p0), torch.from_numpy(p1)).numpy()
    j_err = np.asarray(jax.vmap(lambda s: jep.sampson_error(
        jep.eight_point_essential(jnp.asarray(p0), jnp.asarray(p1),
                                  jnp.zeros(p0.shape[0]).at[s].set(1.0)),
        jnp.asarray(p0), jnp.asarray(p1)))(jnp.asarray(sets)))
    (ct, st), (cj, sj), (c64, s64) = _scores(t_err, v), _scores(j_err, v), _float64_scores(p0, p1, v, sets)
    dR, dt = _gaps(ts.trajectory[3], js.trajectory[3])
    print(f"\nparity order-4 bootstrap (frame 3): inputs and draws bit-equal; "
          f"{int((ct != cj).sum())} of {len(sets)} hypotheses count other inliers in the two "
          f"packages; against the float64 witness the port counts otherwise on "
          f"{int((ct != c64).sum())} (summed gap {int(np.abs(ct - c64).sum())}), JAX on "
          f"{int((cj != c64).sum())} (summed gap {int(np.abs(cj - c64).sum())}); the winning "
          f"hypothesis is {st.argmax()} (port, {ct[st.argmax()]} inliers), {sj.argmax()} (JAX, "
          f"{cj[sj.argmax()]}), {s64.argmax()} (float64, {c64[s64.argmax()]}); initial poses "
          f"part by R {dR:.2e}, t {dt:.3e} (not held)")


def test_torch_vo_g4_bootstrap_from_the_float64_winner(feats, monkeypatch, tracked):
    seen = {}
    port_ransac, jax_ransac, sample = tvo.ransac_essential, jvo.ransac_essential, jep._sample_minimal_sets

    def port(p0, p1, v, gen, **kw):
        sets = np.array(sample(jax.random.key(gen.initial_seed()), jnp.asarray(v.numpy()),
                               kw["num_hypotheses"], 8))
        win = sets[np.argmax(_float64_scores(p0.numpy(), p1.numpy(), v.numpy(), sets)[1])]
        seen["win"] = np.repeat(win[None], len(sets), 0)
        seen["pts"] = p0.numpy(), p1.numpy()
        seen["f64"] = port_ransac(p0.double(), p1.double(), v, None, sets=torch.from_numpy(sets), **kw)
        seen["port"] = port_ransac(p0, p1, v, None, sets=torch.from_numpy(seen["win"]), **kw)
        return seen["port"]

    def ref(*a, **kw):
        seen["jax"] = jax_ransac(*a, **kw)
        return seen["jax"]

    monkeypatch.setattr(tvo, "ransac_essential", port)
    monkeypatch.setattr(jvo, "ransac_essential", ref)
    monkeypatch.setattr(jep, "_sample_minimal_sets", lambda key, valid, n, k: jnp.asarray(seen["win"]))
    js = jvo.init_vo(JCFG)
    ts = tvo.init_vo(convert.vo_config(JCFG), device="cpu")
    for k in range(WINNER_FRAMES):
        ts = tvo.process_frame(ts, convert.features(feats[k], device="cpu"))  # the port first: it picks the set
        js = jvo.process_frame(js, feats[k])
        if k == 3:
            assert js.initialized and ts.initialized
            f64 = seen["f64"]
            for got in (seen["port"], seen["jax"]):
                np.testing.assert_array_equal(np.asarray(got.inliers), f64.inliers.numpy())
                np.testing.assert_allclose(np.asarray(got.E), f64.E.numpy(), rtol=0, atol=1e-5)
            boot = _gaps(ts.trajectory[3], js.trajectory[3])
            assert boot[0] < 1e-5 and boot[1] < 5e-4
            lm = _landmark_gaps(ts, js, *seen["pts"])
    jk, tk = [kf.index for kf in js.keyframes], [kf.index for kf in ts.keyframes]
    assert tk == jk
    promo = next(i for i in jk if i > 3)  # the first promotion after the bootstrap
    frames = range(4, promo + 1)
    assert [tracked["port"][f][2] for f in frames] == [tracked["jax"][f][2] for f in frames]
    dR = max(float(np.abs(tracked["port"][f][0] - tracked["jax"][f][0]).max()) for f in frames)
    dt = max(float(np.abs(tracked["port"][f][1] - tracked["jax"][f][1]).max()) for f in frames)
    print(f"\nparity order-4 from the float64 winner: bootstrap inliers {int(f64.num_inliers)} "
          f"equal to the float64 RANSAC's in both engines, E within "
          f"{max(float(np.abs(np.asarray(g.E) - f64.E.numpy()).max()) for g in (seen['port'], seen['jax'])):.1e}"
          f" of it, bootstrap poses within R {boot[0]:.1e}, t {boot[1]:.1e}; keyframes {jk}; "
          f"tracked counts {[tracked['port'][f][2] for f in frames]} in both; the bootstrap's "
          f"{lm[0]} landmarks against a float64 triangulation, median / max relative error: port "
          f"{lm[1]:.1e} / {lm[2]:.1e}, JAX {lm[3]:.1e} / {lm[4]:.1e}, port closer on {lm[5]}; so the "
          f"tracked poses of frames 4-{promo} part by R {dR:.1e}, t {dt:.1e} (printed)")


def test_torch_vo_g4_engines_agree_from_the_bootstrap(feats, reference_draws, tracked):
    js = jvo.init_vo(JCFG)
    for k in range(4):
        js = jvo.process_frame(js, feats[k])
    assert js.initialized
    ts = convert.vo_state(js, device="cpu")
    start = len(js.trajectory)
    for k in range(4, FRAMES):
        js = jvo.process_frame(js, feats[k])
        ts = tvo.process_frame(ts, convert.features(feats[k], device="cpu"))
    jk, tk = [kf.index for kf in js.keyframes], [kf.index for kf in ts.keyframes]
    assert tk == jk
    promo = next(i for i in jk if i >= start)  # the first promotion after the bootstrap
    held = [tracked["port"][f] for f in range(start, promo + 1)], [
        tracked["jax"][f] for f in range(start, promo + 1)]
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(*held))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(*held))
    assert [a[2] for a in held[0]] == [b[2] for b in held[1]]
    assert dR < 1e-5 and dt < 5e-4
    gaps = [_gaps(a, b) for a, b in zip(ts.trajectory, js.trajectory)]
    assert len(gaps) == FRAMES
    print(f"\nparity order-4 host engines from the JAX bootstrap: keyframes {jk}; tracked "
          f"poses of frames {start}-{promo} within R {dR:.1e}, t {dt:.1e} (tracked "
          f"{[a[2] for a in held[0]]}); after the promotion's window BA, frames {promo}-"
          f"{FRAMES - 1} part by R " + ", ".join(f"{g[0]:.2e}" for g in gaps[promo:])
          + ", t " + ", ".join(f"{g[1]:.2e}" for g in gaps[promo:]) + " (printed)")

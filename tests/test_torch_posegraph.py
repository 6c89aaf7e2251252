"""The port's Lie-group helpers and pose graphs (cvsteer_tpu_torch.slam.
lie_lanes, sim3, posegraph, posegraph_sim3) against the JAX package's, on
CPU, with the same seeded inputs.

- lie_lanes and sim3: within 1e-5 (log_so3 near pi included).
- optimize_pose_graph and optimize_pose_graph_sim3, dense and PCG, on the
  drift graphs of tests/test_posegraph.py and tests/test_sim3.py with the
  same iterations: final cost within 1e-4 relative, poses within 1e-3 m
  and 1e-3 rad (the largest rotation-matrix entry difference).
- The robust kernels' weights and costs within 1e-5 relative; the port's
  bucket padding (loopclosure._pad_pose_graph) keeps the cost and the
  solution, as the reference's own tests hold it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import test_posegraph as rpg  # the reference tests' drift graphs
import test_sim3 as rsim
from cvsteer_tpu.slam import lie_lanes as jll
from cvsteer_tpu.slam import posegraph as jpg
from cvsteer_tpu.slam import posegraph_sim3 as jps
from cvsteer_tpu.slam import se3 as jse3
from cvsteer_tpu.slam import sim3 as jsim3
from cvsteer_tpu_torch.slam import lie_lanes as tll
from cvsteer_tpu_torch.slam import posegraph as tpg
from cvsteer_tpu_torch.slam import posegraph_sim3 as tps
from cvsteer_tpu_torch.slam import sim3 as tsim3
from cvsteer_tpu_torch.slam.loopclosure import _pad_pose_graph as tpad
from cvsteer_tpu_torch.utils import convert

torch.set_num_threads(2)

TOL_LIE = 1e-5
TOL_COST = 1e-4  # relative
TOL_T, TOL_R = 1e-3, 1e-3  # m, rad


def _t(a):
    return torch.from_numpy(np.array(a))


def test_torch_lie_lanes_match_jax_including_near_pi():
    rng = np.random.default_rng(2)
    w = np.concatenate([
        rng.normal(0, 1.0, (48, 3)),
        rng.normal(0, 1e-6, (8, 3)),
        (np.pi - 1e-5) * rng.normal(0, 1, (8, 3))
        / np.linalg.norm(rng.normal(0, 1, (8, 3)), axis=1, keepdims=True),
    ]).astype(np.float32)
    xi = rng.normal(0, 0.8, (64, 6)).astype(np.float32)
    R_ref = jse3.exp_so3(jnp.asarray(w))
    lanes = lambda M: [M[:, k] for k in range(M.shape[1])]  # noqa: E731
    np.testing.assert_allclose(tll.exp_so3(_t(w)).numpy(),
                               jll.stack_mat(jll.exp_so3(lanes(jnp.asarray(w)))), atol=TOL_LIE)
    Rj, tj = jll.exp_se3(lanes(jnp.asarray(xi)))
    Rt, tt = tll.exp_se3(_t(xi))
    np.testing.assert_allclose(Rt.numpy(), jll.stack_mat(Rj), atol=TOL_LIE)
    np.testing.assert_allclose(tt.numpy(), jll.stack_vec(tj), atol=TOL_LIE)
    got = tll.log_so3(_t(R_ref)).numpy()
    ref = np.asarray(jll.stack_vec(jll.log_so3(jll.mat_lanes(R_ref))))
    print(f"parity lie_lanes: log_so3 max diff {np.abs(got - ref).max():.2e} (near pi included), "
          f"tolerance {TOL_LIE}")
    np.testing.assert_allclose(got, ref, atol=TOL_LIE)
    A, B = _t(R_ref[:8]), _t(R_ref[8:16])
    v = _t(xi[:8, :3])
    np.testing.assert_allclose(tll.matmul(A, B).numpy(), np.asarray(R_ref[:8] @ R_ref[8:16]),
                               atol=TOL_LIE)
    np.testing.assert_allclose(tll.matvec(A, v).numpy(),
                               np.einsum("eij,ej->ei", np.asarray(R_ref[:8]), xi[:8, :3]), atol=TOL_LIE)
    idx = np.array([3, 0, 5, 5], np.int32)
    np.testing.assert_array_equal(tll.onehot(_t(idx), 7).numpy(), np.asarray(jll.onehot(jnp.asarray(idx), 7)))


def test_torch_sim3_matches_jax():
    rng = np.random.default_rng(7)
    a, b = rsim._rand_sim3(rng), rsim._rand_sim3(rng)
    ta, tb = convert.sim3(a, "cpu"), convert.sim3(b, "cpu")
    X = rng.normal(0, 1, (5, 3)).astype(np.float32)
    xi = rng.normal(0, 0.5, (8, 7)).astype(np.float32)
    pairs = [
        (tsim3.compose(ta, tb), jsim3.compose(a, b)),
        (tsim3.invert(ta), jsim3.invert(a)),
        (tsim3.exp(_t(xi)), jsim3.exp(jnp.asarray(xi))),
        (tsim3.from_se3(ta.R, ta.t, ta.s), jsim3.from_se3(a.R, a.t, a.s)),
    ]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL_LIE)
    np.testing.assert_allclose(tsim3.transform(ta, _t(X)).numpy(),
                               np.asarray(jax.vmap(lambda x: jsim3.transform(a, x))(jnp.asarray(X))),
                               atol=TOL_LIE)
    np.testing.assert_allclose(tsim3.log(tsim3.exp(_t(xi))).numpy(),
                               np.asarray(jsim3.log(jsim3.exp(jnp.asarray(xi)))), atol=TOL_LIE)
    old, new = rsim._rand_sim3(rng), rsim._rand_sim3(rng)
    np.testing.assert_allclose(
        tps.apply_scale_correction(_t(X), convert.sim3(old, "cpu"), convert.sim3(new, "cpu")).numpy(),
        np.asarray(jps.apply_scale_correction(jnp.asarray(X), old, new)), atol=TOL_LIE)


def _compare(name, tout, jout):
    """Hold the port's (poses, stats) to the reference's; prints the gaps."""
    (tp, ts), (jp, js) = tout, jout
    jc, tc = float(js.cost), float(ts.cost)
    dt = float(np.abs(tp.t.numpy() - np.asarray(jp.t)).max())
    dr = float(np.abs(tp.R.numpy() - np.asarray(jp.R)).max())
    print(f"parity {name}: cost {float(js.initial_cost):.6g} -> jax {jc:.6g}, port {tc:.6g}; "
          f"poses {dt:.2e} m, {dr:.2e} rad apart (tolerances {TOL_COST} rel, {TOL_T} m, {TOL_R} rad)")
    assert tc < 0.5 * float(ts.initial_cost)
    assert abs(tc - jc) <= TOL_COST * max(abs(jc), 1e-9)
    assert dt < TOL_T and dr < TOL_R
    if hasattr(tp, "s"):
        np.testing.assert_allclose(tp.s.numpy(), np.asarray(jp.s), atol=TOL_T)


@pytest.fixture(scope="module")
def se3_world():
    P = 12
    gt = rpg._circle_trajectory(P)
    edges = [(k, k + 1) for k in range(P - 1)] + [(0, P - 1), (2, 7)]
    graph = rpg._graph_from_gt(gt, edges, meas_noise=0.01)
    return rpg._perturb(gt, 0.05), graph


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_torch_optimize_pose_graph_matches_jax(se3_world, solver):
    init, graph = se3_world
    kw = dict(iterations=8, solver=solver, cg_iterations=40)
    jout = jpg.optimize_pose_graph(init, graph, **kw)
    tout = tpg.optimize_pose_graph(convert.poses(init, "cpu"), convert.pose_graph(graph, "cpu"), **kw)
    _compare(f"optimize_pose_graph {solver}", tout, jout)


@pytest.mark.parametrize("kernel", ["huber", "tukey"])
def test_torch_robust_kernels_match_jax(kernel):
    """The IRLS weights and the robustified cost of both kernels, on
    residuals on both sides of the kernel width."""
    rng = np.random.default_rng(5)
    r = (rng.normal(0, 0.2, (40, 6)) * rng.uniform(0.1, 3.0, (40, 1))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    jr = [jnp.asarray(r[:, a]) for a in range(6)]
    got = tpg._robust_weight(_t(r), _t(w), 0.3, kernel).numpy()
    np.testing.assert_allclose(got, np.asarray(jpg._robust_weight(jr, jnp.asarray(w), 0.3, kernel)),
                               rtol=TOL_LIE, atol=1e-7)
    if kernel == "tukey":  # outliers past the cutoff get no weight, the others some
        assert (got == 0).any() and (got > 0).any()
    else:  # outliers are down-weighted, inliers keep their weight
        assert (got < w).any() and (got == w).any()
    sq = (r * r).sum(1)
    rn = np.sqrt(sq + 1e-20)
    if kernel == "tukey":  # the reference's cost formulas (posegraph.cost), in numpy
        rho = 0.81 / 6.0 * (1.0 - np.clip(1.0 - (rn / 0.9) ** 2, 0, 1) ** 3)
    else:
        rho = np.where(rn <= 0.3, 0.5 * sq, 0.3 * (rn - 0.15))
    np.testing.assert_allclose(float(tpg._robust_cost(_t(r), _t(w), 0.3, kernel)),
                               float((w * rho).sum()), rtol=TOL_LIE)


def test_torch_pose_graph_padding(se3_world):
    """Bucket padding keeps the cost, the real edges' residuals and the
    solution, dense and PCG (the check tests/test_lie_lanes.py makes of the
    reference's padding); the edge-sharded path raises until parallel/ is
    ported."""
    init, graph = se3_world
    tp_, tg = convert.poses(init, "cpu"), convert.pose_graph(graph, "cpu")
    pp, pg_, P_real = tpad(tp_, tg)
    assert P_real == 12 and pg_.fixed.shape[0] == 16 and pg_.i.shape[0] == 16
    np.testing.assert_allclose(float(tpg.cost(pp, pg_)), float(tpg.cost(tp_, tg)), rtol=1e-6)
    np.testing.assert_allclose(tpg.edge_residuals(pp, pg_).numpy()[: graph.i.shape[0]],
                               tpg.edge_residuals(tp_, tg).numpy(), atol=1e-6)
    ref, _ = tpg.optimize_pose_graph(tp_, tg, iterations=6)
    pad, _ = tpg.optimize_pose_graph(pp, pg_, iterations=6)
    np.testing.assert_allclose(pad.t.numpy()[:P_real], ref.t.numpy(), atol=1e-5)
    kw = dict(iterations=6, solver="pcg", cg_iterations=40)
    ref, _ = tpg.optimize_pose_graph(tp_, tg, **kw)
    pad, _ = tpg.optimize_pose_graph(pp, pg_, **kw)
    np.testing.assert_allclose(pad.t.numpy()[:P_real], ref.t.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="posegraph_sharded"):
        tpg.optimize_pose_graph(tp_, tg, axis_name="edges")


@pytest.fixture(scope="module")
def sim3_world():
    """tests/test_sim3.py::test_sim3_graph_corrects_scale_drift's chain:
    growing scale drift and pose noise, one scale-true closure."""
    rng = np.random.default_rng(4)
    P = 10
    gt = rsim._chain_world(P, rng)
    graph = rsim._graph_from(gt, [(k, k + 1) for k in range(P - 1)] + [(0, P - 1)])
    drift = []
    for k in range(P):
        xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.05, 3), [0.06 * k]])
        drift.append(np.zeros(7) if k == 0 else xi)
    init = jsim3.compose(jsim3.exp(jnp.asarray(np.stack(drift), jnp.float32)), gt)
    return init, graph


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_torch_optimize_pose_graph_sim3_matches_jax(sim3_world, solver):
    init, graph = sim3_world
    kw = dict(iterations=10, solver=solver, cg_iterations=60)
    jout = jps.optimize_pose_graph_sim3(init, graph, **kw)
    tout = tps.optimize_pose_graph_sim3(convert.sim3(init, "cpu"), convert.sim3_graph(graph, "cpu"), **kw)
    _compare(f"optimize_pose_graph_sim3 {solver}", tout, jout)
    ti, tg = convert.sim3(init, "cpu"), convert.sim3_graph(graph, "cpu")
    np.testing.assert_allclose(tps.edge_residuals(ti, tg).numpy(),
                               np.asarray(jps.edge_residuals(init, graph)), atol=TOL_LIE)

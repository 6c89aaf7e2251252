"""The port's landmark-sharded BA and edge-sharded pose graph
(cvsteer_tpu_torch.parallel.ba_sharded, posegraph_sharded) in one 4-rank
gloo world on the CPU: the reference's tests/test_parallel.py:87-131,
test_posegraph.py:161-189 and the collectives audit
(test_collectives_audit.py:61-107) on torch.distributed.

The parent builds the problems with the reference tests' generators (jax,
in the parent only) and runs the JAX functions; the ranks get numpy copies
and import no jax. Every case runs in the one world the module fixture
spawns:

- BA over {data: 4} (61 landmarks padded to 64), against the port's and
  JAX's single-device bundle_adjust at the reference's bar (rotation
  < 1e-3 rad, t within 1e-3: the shards' partial sums add in another order
  than one matmul), and pad_landmarks equal to JAX's; the placed inputs
  give the same result; over {data: 2, space: 2} the cost drops; an axis
  the mesh lacks is refused.
- BA's collectives, read from parallel.halo.record_collectives: per LM
  iteration exactly one all-reduce of C^2 36 + C 36 + 2 C 6 floats, one
  scalar all-reduce per cost, nothing else, the same lists at L = 64 and
  512; bundle_adjust_sharded adds one all-gather of X after the loop.
- The pose graph over {data: 4} (18 edges padded to 20) against the port's
  and JAX's single-device PCG (cost <= 1.05 x theirs + 1e-10, rotation
  < 2e-3 rad), pad_edges equal to JAX's, and an axis the mesh lacks
  refused.
- The pose graph's collectives at P = 32, E = 128 and 1,024, 5 LM x 10 CG
  iterations: one (b, Jacobi blocks) all-reduce of 6P + 36P floats per LM
  iteration, one [P, 6] per CG iteration, one scalar per cost.
"""

import numpy as np
import pytest
import torch

WORLD = 4
BA_ITERS, BA_AUDIT_ITERS, BA_AUDIT_C, BA_AUDIT_L = 15, 10, 6, (64, 512)
PGO_ITERS, PGO_CG = 12, 60
PGO_AUDIT_P, PGO_AUDIT_E, PGO_AUDIT_ITERS, PGO_AUDIT_CG = 32, (128, 1024), 5, 10


def _np_ba(problem, state):
    return (dict(uv=np.asarray(problem.uv), mask=np.asarray(problem.mask),
                 fixed_cameras=np.asarray(problem.fixed_cameras),
                 huber_delta=float(problem.huber_delta)),
            dict(R=np.asarray(state.R), t=np.asarray(state.t), X=np.asarray(state.X)))


def _np_graph(graph):
    return {f: np.asarray(a) for f, a in zip(graph._fields, graph)}


def _audit_graph(E):
    """tests/test_collectives_audit.py's random chain of P = 32 poses."""
    P = PGO_AUDIT_P
    rng = np.random.default_rng(0)
    t = rng.normal(0, 0.1, (P, 3)).astype(np.float32)
    i = rng.integers(0, P - 1, E).astype(np.int32)
    graph = dict(i=i, j=np.minimum(i + 1, P - 1).astype(np.int32),
                 R_z=np.broadcast_to(np.eye(3, dtype=np.float32), (E, 3, 3)).copy(),
                 t_z=rng.normal(0, 0.1, (E, 3)).astype(np.float32),
                 weight=np.ones(E, np.float32), fixed=np.arange(P) == 0)
    return graph, dict(R=np.broadcast_to(np.eye(3, dtype=np.float32), (P, 3, 3)).copy(), t=t)


def _rank_cases(rank, inputs):
    """Every case of this file on one rank."""
    import torch.distributed as dist

    from cvsteer_tpu_torch.parallel import halo, make_mesh
    from cvsteer_tpu_torch.parallel.ba_sharded import (
        bundle_adjust_sharded, pad_landmarks, place_ba_inputs,
    )
    from cvsteer_tpu_torch.parallel.mesh import mesh_axis
    from cvsteer_tpu_torch.parallel.posegraph_sharded import (
        optimize_pose_graph_sharded, pad_edges, place_pose_graph,
    )
    from cvsteer_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust
    from cvsteer_tpu_torch.slam.posegraph import PoseGraph, Poses, optimize_pose_graph

    def ba(p, s):
        prob = BAProblem(uv=torch.from_numpy(p["uv"]), mask=torch.from_numpy(p["mask"]),
                         fixed_cameras=torch.from_numpy(p["fixed_cameras"]),
                         huber_delta=p["huber_delta"])
        return prob, BAState(*(torch.from_numpy(s[k]) for k in ("R", "t", "X")))

    def pg(g, p):
        return (PoseGraph(*(torch.from_numpy(g[f]) for f in PoseGraph._fields)),
                Poses(torch.from_numpy(p["R"]), torch.from_numpy(p["t"])))

    def logged(fn):
        with halo.record_collectives() as log:
            out = fn()
        return out, log

    def arrays(nt):
        return {f: np.asarray(a) for f, a in zip(nt._fields, nt)}

    out = {"world": dist.get_world_size()}
    mesh = make_mesh({"data": WORLD}, "cpu")
    group = mesh_axis(mesh, "data")[2]

    prob, init = ba(*inputs["ba"])
    st, stats = bundle_adjust_sharded(init, prob, mesh, iterations=BA_ITERS)
    pst, pprob, L = place_ba_inputs(init, prob, mesh)
    pout, _ = bundle_adjust_sharded(pst, pprob, mesh, iterations=BA_ITERS)
    r = dict(state=arrays(st), cost=float(stats.cost), initial=float(stats.initial_cost),
             placed_L=L, placed_X=pout.X.numpy(), placed_shard=tuple(pprob.uv.shape))
    if rank == 0:
        single, sstats = bundle_adjust(init, prob, iterations=BA_ITERS)
        pp, ps, L0 = pad_landmarks(prob, init, WORLD)
        r.update(single=arrays(single), single_cost=float(sstats.cost),
                 padded=(arrays(pp), arrays(ps), L0))
    prob2, init2 = ba(*inputs["ba_2x2"])
    _, s2 = bundle_adjust_sharded(init2, prob2, make_mesh({"data": 2, "space": 2}, "cpu"),
                                  iterations=BA_AUDIT_ITERS)
    r["mesh_2x2"] = (float(s2.initial_cost), float(s2.cost))
    out["ba"] = r

    # an axis the mesh does not have is refused, never run unsharded
    graph, poses = pg(*inputs["pgo"])
    refusals = {
        "bundle_adjust_sharded": lambda m: bundle_adjust_sharded(init2, prob2, m,
                                                                 lm_axis="landmarks"),
        "place_ba_inputs": lambda m: place_ba_inputs(init2, prob2, m, lm_axis="landmarks"),
        "optimize_pose_graph_sharded": lambda m: optimize_pose_graph_sharded(
            poses, graph, m, edge_axis="edges"),
        "place_pose_graph": lambda m: place_pose_graph(graph, m, edge_axis="edges"),
    }
    out["refused"] = {}
    for name, call in refusals.items():
        try:
            call(mesh)
        except ValueError as e:
            out["refused"][name] = str(e)

    out["ba_audit"] = {}
    for L, (p, s) in inputs["ba_audit"].items():
        prob, init = ba(p, s)
        sst, sprob, _ = place_ba_inputs(init, prob, mesh)
        _, lm_log = logged(lambda: bundle_adjust(sst, BAProblem(*sprob), iterations=BA_AUDIT_ITERS,
                                                 group=group))
        _, whole_log = logged(lambda: bundle_adjust_sharded(init, prob, mesh,
                                                            iterations=BA_AUDIT_ITERS))
        out["ba_audit"][L] = (lm_log, whole_log)

    got, gstats = optimize_pose_graph_sharded(poses, graph, mesh, iterations=PGO_ITERS,
                                              cg_iterations=PGO_CG)
    placed = place_pose_graph(graph, mesh)
    pgot, _ = optimize_pose_graph_sharded(poses, placed, mesh, iterations=PGO_ITERS,
                                          cg_iterations=PGO_CG)
    r = dict(poses=arrays(got), cost=float(gstats.cost), placed_R=pgot.R.numpy(),
             placed_t=pgot.t.numpy(), placed_edges=int(placed.i.shape[0]))
    if rank == 0:
        single, sstats = optimize_pose_graph(poses, graph, iterations=PGO_ITERS, solver="pcg",
                                             cg_iterations=PGO_CG)
        r.update(single=arrays(single), single_cost=float(sstats.cost),
                 padded=arrays(pad_edges(graph, WORLD)))
    out["pgo"] = r

    out["pgo_audit"] = {}
    for E, (g, p) in inputs["pgo_audit"].items():
        graph, poses = pg(g, p)
        (_, s), log = logged(lambda: optimize_pose_graph_sharded(
            poses, graph, mesh, iterations=PGO_AUDIT_ITERS, cg_iterations=PGO_AUDIT_CG))
        out["pgo_audit"][E] = (log, float(s.initial_cost), float(s.cost))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from test_ba import _synthetic_ba
    from test_posegraph import _circle_trajectory, _graph_from_gt, _perturb

    from cvsteer_tpu_torch.parallel.launch import spawn_world

    def ba_case(**kw):
        problem, _, init = _synthetic_ba(pose_err=0.02, point_err=0.05, **kw)
        return problem, init

    problem, init = ba_case(C=5, L=61, drop=0.2)
    P = 16
    gt = _circle_trajectory(P)
    edges = [(k, k + 1) for k in range(P - 1)] + [(P - 1, 0), (3, 11), (0, 8)]
    graph = _graph_from_gt(gt, edges, meas_noise=0.01, seed=6)
    pinit = _perturb(gt, 0.04)
    inputs = dict(
        ba=_np_ba(problem, init), ba_2x2=_np_ba(*ba_case(C=4, L=64)),
        ba_audit={L: _np_ba(*ba_case(C=BA_AUDIT_C, L=L)) for L in BA_AUDIT_L},
        pgo=(_np_graph(graph), dict(R=np.asarray(pinit.R), t=np.asarray(pinit.t))),
        pgo_audit={E: _audit_graph(E) for E in PGO_AUDIT_E},
    )
    ranks = spawn_world(_rank_cases, WORLD, args=(inputs,), device_type="cpu",
                        workdir=str(tmp_path_factory.mktemp("world")))
    return dict(ranks=ranks, problem=problem, init=init, graph=graph, pinit=pinit)


def _geodesic(Ra, Rb):
    """Rotation angles between ``Ra`` and ``Rb`` [P, 3, 3] as 2 asin(|Ra -
    Rb|_F / 2 sqrt 2) in float64 (arccos of the float32 trace reads ~5e-4
    for equal matrices)."""
    d = np.linalg.norm((np.float64(Ra) - np.float64(Rb)).reshape(len(Ra), -1), axis=1)
    return 2 * np.arcsin(np.minimum(d / (2 * np.sqrt(2)), 1.0))


def test_torch_ba_sharded_matches_single(world):
    from cvsteer_tpu.parallel.ba_sharded import pad_landmarks as jpad
    from cvsteer_tpu.slam.ba import bundle_adjust as jbundle_adjust

    ranks = world["ranks"]
    r0 = ranks[0]["ba"]
    st = r0["state"]
    assert all(r["world"] == WORLD for r in ranks)
    assert st["X"].shape == (61, 3)
    assert r0["cost"] < 1e-8
    # every rank holds the same cameras and the same gathered X
    for r in ranks[1:]:
        for k in ("R", "t", "X"):
            np.testing.assert_array_equal(r["ba"]["state"][k], st[k])
    # the placed shards: 64 / 4 landmarks a rank, the same result uncropped
    assert r0["placed_L"] == 61 and r0["placed_shard"] == (5, 16, 2)
    np.testing.assert_array_equal(r0["placed_X"][:61], st["X"])
    jref, jstats = jbundle_adjust(world["init"], world["problem"], iterations=BA_ITERS)
    for name, ref in (("port single", r0["single"]),
                      ("jax single", dict(R=np.asarray(jref.R), t=np.asarray(jref.t)))):
        ang = _geodesic(st["R"], ref["R"]).max()
        dt = np.abs(st["t"] - ref["t"]).max()
        print(f"parity BA sharded over {{data: {WORLD}}} vs {name}: rotation {ang:.3e} rad, "
              f"t {dt:.3e}, cost {r0['cost']:.3e}")
        assert ang < 1e-3
        np.testing.assert_allclose(st["t"], ref["t"], atol=1e-3)
    # pad_landmarks element for element against JAX's
    pp, ps, L0 = r0["padded"]
    jp, js, jL = jpad(world["problem"], world["init"], WORLD)
    assert L0 == jL == 61
    for k in ("uv", "mask", "fixed_cameras"):
        np.testing.assert_array_equal(pp[k], np.asarray(getattr(jp, k)))
    for k in ("R", "t", "X"):
        np.testing.assert_array_equal(ps[k], np.asarray(getattr(js, k)))
    for name in ("bundle_adjust_sharded", "place_ba_inputs"):
        assert ranks[0]["refused"][name] == "mesh has no axis 'landmarks': ('data',)"
    c0, c1 = r0["mesh_2x2"]
    print(f"parity BA over {{data: 2, space: 2}}, lm_axis data: cost {c0:.3e} -> {c1:.3e}")
    assert c1 < c0


def test_torch_ba_sharded_collectives(world):
    """One packed all-reduce per LM iteration and one scalar per cost,
    whatever L; bundle_adjust_sharded adds one all-gather of X."""
    C, n = BA_AUDIT_C, BA_AUDIT_ITERS
    packed = C * C * 36 + C * 36 + 2 * C * 6
    assert packed == 1584
    for r in world["ranks"]:
        logs = {L: lm for L, (lm, _) in r["ba_audit"].items()}
        for L, (lm, whole) in r["ba_audit"].items():
            assert lm.count(("all_reduce", packed)) == n
            assert lm.count(("all_reduce", 1)) == n + 1
            assert len(lm) == 2 * n + 1, lm
            assert whole == lm + [("all_gather", L // WORLD * 3)]
        assert logs[64] == logs[512]
    lm = world["ranks"][0]["ba_audit"][64][0]
    print(f"parity BA collectives per rank, C = {C}, {n} LM iterations: "
          f"{lm.count(('all_reduce', packed))} x {packed} floats, "
          f"{lm.count(('all_reduce', 1))} scalars, at L = 64 and 512")


def test_torch_pgo_sharded_matches_single(world):
    from cvsteer_tpu.parallel.posegraph_sharded import pad_edges as jpad
    from cvsteer_tpu.slam.posegraph import optimize_pose_graph as jopt

    ranks = world["ranks"]
    r0 = ranks[0]["pgo"]
    got = r0["poses"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pgo"]["poses"]["R"], got["R"])
        np.testing.assert_array_equal(r["pgo"]["poses"]["t"], got["t"])
    assert r0["placed_edges"] == 5
    np.testing.assert_array_equal(r0["placed_R"], got["R"])
    np.testing.assert_array_equal(r0["placed_t"], got["t"])
    jref, jstats = jopt(world["pinit"], world["graph"], iterations=PGO_ITERS, solver="pcg",
                        cg_iterations=PGO_CG)
    for name, R, c in (("port single", r0["single"]["R"], r0["single_cost"]),
                       ("jax single", np.asarray(jref.R), float(jstats.cost))):
        ang = _geodesic(got["R"], R).max()
        print(f"parity PGO sharded over {{data: {WORLD}}} vs {name} PCG: cost {r0['cost']:.4e} "
              f"vs {c:.4e}, rotation {ang:.3e} rad")
        assert r0["cost"] <= 1.05 * c + 1e-10
        assert ang < 2e-3
    for name in ("optimize_pose_graph_sharded", "place_pose_graph"):
        assert ranks[0]["refused"][name] == "mesh has no axis 'edges': ('data',)"
    jp = jpad(world["graph"], WORLD)
    assert r0["padded"]["i"].shape == (20,)
    for f in jp._fields:
        np.testing.assert_array_equal(r0["padded"][f], np.asarray(getattr(jp, f)))


def test_torch_pgo_sharded_collectives(world):
    """Per LM iteration one (b, D) all-reduce of 6P + 36P floats, per CG
    iteration one of 6P, one scalar per cost: the same lists at E = 128
    and 1,024."""
    P, n, cg = PGO_AUDIT_P, PGO_AUDIT_ITERS, PGO_AUDIT_CG
    for r in world["ranks"]:
        logs = {}
        for E, (log, c0, c1) in r["pgo_audit"].items():
            assert log.count(("all_reduce", 42 * P)) == n
            assert log.count(("all_reduce", 6 * P)) == n * cg
            assert log.count(("all_reduce", 1)) == n + 1
            assert len(log) == n * (cg + 2) + 1, log
            assert c1 <= c0
            logs[E] = log
        assert logs[128] == logs[1024]
    print(f"parity PGO collectives per rank, P = {P}, {n} LM x {cg} CG: {n} x {42 * P}, "
          f"{n * cg} x {6 * P}, {n + 1} scalars, at E = 128 and 1,024")

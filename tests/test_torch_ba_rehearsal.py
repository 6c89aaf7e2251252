"""CPU rehearsal of window BA's two kernels (``kernels/csrc/ba_schur.cu``).

CUDA kernels cannot run on the CPU, so their decomposition is rehearsed here
in PyTorch with the launch shape the wrapper computes
(``ops/cuda_ba.launch_shape``) and the constants read from the source:

- kernel ``ba_schur``: per block (a problem, a chunk of sub-chunks of ``lb``
  columns, an 8 x 8-camera tile of S) each column's H_ll summed over the
  cameras in order and inverted, the tile's partial product W H^-1 W^T over
  the sub-chunks, the diagonal tiles' camera sums per observation slot,
  then summed over the slots; the partials summed in chunk order;
- kernel ``ba_update``: the new poses, the back-substitution of each
  sub-chunk's columns (J_l^T J_c dx summed over the cameras in order), the
  cost per observation slot, per block, then in chunk order.

Both are held against slam.ba's plain pieces (``reduced_system``,
``back_substitute``, ``apply_updates``, ``cost``): float64 to 1e-10, float32
to 1e-4 of the largest magnitude against float64. Registered as the custom
ops' CPU kernels, they also carry ``bundle_adjust``'s kernel path on the CPU:
the glue between the kernels (damping, gauge, solve, accept), the vmap rule
that folds the vmapped problems into one launch an iteration, and the count
of launches.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from cvsteer_tpu_torch.ops import cuda_ba
from cvsteer_tpu_torch.slam import ba, se3
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState

CSRC = os.path.join(os.path.dirname(ba.__file__), "..", "kernels", "csrc", "ba_schur.cu")
F32_BOUND = 1e-4


def _constants() -> dict:
    with open(CSRC) as f:
        text = f.read()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_torch_ba_rehearsal_constants_match_the_source():
    k = _constants()
    assert (k["kThreads"], k["kMaxLb"], k["kTileCams"], k["kCamSums"], k["kLm"]) == (
        cuda_ba.THREADS, cuda_ba.MAX_LB, cuda_ba.TILE_CAMS, cuda_ba.CAM_SUMS, cuda_ba.LM_FLOATS)


def test_torch_kernel_entry_points_have_signatures():
    """Every C entry point of the kernel sources has its ctypes argument
    list in kernels._SIGNATURES, one type a parameter (ctypes cannot pass a
    Python float or a pointer without one)."""
    from cvsteer_tpu_torch import kernels

    found = {}
    for path in kernels._sources():
        with open(path) as f:
            for name, params in re.findall(r"CVS_EXPORT int (cvs_\w+)\(([^)]*)\)", f.read()):
                found[name] = len([p for p in params.split(",") if p.strip()])
    found.pop("cvs_probe_mma_config")  # the tile sweep's query, called with byref ints alone
    assert found and {n: len(kernels._SIGNATURES.get(n, ())) for n in found} == found


@pytest.mark.parametrize("B,C,L", [(16, 8, 4096), (1, 8, 4096), (1, 2, 10), (3, 11, 500),
                                   (2, 8, 0)])
def test_torch_ba_launch_shape_covers_every_column(B, C, L):
    s = cuda_ba.launch_shape(B, C, L)
    assert 1 <= s.lb <= cuda_ba.MAX_LB and s.lb * C <= cuda_ba.THREADS
    assert s.nchunk * s.sub * s.lb >= L and (s.nchunk - 1) * s.sub * s.lb < max(L, 1)
    assert s.nchunk <= cuda_ba.MAX_CHUNKS and s.tiles == -(-C // cuda_ba.TILE_CAMS)
    if L >= 4096:  # B = 1 still spreads over the card; the fleet's B = 16 fills it
        assert B * s.nchunk * s.tiles ** 2 >= 64


# ---------------------------------------------------------------------------
# the kernels' decomposition
# ---------------------------------------------------------------------------


def _upper(M):
    """A [..., 6, 6] matrix's upper triangle, rows in order -> [..., 21]."""
    i, j = torch.triu_indices(6, 6)
    return M[..., i, j]


def _weighted(R, t, X, uv, m, huber):
    """sqrt(w) J_c [C, n, 2, 6], sqrt(w) J_l [C, n, 2, 3], sqrt(w) r [C, n, 2]."""
    Jc, Jl, r, w = ba._jacobians(BAState(R, t, X), BAProblem(uv, m, None, huber))
    sw = torch.sqrt(w)[..., None]
    return Jc * sw[..., None], Jl * sw[..., None], r * sw


def _blocks(L, shape):
    """(chunk, [(l0, nl) of its sub-chunks])."""
    for ch in range(shape.nchunk):
        subs = []
        for s in range(shape.sub):
            l0 = (ch * shape.sub + s) * shape.lb
            if l0 >= L:
                break
            subs.append((l0, min(shape.lb, L - l0)))
        yield ch, subs


def schur_rehearsal(R, t, X, uv, mask, lam, huber_delta):
    """Kernel ba_schur over B problems -> (S, bs, Hcc, bc, lm)."""
    B, C = R.shape[:2]
    L = X.shape[1]
    shape = cuda_ba.launch_shape(B, C, L)
    n6, nt, tc = 6 * C, shape.tiles, cuda_ba.TILE_CAMS
    S, bs = R.new_empty((B, C, 6, C, 6)), R.new_empty((B, C, 6))
    Hcc, bc = R.new_empty((B, C, 6, 6)), R.new_empty((B, C, 6))
    lm = R.new_empty((B, L, cuda_ba.LM_FLOATS))
    for b in range(B):
        part = R.new_zeros((shape.nchunk, n6 * n6 + cuda_ba.CAM_SUMS * C))
        for ch, subs in _blocks(L, shape):
            for tile in range(nt * nt):
                ti, tj = divmod(tile, nt)
                ci, cj = slice(tc * ti, min(tc * ti + tc, C)), slice(tc * tj, min(tc * tj + tc, C))
                acc = R.new_zeros((6 * (ci.stop - ci.start), 6 * (cj.stop - cj.start)))
                slots = R.new_zeros((C, shape.lb, cuda_ba.CAM_SUMS))  # a thread's camera sums
                for l0, nl in subs:
                    cols = slice(l0, l0 + nl)
                    Jc, Jl, r = _weighted(R[b], t[b], X[b, cols], uv[b, :, cols], mask[b, :, cols],
                                          huber_delta)
                    terms = torch.einsum("cnak,cnam->cnkm", Jl, Jl)
                    bl_terms = -torch.einsum("cnak,cna->cnk", Jl, r)
                    H, b_l = terms[0], bl_terms[0]
                    for c in range(1, C):  # over the cameras in order
                        H, b_l = H + terms[c], b_l + bl_terms[c]
                    Hinv = ba._inv3(H, lam[b])
                    y = torch.einsum("nkj,nj->nk", Hinv, b_l)
                    if tile == 0:
                        lm[b, cols] = torch.cat([Hinv.reshape(nl, 9), b_l], 1)
                    W = torch.einsum("cnai,cnak->cnik", Jc, Jl)
                    A = torch.einsum("cnik,nkm->cnim", W, Hinv)
                    sA = A[ci].permute(1, 3, 0, 2).reshape(nl * 3, -1)  # rows (column, k)
                    sW = W[cj].permute(1, 3, 0, 2).reshape(nl * 3, -1)
                    acc = acc + sA.T @ sW
                    if ti == tj:
                        slots[ci, :nl] += torch.cat([
                            _upper(torch.einsum("cnai,cnaj->cnij", Jc[ci], Jc[ci])),
                            -torch.einsum("cnai,cna->cni", Jc[ci], r[ci]),
                            torch.einsum("cnik,nk->cni", W[ci], y)], -1)
                p = part[ch, : n6 * n6].view(n6, n6)
                p[6 * ci.start:6 * ci.stop, 6 * cj.start:6 * cj.stop] = acc
                if ti == tj:
                    cam = slots[ci, 0]
                    for q in range(1, shape.lb):  # over the slots in order
                        cam = cam + slots[ci, q]
                    part[ch, n6 * n6:].view(C, -1)[ci] = cam
        total = part[0]
        for ch in range(1, shape.nchunk):  # the last block: in chunk order
            total = total + part[ch]
        S[b] = -total[: n6 * n6].view(C, 6, C, 6)
        cam = total[n6 * n6:].view(C, cuda_ba.CAM_SUMS)
        i, j = torch.triu_indices(6, 6)
        Hcc[b, :, i, j] = cam[:, :21]
        Hcc[b, :, j, i] = cam[:, :21]
        bc[b], bs[b] = cam[:, 21:27], cam[:, 27:]
    return S, bs, Hcc, bc, lm


def update_rehearsal(R, t, X, uv, mask, huber_delta, dx=None, fixed=None, lm=None):
    """Kernel ba_update over B problems -> (Rn, tn, Xn, cost); without dx the
    cost of (R, t, X)."""
    B, C = R.shape[:2]
    L = X.shape[1]
    shape = cuda_ba.launch_shape(B, C, L)
    step = dx is not None
    Rn, tn, Xn = (a.clone() for a in (R, t, X))
    cost = R.new_empty((B,))
    for b in range(B):
        if step:
            free = (~fixed[b]).to(R.dtype)[:, None]
            Rn[b] = se3.exp_so3(dx[b, :, :3] * free) @ R[b]
            tn[b] = t[b] + dx[b, :, 3:] * free
        part = R.new_zeros(shape.nchunk)
        for ch, subs in _blocks(L, shape):
            slots = R.new_zeros((C, shape.lb))
            for l0, nl in subs:
                cols = slice(l0, l0 + nl)
                if step:
                    Jc, Jl, _ = _weighted(R[b], t[b], X[b, cols], uv[b, :, cols], mask[b, :, cols],
                                          huber_delta)
                    g = torch.einsum("cnak,cna->cnk", Jl, torch.einsum("cnai,ci->cna", Jc, dx[b]))
                    gs = g[0]
                    for c in range(1, C):
                        gs = gs + g[c]
                    m = lm[b, cols]
                    rhs = m[:, 9:] - gs
                    dX = torch.einsum("nkj,nj->nk", m[:, :9].view(nl, 3, 3), rhs)
                    Xn[b, cols] = X[b, cols] + dX
                rr, w = ba.residuals(BAState(Rn[b], tn[b], Xn[b, cols]),
                                     BAProblem(uv[b, :, cols], mask[b, :, cols], None, huber_delta))
                slots[:, :nl] += w * (rr[..., 0] ** 2 + rr[..., 1] ** 2)
            part[ch] = slots.sum()
        total = part[0]
        for ch in range(1, shape.nchunk):
            total = total + part[ch]
        cost[b] = 0.5 * total
    return (Rn, tn, Xn, cost) if step else (None, None, None, cost)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def _problem(C, L, seed, dtype, huber=0.0, lam=1e-3):
    """chip_smoke's BA world (tests/test_ba.py's scene) with cameras 0 and 1
    fixed, one column masked whole and one dead (X = 0, unobserved)."""
    w = chip_smoke.ba_world(C, L, seed)
    mask = w["mask"].copy()
    mask[:, 1] = False
    X0 = w["X0"].copy()
    mask[:, L // 2], X0[L // 2] = False, 0.0
    fixed = np.arange(C) < 2
    T = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)  # noqa: E731
    return (BAState(T(w["R0"]), T(w["t0"]), T(X0)),
            BAProblem(T(w["uv"]), torch.as_tensor(mask), torch.as_tensor(fixed), huber),
            torch.tensor(lam, dtype=dtype))


def _batch(problems):
    states, probs, lams = zip(*problems)
    st = BAState(*(torch.stack(a) for a in zip(*states)))
    return (st, torch.stack([p.uv for p in probs]),
            torch.stack([p.mask for p in probs]).to(st.X.dtype),
            torch.stack([p.fixed_cameras for p in probs]), torch.stack(lams), probs[0].huber_delta)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


CASES = [(8, 70, 0.0), (3, 41, 0.02), (10, 37, 0.0)]  # C 10: 2 x 2 tiles, lb 25


@pytest.mark.parametrize("C,L,huber", CASES)
def test_torch_ba_rehearsal_equals_plain_pieces(C, L, huber):
    """Both kernels' decomposition against reduced_system, back_substitute,
    apply_updates and cost: float64 to 1e-10, float32 to 1e-4 of the largest
    magnitude of the float64 plain values."""
    truth, got32 = None, None
    for dtype in (torch.float64, torch.float32):
        probs = [_problem(C, L, s, dtype, huber, lam) for s, lam in ((1, 1e-3), (2, 10.0))]
        st, uv, mask, fixed, lams, hd = _batch(probs)
        S, bs, Hcc, bc, lm = schur_rehearsal(*st, uv, mask, lams, hd)
        plain, mine = [], []
        for b, (state, problem, lam) in enumerate(probs):
            H_cc, H_ll, W, b_c, b_l = ba._normal_equations(state, problem)
            fx = problem.fixed_cameras
            S_p, bs_p, Hinv_p = ba.reduced_system(H_cc, H_ll, W, b_c, b_l, lam, fx)
            S_k, bs_k = ba._camera_system(S[b], bs[b], Hcc[b], bc[b], lam, fx, None)
            dx = ba.solve_reduced_dense(S_p, bs_p)
            cand = ba.apply_updates(state, dx, ba.back_substitute(W, Hinv_p, b_l, dx),
                                    problem.fixed_cameras)
            plain.append([S_p, bs_p, H_cc, b_c, Hinv_p, b_l, *cand, ba.cost(cand, problem)])
            Rn, tn, Xn, c = update_rehearsal(*(a[b:b + 1] for a in (*st, uv, mask)), hd,
                                             dx[None], fixed[b:b + 1], lm[b:b + 1])
            mine.append([S_k, bs_k, Hcc[b], bc[b], lm[b, :, :9].view(-1, 3, 3), lm[b, :, 9:],
                         Rn[0], tn[0], Xn[0], c[0]])
            c0 = update_rehearsal(*(a[b:b + 1] for a in (*st, uv, mask)), hd)[3][0]
            mine[-1].append(c0)
            plain[-1].append(ba.cost(state, problem))
        if dtype == torch.float64:
            truth = plain
            for p, m in zip(plain, mine):
                for a, b in zip(m, p):
                    assert _rel(a, b) <= 1e-10
        else:
            got32 = mine
    for p, m in zip(truth, got32):
        for a, b in zip(m, p):
            assert _rel(a.double(), b) <= F32_BOUND


# ---------------------------------------------------------------------------
# bundle_adjust's kernel path on the CPU (the rehearsals as the ops' kernels)
# ---------------------------------------------------------------------------

CALLS = {"schur": 0, "update": 0}


def _counted(name, fn):
    def run(*args):
        CALLS[name] += 1
        return fn(*args)
    return run


#: the rehearsals as the ops' CPU kernels (kept referenced: the
#: registrations live as long as this library object)
CPU_KERNELS = torch.library.Library("cvsteer", "IMPL")
CPU_KERNELS.impl("ba_schur", _counted("schur", schur_rehearsal), "CPU")


def _update_op(R, t, X, uv, mask, dx, fixed, lm, h):
    """ba_update's outputs: without a step the state's are empty ([B, 0])."""
    Rn, tn, Xn, c = update_rehearsal(R, t, X, uv, mask, h, dx, fixed, lm)
    if dx is None:
        Rn, tn, Xn = (a.new_empty((a.shape[0], 0)) for a in (R, t, X))
    return Rn, tn, Xn, c


CPU_KERNELS.impl("ba_update", _counted("update", _update_op), "CPU")


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(ba, "_fused", lambda state, problem: True)
    for k in CALLS:
        CALLS[k] = 0
    return CALLS


@pytest.mark.parametrize("huber", [0.0, 0.02])
def test_torch_ba_kernel_path_equals_plain_bundle_adjust(kernel_path, huber):
    """float64: the whole kernel path within 1e-9 of the plain path; one
    launch of each kernel an iteration, ba_update once more for the initial
    cost."""
    state, problem, _ = _problem(8, 70, 3, torch.float64, huber)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ba, "_fused", lambda s, p: False)
        want, wstats = ba.bundle_adjust(state, problem, iterations=6)
    got, gstats = ba.bundle_adjust(state, problem, iterations=6)
    assert kernel_path == {"schur": 6, "update": 7}
    for a, b in zip((*got, gstats.cost, gstats.lambda_final),
                    (*want, wstats.cost, wstats.lambda_final)):
        assert _rel(a, b) <= 1e-9
    assert float(gstats.cost) < float(gstats.initial_cost)


def test_torch_ba_kernel_path_vmap_is_one_launch_for_all_problems(kernel_path):
    """vmap over three problems (the fleet's stacking): each kernel launched
    once an iteration for all three, equal to the problems one at a time and
    to the batch written out (the folded ops called directly)."""
    probs = [_problem(8, 45, s, torch.float64, 0.02, 1e-4) for s in (4, 5, 6)]
    st, uv, mask, fixed, _, hd = _batch(probs)

    def one(R, t, X, uv, mask, fixed):
        out, stats = ba.bundle_adjust(BAState(R, t, X), BAProblem(uv, mask, fixed, hd),
                                      iterations=4)
        return (*out, stats.cost)

    got = torch.func.vmap(one)(*st, uv, mask, fixed)
    assert kernel_path == {"schur": 4, "update": 5}
    for b, (state, problem, _) in enumerate(probs):
        want = one(*state, problem.uv, problem.mask, problem.fixed_cameras)
        for a, w in zip(got, want):
            assert _rel(a[b], w) <= 1e-12
    # the written-out batch: the vmap rule folds exactly this
    lam = torch.full((3,), 1e-4, dtype=torch.float64)
    S, bs, Hcc, bc, lm = torch.ops.cvsteer.ba_schur(*st, uv, mask, lam, hd)
    S1 = torch.func.vmap(lambda R, t, X, uv, m, lam: cuda_ba.schur(R, t, X, uv, m, lam, hd)[0])(
        *st, uv, mask, lam)
    assert torch.equal(S, S1)


SHARDED_ITERS = 6


def _sharded_rank(rank, state, problem):
    """One rank of a 2-rank gloo world: bundle_adjust_sharded over {data: 2}
    on the kernels' path (the rehearsals as the ops' CPU kernels), with the
    launches it made on this rank."""
    from cvsteer_tpu_torch.parallel import make_mesh
    from cvsteer_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded

    ba._fused = lambda s, p: True
    for k in CALLS:
        CALLS[k] = 0
    out, stats = bundle_adjust_sharded(state, problem, make_mesh({"data": 2}, "cpu"),
                                       iterations=SHARDED_ITERS)
    return dict(state=tuple(out), cost=stats.cost, initial=stats.initial_cost,
                lam=stats.lambda_final, calls=dict(CALLS))


def test_torch_ba_kernel_path_sharded_equals_unsharded(kernel_path, tmp_path):
    """Landmark-sharded BA through the kernels' path (the camera sums
    all-reduced between ba_schur and the damping): two gloo ranks, 71
    columns padded to 72, within 1e-9 of the unsharded kernel path in
    float64 (the shards' sums add in another order), the cameras the same
    on both ranks, one launch of each kernel an iteration on each rank."""
    from cvsteer_tpu_torch.parallel.launch import spawn_world

    state, problem, _ = _problem(6, 71, 7, torch.float64, 0.02)
    want, wstats = ba.bundle_adjust(state, problem, iterations=SHARDED_ITERS)
    ranks = spawn_world(_sharded_rank, 2, args=(state, problem), device_type="cpu",
                        workdir=str(tmp_path))
    for r in ranks:
        assert r["calls"] == {"schur": SHARDED_ITERS, "update": SHARDED_ITERS + 1}
        for a, b in zip((*r["state"], r["cost"], r["initial"], r["lam"]),
                        (*want, wstats.cost, wstats.initial_cost, wstats.lambda_final)):
            assert _rel(a, b) <= 1e-9
    for a, b in zip(ranks[0]["state"][:2], ranks[1]["state"][:2]):
        assert torch.equal(a, b)
    assert float(wstats.cost) < float(wstats.initial_cost)


def test_torch_chip_smoke_counts_whole_ba_runs():
    """chip_smoke's window-BA launch check: whole runs of the default
    configuration's LM iterations, and nothing else."""
    from cvsteer_tpu_torch.slam.vo import VOConfig

    assert chip_smoke.VO_BA_ITERS == VOConfig().ba_iterations
    it = chip_smoke.VO_BA_ITERS
    assert chip_smoke.ba_runs({"ba_schur": 3 * it, "ba_update": 3 * it + 3}, it) == 3
    assert chip_smoke.ba_runs({}, it) == 0
    assert chip_smoke.ba_runs({"ba_schur": it, "ba_update": it}, it) == -1
    assert chip_smoke.ba_runs({"ba_schur": it + 1, "ba_update": it + 2}, it) == -1

"""Window BA's kernels (``kernels/csrc/ba_schur.cu``, ``ops/cuda_ba.py``) on
the card, held against slam.ba's plain code in float64.

Every test here is marked ``cuda`` and skips without a card. On a GPU
machine with PyTorch only:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_ba.py
"""

import math

import pytest
import torch

import chip_smoke
from cvsteer_tpu_torch import kernels
from cvsteer_tpu_torch.ops import cuda_ba
from cvsteer_tpu_torch.slam import ba
from cvsteer_tpu_torch.slam.ba import BAProblem, BAState
from cvsteer_tpu_torch.slam.vo_device import _capture_math

pytestmark = pytest.mark.cuda

BOUND = 1e-4  # of the largest magnitude of the float64 plain value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("B,C,L", [(1, 8, 4096), (16, 8, 4096), (1, 2, 4096), (16, 2, 1037),
                                   (3, 8, 1037), (2, 11, 700)])
def test_torch_cuda_ba_schur_matches_float64(cuda, B, C, L):
    """Kernel ba_schur's S, bs_lm, H_cc, b_c, H_ll^-1 and b_l against the
    plain pieces in float64, per problem (each with its own lambda and fixed
    cameras), within 1e-4 of each piece's largest magnitude."""
    T = chip_smoke.ba_batch(B, C, L)
    F = chip_smoke.ba_f32(T)
    before = kernels.launch_counts()["ba_schur"]
    S, bs, Hcc, bc, lm = torch.ops.cvsteer.ba_schur(
        *(F[k] for k in ("R", "t", "X", "uv", "mask", "lam")), 0.01)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ba_schur"] == before + 1
    want = chip_smoke.ba_plain_schur(*(T[k] for k in ("R", "t", "X", "uv", "mask", "lam")), 0.01)
    for b in range(B):
        got = [S[b], bs[b], Hcc[b], bc[b], lm[b, :, :9].view(L, 3, 3), lm[b, :, 9:]]
        wb = [w[b] for w in want[:6]]
        live = T["mask"][b].any(0)  # H_ll^-1 of the unobserved columns is I / lambda
        got[4], wb[4] = got[4][live], wb[4][live]
        for name, g, w in zip(("S", "bs_lm", "H_cc", "b_c", "Hinv", "b_l"), got, wb):
            assert _rel(g, w) <= BOUND, (b, name, _rel(g, w))


@pytest.mark.parametrize("B,C,L", [(1, 8, 4096), (16, 8, 4096), (4, 2, 1037), (2, 11, 700)])
def test_torch_cuda_bundle_adjust_matches_float64(cuda, B, C, L):
    """The whole float32 bundle_adjust (the kernels' path, vmapped over B
    problems) against float64 plain: rotations within 1e-4 rad, translations
    within 1e-4 of their largest norm, points and costs within 1e-4
    relative; and no worse a final cost than float32 plain's."""
    T = chip_smoke.ba_batch(B, C, L, seed=1)

    def solve(R, t, X, uv, mask, fixed):
        out, st = ba.bundle_adjust(BAState(R, t, X), BAProblem(uv, mask, fixed, 0.01),
                                   iterations=12)
        return (*out, st.cost, st.initial_cost)

    args = [T[k] for k in ("R", "t", "X", "uv", "mask", "fixed")]
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    got = torch.func.vmap(solve)(*f32)
    want = torch.func.vmap(solve)(*args)
    for b in range(B):
        Rg, Rw = got[0][b].double(), want[0][b]
        ang = (torch.linalg.matrix_norm(Rg - Rw) / (2 * math.sqrt(2))).clamp(max=1).asin() * 2
        assert float(ang.max()) <= 1e-4
        assert _rel(got[1][b], want[1][b]) <= 1e-4
        assert _rel(got[2][b], want[2][b]) <= 1e-4
        assert _rel(got[3][b], want[3][b]) <= 1e-4 and _rel(got[4][b], want[4][b]) <= 1e-4
    plain32 = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ba, "_fused", lambda s, p: False)
        plain32 = torch.func.vmap(solve)(*f32)
    assert (got[3].double() <= plain32[3].double() * (1 + 1e-4) + 1e-12).all()


def test_torch_cuda_ba_vmap_equals_the_written_out_batch(cuda):
    """schur/update/cost under vmap over 16 problems: one launch each, bit
    for bit the ops called on the stacked batch."""
    T = chip_smoke.ba_batch(16, 8, 1037, seed=2)
    R, t, X, uv = (T[k].float() for k in ("R", "t", "X", "uv"))
    mask, fixed, lam = T["mask"].float(), T["fixed"], T["lam"].float()
    c0 = kernels.launch_counts()
    vS = torch.func.vmap(lambda *a: cuda_ba.schur(*a, 0.01))(R, t, X, uv, mask, lam)
    dx = 1e-3 * torch.randn(16, 8, 6, device=cuda, generator=torch.Generator("cuda").manual_seed(0))
    vU = torch.func.vmap(lambda *a: cuda_ba.update(*a, 0.01))(R, t, X, uv, mask, dx, fixed, vS[4])
    vC = torch.func.vmap(lambda *a: cuda_ba.cost(*a, 0.01))(R, t, X, uv, mask)
    c1 = kernels.launch_counts()
    assert (c1["ba_schur"] - c0["ba_schur"], c1["ba_update"] - c0["ba_update"]) == (1, 2)
    S = torch.ops.cvsteer.ba_schur(R, t, X, uv, mask, lam, 0.01)
    U = torch.ops.cvsteer.ba_update(R, t, X, uv, mask, dx, fixed, S[4], 0.01)
    C0 = torch.ops.cvsteer.ba_update(R, t, X, uv, mask, None, None, None, 0.01)[3]
    for a, b in zip((*vS, *vU, vC), (*S, *U, C0)):
        assert torch.equal(a, b)


def test_torch_cuda_ba_graph_replay_equals_eager(cuda):
    """bundle_adjust at the fleet's shape (16 x 8 x 4096) captured in a CUDA
    graph: two replays and the eager run agree bit for bit, and the capture
    launched ba_schur 12 times and ba_update 13 (12 + the initial cost)."""
    T = chip_smoke.ba_batch(16, 8, 4096, seed=3)
    args = [T[k].float() if T[k].is_floating_point() else T[k]
            for k in ("R", "t", "X", "uv", "mask", "fixed")]
    static = [a.clone() for a in args]

    def solve(R, t, X, uv, mask, fixed):
        out, st = ba.bundle_adjust(BAState(R, t, X), BAProblem(uv, mask, fixed, 0.01),
                                   iterations=12)
        return (*out, st.cost, st.lambda_final)

    def run():  # as the engines capture: cuSOLVER's factorizations, TF32 off
        with _capture_math():
            return torch.func.vmap(solve)(*static)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [a.clone() for a in run()]
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    c0 = kernels.launch_counts()
    with torch.cuda.graph(g):
        outs = run()
    c1 = kernels.launch_counts()
    assert (c1["ba_schur"] - c0["ba_schur"], c1["ba_update"] - c0["ba_update"]) == (12, 13)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def test_torch_cuda_ba_wrappers_raise(cuda):
    T = chip_smoke.ba_batch(1, 2, 64)
    R, t, X, uv = (T[k].float() for k in ("R", "t", "X", "uv"))
    mask, lam = T["mask"].float(), T["lam"].float()
    with pytest.raises(ValueError):
        torch.ops.cvsteer.ba_schur(R.double(), t, X, uv, mask, lam, 0.0)
    with pytest.raises(ValueError):
        torch.ops.cvsteer.ba_schur(R, t, X, uv, T["mask"], lam, 0.0)  # a bool mask
    with pytest.raises(ValueError):
        torch.ops.cvsteer.ba_schur(R, t, X[:, :-1], uv, mask, lam, 0.0)

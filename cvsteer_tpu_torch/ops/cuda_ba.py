"""Window BA's two kernels an LM iteration (``kernels/csrc/ba_schur.cu``).

slam.ba.bundle_adjust takes them for float32 tensors on the card; the CPU
and float64 keep its plain code (``_normal_equations``, ``reduced_system``,
``back_substitute``, ``apply_updates``, ``cost``), which the CPU tests hold
against the JAX package. Per iteration:

- :func:`schur` (kernel ``ba_schur``): the camera side of the Schur
  complement before the damping and the gauge, ``(S [C, 6, C, 6], bs_lm
  [C, 6], H_cc [C, 6, 6], b_c [C, 6])`` as ``reduced_system`` has them,
  and each column's ``H_ll^-1`` and ``b_l`` (``lm [L, 12]``) for the update;
- :func:`update` (kernel ``ba_update``): from the solved camera steps
  ``dx [C, 6]``, the candidate state (``apply_updates`` of the poses, the
  back-substituted points) and its robust cost; without a step (:func:`cost`)
  only the cost of the given state.

Each is an operator of the ``torch.library`` namespace ``cvsteer`` over a
leading batch of B problems, with a ``vmap`` rule that folds the vmapped
axis into B, so the fleet's vmapped promotion launches each kernel once for
all its streams. (A ``Library`` definition rather than ``custom_op``: the
latter imports ``torch._dynamo`` at its first call, 8.4 s with torch 2.11
on an H100 host.)
The launch shape adapts to B, C and L (:func:`launch_shape`), so a
problem's float32 rounding depends on how many problems share its launch
(never on their values): a stream of a 16-stream fleet and the same stream
on a rank of a 2-rank mesh fleet (8 a launch) agree to rounding, not bit for
bit. Every call adds one to its kernel's launch count.
"""

from typing import NamedTuple, Tuple

import torch

from cvsteer_tpu_torch import kernels

#: kernels/csrc/ba_schur.cu: threads a block (one observation each), landmark
#: columns a sub-chunk at most, cameras on each side of an S tile
THREADS, MAX_LB, TILE_CAMS = 256, 32, 8
#: blocks a launch aims for: one full wave of ba_schur, which holds 2 blocks
#: an SM of the H100's 132 (128 registers a thread)
WAVE_BLOCKS = 2 * 132
#: chunks (partial sums) a problem at most: the last block sums them alone
MAX_CHUNKS = 64
#: floats a column hands kernel 2: H_ll^-1 (9), b_l (3)
LM_FLOATS = 12
#: floats a camera's sums take in a chunk's partial: H_cc's upper
#: triangle (21), -J_c^T r (6), W H_ll^-1 b_l (6)
CAM_SUMS = 33


class LaunchShape(NamedTuple):
    """Columns a sub-chunk (``lb``), sub-chunks a block (``sub``), blocks a
    problem along the columns (``nchunk``), S tiles a side (``tiles``)."""

    lb: int
    sub: int
    nchunk: int
    tiles: int


def launch_shape(B: int, C: int, L: int) -> LaunchShape:
    """A block's observations fill its threads (``lb * C <= 256``); the
    columns are cut so that all B problems together give ~``WAVE_BLOCKS``
    blocks (so B = 1 still spreads over the card) and each problem at most
    ``MAX_CHUNKS`` partial sums."""
    lb = max(1, min(MAX_LB, THREADS // C))
    tiles = -(-C // TILE_CAMS)
    subs = max(1, -(-L // lb))
    want = max(1, min(MAX_CHUNKS, -(-WAVE_BLOCKS // (B * tiles * tiles))))
    sub = -(-subs // min(subs, want))
    return LaunchShape(lb, sub, -(-subs // sub), tiles)


def takes(*tensors: torch.Tensor) -> bool:
    """Whether the kernels take these tensors: float32 on a CUDA device."""
    return all(t.is_cuda and t.dtype == torch.float32 for t in tensors)


def _launch_args(R, t, X, uv, mask):
    """(B, C, L, launch shape), after checking the problems' tensors."""
    B, C = R.shape[:2]
    L = X.shape[1] if X.dim() == 3 else -1
    want = {"R": (B, C, 3, 3), "t": (B, C, 3), "X": (B, L, 3), "uv": (B, C, L, 2),
            "mask": (B, C, L)}
    for name, a in zip(want, (R, t, X, uv, mask)):
        if tuple(a.shape) != want[name] or not takes(a) or a.device != R.device:
            raise ValueError(f"ba kernels: {name} {tuple(a.shape)} {a.dtype} on {a.device}, "
                             f"expected {want[name]} float32 on {R.device}")
    if not 1 <= C <= THREADS:
        raise ValueError(f"ba kernels: {C} cameras, 1 to {THREADS} supported")
    return B, C, L, launch_shape(B, C, L)


#: the ops' schemas (torch.ops.cvsteer.*): a leading batch of B problems
_LIB = torch.library.Library("cvsteer", "DEF")
_LIB.define("ba_schur(Tensor R, Tensor t, Tensor X, Tensor uv, Tensor mask, Tensor lam, "
            "float huber_delta) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("ba_update(Tensor R, Tensor t, Tensor X, Tensor uv, Tensor mask, Tensor? dx, "
            "Tensor? fixed, Tensor? lm, float huber_delta) -> (Tensor, Tensor, Tensor, Tensor)")


def _schur_cuda(R, t, X, uv, mask, lam, huber_delta):
    B, C, L, shape = _launch_args(R, t, X, uv, mask)
    if tuple(lam.shape) != (B,) or not takes(lam):
        raise ValueError(f"ba_schur: lam {tuple(lam.shape)} {lam.dtype}, expected ({B},) float32")
    R, t, X, uv, mask, lam = (a.contiguous() for a in (R, t, X, uv, mask, lam))
    S = R.new_empty((B, C, 6, C, 6))
    bs, bc = R.new_empty((B, C, 6)), R.new_empty((B, C, 6))
    Hcc = R.new_empty((B, C, 6, 6))
    lm = R.new_empty((B, L, LM_FLOATS))
    part = R.new_empty((B * shape.nchunk * (36 * C * C + CAM_SUMS * C),))
    tickets = torch.zeros(B, dtype=torch.int32, device=R.device)
    kernels.count_launch("ba_schur")
    err = kernels.library().cvs_ba_schur(
        R.data_ptr(), t.data_ptr(), X.data_ptr(), uv.data_ptr(), mask.data_ptr(), lam.data_ptr(),
        float(huber_delta), S.data_ptr(), bs.data_ptr(), Hcc.data_ptr(), bc.data_ptr(),
        lm.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, C, L, shape.lb, shape.sub,
        shape.nchunk, kernels.stream_handle(R.device))
    kernels.check(err, "ba_schur")
    return S, bs, Hcc, bc, lm


def _schur_fake(R, t, X, uv, mask, lam, huber_delta):
    B, C = R.shape[:2]
    return (R.new_empty((B, C, 6, C, 6)), R.new_empty((B, C, 6)), R.new_empty((B, C, 6, 6)),
            R.new_empty((B, C, 6)), R.new_empty((B, X.shape[1], LM_FLOATS)))


def _update_cuda(R, t, X, uv, mask, dx, fixed, lm, huber_delta):
    """Kernel ``ba_update``: (R_new, t_new, X_new, cost [B]); without ``dx``
    only the cost of (R, t, X), the state's outputs then empty ([B, 0])."""
    B, C, L, shape = _launch_args(R, t, X, uv, mask)
    R, t, X, uv, mask = (a.contiguous() for a in (R, t, X, uv, mask))
    step = dx is not None
    if step:
        if (tuple(dx.shape) != (B, C, 6) or not takes(dx) or tuple(fixed.shape) != (B, C)
                or fixed.dtype != torch.bool or tuple(lm.shape) != (B, L, LM_FLOATS)
                or not takes(lm)):
            raise ValueError(f"ba_update: dx {tuple(dx.shape)} {dx.dtype}, fixed "
                             f"{tuple(fixed.shape)} {fixed.dtype}, lm {tuple(lm.shape)} {lm.dtype}")
        dx, fixed, lm = dx.contiguous(), fixed.contiguous(), lm.contiguous()
    Rn, tn, Xn = _update_fake(R, t, X, uv, mask, dx, fixed, lm, huber_delta)[:3]
    cost = R.new_empty((B,))
    part = R.new_empty((B * shape.nchunk,))
    tickets = torch.zeros(B, dtype=torch.int32, device=R.device)
    kernels.count_launch("ba_update")
    err = kernels.library().cvs_ba_update(
        R.data_ptr(), t.data_ptr(), X.data_ptr(), uv.data_ptr(), mask.data_ptr(),
        float(huber_delta), *(a.data_ptr() if step else None for a in (dx, fixed, lm, Rn, tn, Xn)),
        cost.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, C, L, shape.lb, shape.sub,
        shape.nchunk, kernels.stream_handle(R.device))
    kernels.check(err, "ba_update")
    return Rn, tn, Xn, cost


def _update_fake(R, t, X, uv, mask, dx, fixed, lm, huber_delta):
    if dx is None:
        return (*(a.new_empty((a.shape[0], 0)) for a in (R, t, X)), R.new_empty(R.shape[:1]))
    return (R.new_empty(R.shape), t.new_empty(t.shape), X.new_empty(X.shape),
            R.new_empty(R.shape[:1]))


def _fold(info, in_dims, args):
    """The vmapped axis of every tensor argument moved to the front and
    folded into the op's leading B (unbatched ones expanded)."""
    n = info.batch_size
    out = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = a.movedim(d, 0) if d is not None else a.expand(n, *a.shape)
            a = a.reshape(n * a.shape[1], *a.shape[2:]).contiguous()
        out.append(a)
    return out


def _unfold(info, outs):
    n = info.batch_size
    return tuple(o.reshape(n, o.shape[0] // n, *o.shape[1:]) for o in outs), (0,) * len(outs)


def _vmap_rule(op):
    def rule(info, in_dims, *args):
        return _unfold(info, op(*_fold(info, in_dims, args)))
    return rule


for _name, _cuda, _fake in (("ba_schur", _schur_cuda, _schur_fake),
                            ("ba_update", _update_cuda, _update_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"cvsteer::{_name}", _fake, lib=_LIB)
    torch.library.register_vmap(f"cvsteer::{_name}", _vmap_rule(getattr(torch.ops.cvsteer, _name)),
                                lib=_LIB)


def schur(R, t, X, uv, mask, lam, huber_delta: float):
    """One problem's (or, under vmap, each stream's) camera side of the
    Schur complement: ``(S [C, 6, C, 6], bs_lm [C, 6], H_cc [C, 6, 6], b_c
    [C, 6], lm [L, 12])``; ``mask [C, L]`` float32, ``lam`` 0-dim."""
    outs = torch.ops.cvsteer.ba_schur(R[None], t[None], X[None], uv[None], mask[None],
                                      lam.reshape(1), float(huber_delta))
    return tuple(o[0] for o in outs)


def update(R, t, X, uv, mask, dx, fixed, lm, huber_delta: float):
    """The candidate ``(R, t, X)`` of the step ``dx [C, 6]`` (``fixed [C]``
    cameras keep their pose) and its cost (0-dim)."""
    outs = torch.ops.cvsteer.ba_update(R[None], t[None], X[None], uv[None], mask[None], dx[None],
                                       fixed[None], lm[None], float(huber_delta))
    return tuple(o[0] for o in outs)


def cost(R, t, X, uv, mask, huber_delta: float):
    """The robust cost (0-dim) of the state ``(R, t, X)``."""
    return torch.ops.cvsteer.ba_update(R[None], t[None], X[None], uv[None], mask[None], None,
                                       None, None, float(huber_delta))[3][0]

"""Batched VO serving on the host engine: many independent streams, two
waits per step (twin of cvsteer_tpu.slam.vo_server).

A step launches the tracking step of every ready stream first (the
launches queue on the device, each with its result's copy to the host
started), waits once, and runs each stream's keyframe decision; then it
launches the keyframe step (triangulation and windowed BA) of every stream
that promotes, waits once more, and runs their host tails and epilogues.
Bootstrap runs per stream through ``process_frame``. Everything else is
the sequential loop's code in the sequential loop's order, so a 1-stream
server equals ``vo.process_frame`` bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cvsteer_tpu_torch.features.frontend import Features
from cvsteer_tpu_torch.slam.vo import (
    VOConfig,
    VOState,
    _decide_keyframe,
    _diag,
    _keyframe_epilogue,
    _kf_fused_complete,
    _kf_fused_issue,
    _track_complete,
    _track_issue,
    finalize,
    init_vo,
    process_frame,
)


def _wait(states: Sequence[VOState]) -> None:
    """One wait for everything launched on the streams' devices."""
    for dev in {st.device for st in states}:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class VOServer:
    """``n_streams`` independent host-engine VO streams stepped in lockstep
    with two waits per step, however many streams promote."""

    def __init__(self, config: VOConfig = VOConfig(), n_streams: int = 8, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "VOServer(device='cuda') needs a CUDA device; pass device='cpu' to run on the CPU"
            )
        self.states: List[VOState] = [init_vo(config, device=device) for _ in range(n_streams)]

    def step(self, frames: Sequence[Optional[Features]]) -> None:
        """Advance every stream by one frame (``frames[i]`` None: no frame
        for stream i this tick)."""
        if len(frames) != len(self.states):
            raise ValueError(f"{len(frames)} frames for {len(self.states)} streams")
        pending = {}
        for i, (st, feats) in enumerate(zip(self.states, frames)):
            if feats is None:
                continue
            if not st.keyframes or not st.initialized:
                self.states[i] = process_frame(st, feats)  # bootstrap (rare)
                continue
            pending[i] = _track_issue(st, feats)
        if not pending:
            return
        _wait([self.states[i] for i in pending])  # wait 1: the fleet's tracks

        tracked, kf_req = {}, {}
        for i, fetch in pending.items():
            st = self.states[i]
            out = tracked[i] = _track_complete(st, fetch)
            req = _decide_keyframe(st, frames[i], *out[:6], flow=out[8])
            if req is not None:
                kf_req[i] = req

        fused = {}
        for i, (R, t, idx, valid, ref_kf) in kf_req.items():
            x_new, fvalid = tracked[i][6:8]
            fused[i] = _kf_fused_issue(self.states[i], frames[i], R, t, idx, valid, ref_kf,
                                       x_new, fvalid)
        if fused:
            _wait([self.states[i] for i in fused])  # wait 2: the promotions
        for i, (fetch, ctx) in fused.items():
            st = self.states[i]
            _kf_fused_complete(st, fetch, ctx)
            _keyframe_epilogue(st, ground_h=tracked[i][9])
            _diag(st, ev="kf", n_kf=len(st.keyframes), n_tracked=int(tracked[i][2]))
        for i in pending:
            self.states[i].frame_count += 1

    def finalize(self, i: int) -> VOState:
        """Stream i's state with the final keyframe refinements propagated
        into its trajectory."""
        return finalize(self.states[i])

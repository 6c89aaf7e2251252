"""The port's multi-process runtime (cvsteer_tpu_torch.parallel.multihost)
on the CPU: the reference's tests/test_parallel.py:133-163 and its fault
injection (:184-246, with tests/multihost_worker.py) on torch.distributed.

1. The helpers: with no address anywhere initialize_distributed is a no-op
   (False) and device_barrier returns 1.0; in a spawned 2-rank gloo world
   initialize_distributed reports the joined world, device_barrier sums to
   2.0, allreduce_checksum equals the sum of |x| over both ranks' shards,
   and a Heartbeat on its own gloo group reaches 2 beats without failing
   (a deadline loop, not a fixed sleep), then stops both ranks at one probe.
2. Fault injection: two worker processes (this file run as a script, so
   the reference's worker stays as it is) join a gloo world on localhost,
   meet at a barrier, and run a Heartbeat. Rank 1 is killed; the
   survivor's heartbeat fires, saves through the port's SlamCheckpointer
   (emergency_save: the group is broken) and exits 42; a fresh process
   resumes the saved state.
"""

import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HB_BEATS, HB_DEADLINE_S = 2, 20.0


def _wait_beats(hb, n=HB_BEATS):
    """Wait (a deadline, not a sleep: a loaded host can starve the beat
    thread) until ``hb`` has beaten ``n`` times."""
    deadline = time.monotonic() + HB_DEADLINE_S
    while hb.beats < n and not hb.failed and time.monotonic() < deadline:
        time.sleep(0.02)


def _rank_helpers(rank):
    import torch

    from cvsteer_tpu_torch.parallel.multihost import (
        Heartbeat, allreduce_checksum, device_barrier, initialize_distributed,
    )
    import torch.distributed as dist

    joined = initialize_distributed(device_type="cpu")
    barrier = device_barrier()
    x = torch.arange(8.0).reshape(4, 2) - 3.0 * rank
    checksum = float(allreduce_checksum(x, dist.group.WORLD))
    hb = Heartbeat(interval_s=0.05, timeout_s=30.0).start()
    _wait_beats(hb)
    hb.stop()
    return dict(joined=joined, barrier=barrier, checksum=checksum, beats=hb.beats,
                failed=hb.failed, alive=hb._thread.is_alive(), x=x.numpy())


def test_torch_multihost_helpers(tmp_path, monkeypatch):
    from cvsteer_tpu_torch.parallel.launch import spawn_world
    from cvsteer_tpu_torch.parallel.multihost import Heartbeat, device_barrier, initialize_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False  # no address configured
    assert device_barrier() == 1.0  # no process group
    hb = Heartbeat(interval_s=0.05, timeout_s=30.0).start()
    _wait_beats(hb)
    hb.stop()
    assert hb.beats >= HB_BEATS and not hb.failed

    ranks = spawn_world(_rank_helpers, 2, device_type="cpu", workdir=str(tmp_path))
    total = float(sum(np.abs(r["x"]).sum() for r in ranks))
    print(f"parity multihost 2 ranks: barrier {[r['barrier'] for r in ranks]}, checksum "
          f"{ranks[0]['checksum']} (sum of |x| {total}), beats {[r['beats'] for r in ranks]}")
    for r in ranks:
        assert r["joined"] is True
        assert r["barrier"] == 2.0
        assert r["checksum"] == total
        assert r["beats"] >= HB_BEATS and not r["failed"] and not r["alive"]


def test_torch_fault_injection_recovery(tmp_path):
    """Kill one process of two: the survivor's heartbeat fires on_failure,
    checkpoints and exits 42; a restarted process resumes the checkpoint."""
    import socket
    import subprocess

    from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo
    from cvsteer_tpu_torch.utils.checkpoint import SlamCheckpointer

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(i), "2",
                               str(tmp_path)], env=env, cwd=ROOT)
             for i in range(2)]
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not all((tmp_path / f"ready_{i}").exists() for i in range(2)):
            time.sleep(0.2)
        assert all((tmp_path / f"ready_{i}").exists() for i in range(2)), (
            "workers never reached the startup barrier")
        assert float((tmp_path / "ready_0").read_text()) == 2.0

        procs[1].kill()  # drop a rank
        t0 = time.time()
        rc = procs[0].wait(timeout=60)
        print(f"parity fault injection: survivor exited {rc} {time.time() - t0:.2f} s after the kill")
        assert rc == 42, f"survivor exited {rc}, expected the on_failure path"
        assert (tmp_path / "failed_0").exists()

        ck = SlamCheckpointer(str(tmp_path / "ckpt"))
        assert ck.latest_step() == 1
        assert ck.restore(init_vo(VOConfig())).frame_count == 123
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _worker(port: str, pid: int, n: int, outdir: str) -> int:
    """A rank of the fault-injection world: join, meet at a barrier, then
    beat until killed or failed."""
    from cvsteer_tpu_torch.parallel.multihost import Heartbeat, device_barrier, initialize_distributed

    initialize_distributed(f"localhost:{port}", n, pid, device_type="cpu")
    total = device_barrier()
    # written whole, then renamed: the parent never reads a half-written file
    ready = os.path.join(outdir, f"ready_{pid}")
    with open(ready + ".tmp", "w") as f:
        f.write(str(total))
    os.replace(ready + ".tmp", ready)

    def on_failure():
        # the recovery path: checkpoint the SLAM state without a collective
        # (the group is broken), then exit for a supervisor to restart
        from cvsteer_tpu_torch.slam.vo import VOConfig, init_vo
        from cvsteer_tpu_torch.utils.checkpoint import SlamCheckpointer

        state = init_vo(VOConfig())
        state.frame_count = 123  # what the test reads back after the restart
        SlamCheckpointer(os.path.join(outdir, "ckpt")).emergency_save(1, state)
        with open(os.path.join(outdir, f"failed_{pid}"), "w") as f:
            f.write("heartbeat failure")
        os._exit(42)

    hb = Heartbeat(interval_s=1.0, timeout_s=5.0, on_failure=on_failure).start()
    time.sleep(120.0)
    hb.stop()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))

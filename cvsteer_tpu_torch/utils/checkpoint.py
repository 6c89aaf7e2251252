"""Checkpoint / resume of the VO state (twin of cvsteer_tpu.utils.checkpoint).

The state a checkpoint keeps is the keyframed host VOState: keyframe poses,
features and landmark tables, the landmark store, the trajectory with its
re-anchoring records, and the priors' rolling histories. It is written as
a tree of arrays with the reference's keys and layouts
(:func:`_state_to_tree`), so the two packages' trees compare key for key.

The reference keeps its steps with orbax. Here each step is one file,
``step_<n>.pt``: the tree's arrays as tensors through ``torch.save``,
written to a temporary name and moved into place with ``os.replace`` (a
reader never sees half a file), the newest ``max_to_keep`` kept. It is
read back with ``torch.load(weights_only=True)``, which loads tensors and
containers and nothing else. :meth:`SlamCheckpointer.emergency_save` is the
reference's collective-free ``.npz`` form for failure paths; ``restore``
takes it when it is newer.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cvsteer_tpu_torch.features.frontend import Features
from cvsteer_tpu_torch.slam.vo import Keyframe, VOState


def _config_json(cfg) -> str:
    """A nested NamedTuple config as canonical JSON (the mismatch guard)."""

    def conv(v):
        if hasattr(v, "_asdict"):
            return {k: conv(x) for k, x in v._asdict().items()}
        return v

    return json.dumps(conv(cfg), sort_keys=True)


def _padded_refs(state: VOState):
    """state.traj_ref padded with None to max(len(trajectory), 1): the rows
    stay aligned with the trajectory and are never zero (the reference's
    orbax refuses empty arrays; the layout is kept)."""
    n = max(len(state.trajectory), 1)
    refs = list(state.traj_ref[:n])
    refs += [None] * (n - len(refs))
    return refs


def _host_features(keyframes: List[Keyframe]) -> List[Dict[str, np.ndarray]]:
    """Each keyframe's Features as numpy, with one device-to-host copy per
    field for all keyframes (they share one shape)."""
    if not keyframes:
        return []
    fields = {
        f: torch.stack([getattr(kf.features, f) for kf in keyframes]).cpu().numpy()
        for f in Features._fields
    }
    return [{f: fields[f][n] for f in Features._fields} for n in range(len(keyframes))]


def _state_to_tree(state: VOState) -> Dict[str, Any]:
    """The state as a nested dict of numpy arrays, the reference's keys and
    layouts."""
    refs = _padded_refs(state)
    tree: Dict[str, Any] = {
        "landmarks": np.asarray(state.landmarks),
        "landmark_valid": np.asarray(state.landmark_valid),
        "num_landmarks": np.asarray(state.num_landmarks),
        "frame_count": np.asarray(state.frame_count),
        "initialized": np.asarray(state.initialized),
        # the priors' rolling histories, each behind its length
        "kf_speeds": np.asarray([len(state.kf_baselines)] + list(state.kf_baselines), np.float32),
        "ground_hist": np.asarray([len(state.ground_hist)] + list(state.ground_hist), np.float32),
        "traj_frames": np.asarray([f for f, _, _ in state.trajectory], np.int64),
        "traj_R": np.stack([R for _, R, _ in state.trajectory])
        if state.trajectory else np.zeros((0, 3, 3), np.float32),
        "traj_t": np.stack([t for _, _, t in state.trajectory])
        if state.trajectory else np.zeros((0, 3), np.float32),
        # traj_ref rows: keyframe entries (None) flatten to ref = -1 rows
        "traj_ref_meta": np.asarray(
            [[r[0], r[3]] if r is not None else [-1, -1] for r in refs], np.int64
        ).reshape(-1, 2),
        "traj_ref_R": np.stack(
            [r[1] if r is not None else np.eye(3, dtype=np.float32) for r in refs]
        ),
        "traj_ref_tb": np.asarray(
            [np.concatenate([r[2], [r[4]]]) if r is not None else np.zeros(4, np.float32)
             for r in refs],
            np.float32,
        ).reshape(-1, 4),
    }
    tree["keyframes"] = {
        str(n): {
            "index": np.asarray(kf.index),
            "R": np.asarray(kf.R),
            "t": np.asarray(kf.t),
            "landmark_ids": np.asarray(kf.landmark_ids),
            "features": feats,
        }
        for n, (kf, feats) in enumerate(zip(state.keyframes, _host_features(state.keyframes)))
    }
    return tree


def _tree_to_state(tree: Dict[str, Any], state: VOState) -> VOState:
    """Fill ``state`` (a fresh init_vo shell with the config) from a tree;
    keyframe features go to ``state.device``."""
    state.landmarks = np.asarray(tree["landmarks"])
    state.landmark_valid = np.asarray(tree["landmark_valid"])
    state.num_landmarks = int(tree["num_landmarks"])
    state.frame_count = int(tree["frame_count"])
    state.initialized = bool(tree["initialized"])
    for key, attr in (("kf_speeds", "kf_baselines"), ("ground_hist", "ground_hist")):
        rows = np.asarray(tree.get(key, np.zeros(1, np.float32)))
        n_h = int(rows[0]) if rows.size else 0
        setattr(state, attr, [float(x) for x in rows[1:1 + n_h]])
    state.trajectory = [
        (int(f), np.asarray(R), np.asarray(t))
        for f, R, t in zip(tree["traj_frames"], tree["traj_R"], tree["traj_t"])
    ]
    state.traj_ref = [
        None if int(m[0]) < 0 else (
            int(m[0]), np.asarray(R, np.float32), np.asarray(tb[:3], np.float32), int(m[1]),
            float(tb[3]),
        )
        for m, R, tb in zip(
            tree.get("traj_ref_meta", np.zeros((0, 2), np.int64)),
            tree.get("traj_ref_R", np.zeros((0, 3, 3), np.float32)),
            tree.get("traj_ref_tb", np.zeros((0, 4), np.float32)),
        )
    ]
    # a tree without traj_ref pads with None; the save-time padding rows go
    state.traj_ref = state.traj_ref[: len(state.trajectory)]
    while len(state.traj_ref) < len(state.trajectory):
        state.traj_ref.append(None)
    state.keyframes = []
    # an empty keyframes dict disappears through the flat .npz form
    kfs = tree.get("keyframes", {})
    for n in sorted(kfs, key=int):
        kf = kfs[n]
        state.keyframes.append(Keyframe(
            index=int(kf["index"]),
            features=Features(**{
                k: torch.as_tensor(np.asarray(kf["features"][k]), device=state.device)
                for k in Features._fields
            }),
            R=np.asarray(kf["R"]),
            t=np.asarray(kf["t"]),
            landmark_ids=np.asarray(kf["landmark_ids"]),
        ))
    return state


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class SlamCheckpointer:
    """Versioned checkpoints under ``directory``, keyed by step (the cli
    uses the keyframe count)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep

    @property
    def _config_path(self) -> str:
        return os.path.join(self.directory, "config.json")

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _write_config(self, state: VOState) -> None:
        # a resume under another window or threshold would mix optimization
        # regimes silently: keep the config beside the state
        if not os.path.exists(self._config_path):
            tmp = f"{self._config_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(_config_json(state.config))
            os.replace(tmp, self._config_path)

    def _listed(self, prefix: str, suffix: str) -> List[int]:
        steps = []
        for fn in os.listdir(self.directory):
            if fn.startswith(prefix) and fn.endswith(suffix):
                try:
                    steps.append(int(fn[len(prefix):-len(suffix)]))
                except ValueError:
                    pass
        return sorted(steps)

    def _steps(self) -> List[int]:
        return self._listed("step_", ".pt")

    def _emergency_steps(self) -> List[int]:
        return self._listed("emergency_", ".npz")

    def save(self, step: int, state: VOState) -> None:
        """Write step ``step`` atomically, then drop the oldest steps beyond
        ``max_to_keep``."""
        self._write_config(state)
        tree = _map_tree(lambda a: torch.from_numpy(np.array(a)), _state_to_tree(state))
        tmp = f"{self._step_path(step)}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._step_path(step))
        for old in self._steps()[:-self._max_to_keep]:
            os.remove(self._step_path(old))

    def emergency_save(self, step: int, state: VOState) -> None:
        """A collective-free checkpoint for failure paths: the same tree,
        flattened to ``a/b/c`` keys in an atomically renamed ``.npz``;
        ``restore`` takes it when it is newer than the latest step."""
        self._write_config(state)
        flat: Dict[str, np.ndarray] = {}

        def flatten(prefix, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    flatten(f"{prefix}/{k}" if prefix else k, v)
            else:
                flat[prefix] = np.asarray(node)

        flatten("", _state_to_tree(state))
        # np.savez appends .npz when missing: keep the suffix on the temp name
        tmp = os.path.join(self.directory, f".emergency_{step}.tmp.npz")
        np.savez(tmp, **flat)
        os.replace(tmp, os.path.join(self.directory, f"emergency_{step}.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps() + self._emergency_steps()
        return max(steps) if steps else None

    def restore(
        self,
        state: VOState,
        step: Optional[int] = None,
        *,
        allow_config_mismatch: bool = False,
    ) -> VOState:
        """Restore into ``state`` (a fresh init_vo shell with the config).

        Raises ValueError when the checkpoint was written under another
        VOConfig than ``state.config``, unless ``allow_config_mismatch``."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        if os.path.exists(self._config_path) and not allow_config_mismatch:
            with open(self._config_path) as f:
                saved = f.read()
            current = _config_json(state.config)
            if saved != current:
                raise ValueError(
                    "checkpoint config differs from the current VOConfig; "
                    "pass allow_config_mismatch=True to resume anyway.\n"
                    f"saved:   {saved}\ncurrent: {current}"
                )
        if step not in self._steps():
            tree: Dict[str, Any] = {}
            with np.load(os.path.join(self.directory, f"emergency_{step}.npz")) as z:
                for key in z.files:
                    node = tree
                    parts = key.split("/")
                    for p in parts[:-1]:
                        node = node.setdefault(p, {})
                    node[parts[-1]] = z[key]
        else:
            tree = _map_tree(
                lambda t: t.numpy(), torch.load(self._step_path(step), weights_only=True)
            )
        return _tree_to_state(tree, state)

    def close(self) -> None:
        """Nothing stays open between calls (the reference closes its
        orbax manager here)."""

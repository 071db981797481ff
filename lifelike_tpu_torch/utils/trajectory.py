"""Offline trajectory dump: robot state snapshots of a closed loop in one
compressed .npz.

Port of lifelike_tpu.utils.trajectory. `TrajectoryDump` collects a state
(any NamedTuple of tensors or arrays: RobotState, with its batch / agent
axes) plus rewards and extras per control step, and writes the same keys as
the reference, so tools/plot_traj.py renders either package's dump.
"""
import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TrajectoryDump:
    def __init__(self, path: str):
        self.path = path
        self._rows = {}
        self.n = 0

    def add(self, robot_state, reward=None, **extras):
        """Append one control-step snapshot: every field of robot_state, the
        reward and the extras (keys as given)."""
        row = {f: _np(getattr(robot_state, f)) for f in robot_state._fields}
        if reward is not None:
            row["reward"] = _np(reward)
        for k, v in extras.items():
            row[k] = _np(v)
        for k, v in row.items():
            self._rows.setdefault(k, []).append(v)
        self.n += 1

    def save(self):
        """Write the .npz (arrays stacked on a leading step axis); returns
        its path, or None when nothing was added."""
        if not self.n:
            return None
        np.savez_compressed(self.path, **{k: np.stack(v) for k, v in self._rows.items()})
        return self.path


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}

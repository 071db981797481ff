"""The golden hard-contact traces, the impulse plant's fidelity reference.

data/oracle_traces/{stand,walk,run,hurdle}.npz each hold H = 50 control
steps of the MAX quadruped stepped by tools/bullet_oracle.py (10 substeps at
500 Hz, kp 50, kd 0.5, max_tau 18, mu 0.5; `meta` says which backend made
them): the start state, the joint targets of every control step and the
state after it. stand, walk and run are on flat ground; hurdle runs through
the box scene stored beside it. The plant meets the criterion when its joint
positions stay within 1e-5 rad of the trace's over the horizon in float64.
"""
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.scene.boxes import BoxScene

TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                         "oracle_traces")
NAMES = ("stand", "walk", "run", "hurdle")
# the traces stepped together as one batch: flat ground, then the box scene
GROUPS = (("walk", "run", "stand"), ("hurdle",))


class Trace(NamedTuple):
    init: RobotState  # the start state
    targets: torch.Tensor  # (H, 12) joint targets held over each control step
    joint_pos: np.ndarray  # (H, 12) float64 joint positions after each step
    scene: Optional[BoxScene]  # the box scene (hurdle), else None
    meta: dict


def path(name):
    return os.path.join(TRACE_DIR, f"{name}.npz")


def load(name, dtype=torch.float64, device="cuda") -> Trace:
    """The trace `name` with its start state, targets and scene as tensors of
    `dtype` on `device`."""
    dev = _device.resolve_device(device)
    z = np.load(path(name))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

    scene = None
    if "scene_centers" in z.files:
        k = z["scene_centers"].shape[0]
        scene = BoxScene(center=t(z["scene_centers"]), half=t(z["scene_halves"]),
                         active=torch.ones(k, dtype=torch.bool, device=dev),
                         target_pos=torch.zeros(3, dtype=dtype, device=dev))
    return Trace(init=RobotState(*(t(z[f"init_{f}"]) for f in RobotState._fields)),
                 targets=t(z["targets"]), joint_pos=np.asarray(z["joint_pos"], np.float64),
                 scene=scene, meta=json.loads(str(z["meta"])))


def start_shifts(members, noise=1e-6, seed=0):
    """Joint-position shifts (rad) of an ensemble of starts per trace,
    {name: (members, 12) float64}: member 0 is the trace's own start (no
    shift), the others N(0, noise) draws from one seeded generator taken in
    GROUPS order, so every user of a seed perturbs the starts alike."""
    rng = np.random.default_rng(seed)
    out = {}
    for names in GROUPS:
        shift = noise * rng.standard_normal((len(names), members, 12))
        shift[:, 0] = 0.0
        out.update(zip(names, shift))
    return out

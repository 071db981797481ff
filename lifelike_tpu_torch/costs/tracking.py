"""PMC mocap-tracking reward/cost, batched.

Port of lifelike_tpu.costs.tracking: a normalized weighted sum of five
exponential terms comparing the dynamic robot against the kinematic
reference frame — joint positions, joint velocities, end-effector (foot)
positions, root pose, root velocity (reference primitive_level_env.py:350-426).
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.physics.dynamics import RobotState


class TrackingWeights(NamedTuple):
    # defaults from reference primitive_level_env.py:359-363 (pre-normalization)
    joint_pos: float = 0.6
    joint_vel: float = 0.05
    end_effector: float = 0.1
    root_pose: float = 0.15
    root_vel: float = 0.1


# exponential scales, reference primitive_level_env.py:373-377
_SCALE_JOINT_POS = -1.0
_SCALE_JOINT_VEL = -0.1
_SCALE_END_EFFECTOR = -40.0
_SCALE_ROOT_POSE = (-20.0, -10.0)
_SCALE_ROOT_VEL = (-2.0, -0.2)


def tracking_reward(state: RobotState, foot_pos, ref, ref_foot_pos,
                    weights: TrackingWeights = TrackingWeights()):
    """Reward in [0, 1]. foot_pos/ref_foot_pos: (..., 4, 3) world foot centers;
    `ref` has the RobotState fields (RobotState or FrameState)."""
    jp = state.joint_pos
    w = torch.tensor(tuple(weights), dtype=jp.dtype, device=jp.device)
    w = w / torch.sum(w)

    r_jp = torch.exp(
        _SCALE_JOINT_POS * torch.sum((state.joint_pos - ref.joint_pos) ** 2, dim=-1)
    )
    r_jv = torch.exp(
        _SCALE_JOINT_VEL * torch.sum((state.joint_vel - ref.joint_vel) ** 2, dim=-1)
    )
    r_ee = torch.exp(
        _SCALE_END_EFFECTOR * torch.sum((foot_pos - ref_foot_pos) ** 2, dim=(-2, -1))
    )
    rv = quat.diff_rotvec(ref.base_orn, state.base_orn)
    angle = torch.sqrt(torch.sum(rv**2, dim=-1) + 1e-12)
    r_pose = torch.exp(
        _SCALE_ROOT_POSE[0] * torch.sum((state.base_pos - ref.base_pos) ** 2, dim=-1)
        + _SCALE_ROOT_POSE[1] * angle**2
    )
    r_vel = torch.exp(
        _SCALE_ROOT_VEL[0]
        * torch.sum((state.base_lin_vel - ref.base_lin_vel) ** 2, dim=-1)
        + _SCALE_ROOT_VEL[1]
        * torch.sum((state.base_ang_vel - ref.base_ang_vel) ** 2, dim=-1)
    )
    return w[0] * r_jp + w[1] * r_jv + w[2] * r_ee + w[3] * r_pose + w[4] * r_vel


def tracking_cost(state, foot_pos, ref, ref_foot_pos, weights=TrackingWeights()):
    """MPC stage cost = 1 - reward."""
    return 1.0 - tracking_reward(state, foot_pos, ref, ref_foot_pos, weights)


def fall_terminated(state: RobotState):
    """Fall detection (reference legged_robot.py:158-179): roll > 45 deg via
    left_z = (up x fwd)_z, or pitch: up_z < cos(60 deg)."""
    m = quat.to_matrix(state.base_orn)
    fwd = m[..., :, 0]
    up = m[..., :, 2]
    left_z = up[..., 0] * fwd[..., 1] - up[..., 1] * fwd[..., 0]
    roll_bad = left_z.abs() > math.sin(math.pi / 4.0)
    pitch_bad = up[..., 2] < math.cos(math.pi / 3.0)
    return roll_bad | pitch_bad


def divergence_terminated(state: RobotState, ref):
    """Dyn-kin divergence (reference primitive_level_env.py:319-335): squared
    position error > 1 m^2 or relative rotation angle > 1 rad."""
    pos_err = torch.sum((state.base_pos - ref.base_pos) ** 2, dim=-1)
    angle = torch.linalg.vector_norm(quat.diff_rotvec(ref.base_orn, state.base_orn), dim=-1)
    return (pos_err > 1.0) | (angle.abs() > 1.0)


def blown_up(state: RobotState):
    """Integrator-blowup guard: non-finite state or velocities beyond any
    physical bound (1e3 m/s | rad/s)."""
    bad = torch.zeros(state.base_pos.shape[:-1], dtype=torch.bool,
                      device=state.base_pos.device)
    for leaf in state:
        bad = bad | ~torch.all(torch.isfinite(leaf), dim=-1)
    for vel in (state.base_lin_vel, state.base_ang_vel, state.joint_vel):
        bad = bad | (torch.amax(vel.abs(), dim=-1) > 1e3)
    return bad

"""EPMC terrain-traversal cost stack for the MPC solver.

Port of lifelike_tpu.costs.traversal: the playground rewards (reference
playground_env.py:479-539) negated into stage costs, plus posture shaping
and a soft clearance hinge that keeps the solver off box sides. These are
the batch-leading oracles; the tile-layout versions the rollouts use are in
solver.rollout_tasks.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.scene import boxes


class TraversalWeights(NamedTuple):
    """fall/clearance are penalty weights; velocity/heading weight dense
    shaping terms (|speed - target| and 1 - heading alignment). With
    velocity = heading = 0 (and fall = 0) the joystick cost is exactly the
    negated env reward."""

    velocity: float = 0.3
    heading: float = 1.0
    clearance: float = 0.5
    fall: float = 5.0
    # posture shaping: keeps "lie flat and crawl" from beating stepping
    height: float = 4.0  # hinge below height_min on base z
    height_min: float = 0.26
    upright: float = 2.0  # 1 - body up-vector z
    pose: float = 0.05  # squared deviation from the stand pose
    # crawl ceiling (crouch skill): hinge on base height above `ceiling` > 0
    ceiling: float = 0.0
    ceiling_w: float = 8.0
    # boxes whose bottom face is at least crawl_gap above ground are
    # crawlable and exempt from the clearance hinge; 0 keeps every tall box
    # blocking
    crawl_gap: float = 0.0


# crouch-stand joint pose (STATES_INFO_12_RUN_0 family): the posture prior
STAND_POSE = (
    -0.0278, -0.7790, 1.6873, -0.0276, -0.7777, 1.6838,
    -0.0278, -0.7334, 1.5669, -0.0276, -0.7319, 1.5632,
)


def posture_cost(state: RobotState, weights=None):
    """Stand prior: height hinge + uprightness + stand-pose regularization."""
    w = weights or TraversalWeights()
    z = state.base_pos[..., 2]
    up_z = 1.0 - 2.0 * (state.base_orn[..., 0] ** 2 + state.base_orn[..., 1] ** 2)
    stand = torch.tensor(STAND_POSE, dtype=state.joint_pos.dtype, device=state.joint_pos.device)
    pose_err = torch.mean((state.joint_pos - stand) ** 2, dim=-1)
    cost = (
        w.height * torch.clamp_min(w.height_min - z, 0.0)
        + w.upright * (1.0 - up_z)
        + w.pose * pose_err
    )
    if getattr(w, "ceiling", 0.0) > 0.0:
        cost = cost + w.ceiling_w * torch.clamp_min(z - w.ceiling, 0.0)
    return cost


def _dense_shaping(spd_signed, align, target_spd, weights):
    # signed speed: backward walking must not score like forward
    return (
        weights.velocity * (spd_signed - target_spd).abs() / (1.0 + target_spd)
        + weights.heading * (1.0 - align)
    )


def joystick_cost(state: RobotState, target_pos, target_spd, weights=TraversalWeights()):
    """1 - reward_vel * reward_rotation (joystick family) + dense shaping
    + posture + fall."""
    diff = (target_pos - state.base_pos)[..., :2]
    d = torch.linalg.vector_norm(diff, dim=-1).clamp_min(1e-8)
    dir_w = diff / d[..., None]
    spd_sg = (state.base_lin_vel[..., 0] * dir_w[..., 0]
              + state.base_lin_vel[..., 1] * dir_w[..., 1])
    r_vel = torch.exp(-(spd_sg.abs() - target_spd).abs())
    yaw = quat.yaw(state.base_orn)
    align = torch.cos(yaw) * dir_w[..., 0] + torch.sin(yaw) * dir_w[..., 1]
    r_rot = torch.exp((align - 1.0) * 5.0)
    cost = 1.0 - r_vel * r_rot + _dense_shaping(spd_sg, align, target_spd, weights)
    cost = cost + posture_cost(state, weights)
    fall = tracking.fall_terminated(state)
    return cost + weights.fall * fall.to(cost.dtype)


def progress_cost(state: RobotState, target_pos, last_dist, weights=TraversalWeights()):
    """Distance-progress cost (average_speed family): positive when moving
    away from the target. Returns (cost, new_dist)."""
    d = torch.linalg.vector_norm((target_pos - state.base_pos)[..., :2], dim=-1)
    cost = d - last_dist + posture_cost(state, weights)
    fall = tracking.fall_terminated(state)
    return cost + weights.fall * fall.to(cost.dtype), d


def clearance_cost(scene: boxes.BoxScene, state: RobotState, margin=0.15, crawl_gap=0.0):
    """Squared soft hinge on the horizontal distance from the base to any
    tall active box (walls, hole bars). crawl_gap > 0 exempts boxes whose
    bottom face clears it."""
    p = state.base_pos
    d = (p[..., None, :2] - scene.center[..., :, :2]).abs()
    out = torch.clamp_min(d - scene.half[..., :, :2], 0.0)
    # sqrt of the sum of squares, as jnp.linalg.norm computes it: over a
    # box's footprint (out = 0) the gradient is NaN in both packages, where
    # torch.linalg.vector_norm's would be 0
    horiz = torch.sqrt(torch.sum(out * out, dim=-1))
    tall = (scene.center[..., :, 2] + scene.half[..., :, 2]) > 0.3
    blocking = tall & scene.active
    if crawl_gap > 0.0:
        bottom = scene.center[..., :, 2] - scene.half[..., :, 2]
        blocking = blocking & (bottom < crawl_gap)
    pen = torch.clamp_min(margin - horiz, 0.0) * blocking
    return torch.sum(pen**2, dim=-1)

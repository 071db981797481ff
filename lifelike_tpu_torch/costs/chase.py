"""SEPMC Chase-Tag objective as MPC costs for both roles.

Port of lifelike_tpu.costs.chase. Game terms from the reference
chase_tag_game_env.py: the chaser minimizes its distance to the escapee
(:670-680), the escapee maximizes it while closing on the flag (:682-697,
flag progress gated by visibility); catch and flag-grab events are terminal
bonuses handled by the game (envs.chase_tag). These are the batch-leading
oracles; the tile-layout versions the rollouts use are in
solver.rollout_tasks.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.physics.dynamics import RobotState


class ChaseWeights(NamedTuple):
    distance: float = 1.0
    heading: float = 0.5
    fall: float = 5.0
    # stand prior (see costs.traversal.TraversalWeights: lying flat is
    # otherwise a safe local optimum for the sampling MPC)
    height: float = 4.0
    height_min: float = 0.26
    upright: float = 2.0
    pose: float = 0.05


def chaser_cost(state: RobotState, opponent_pos, weights=ChaseWeights()):
    """Distance to the escapee + heading alignment + fall (reference
    _compute_chaser_common_reward :699-719)."""
    diff = (opponent_pos - state.base_pos)[..., :2]
    d = torch.linalg.vector_norm(diff, dim=-1)
    dir_w = diff / d[..., None].clamp_min(1e-8)
    yaw = quat.yaw(state.base_orn)
    r_rot = torch.exp(
        (torch.cos(yaw) * dir_w[..., 0] + torch.sin(yaw) * dir_w[..., 1] - 1.0) * 2.0
    )
    cost = weights.distance * d + weights.heading * (1.0 - r_rot)
    fall = tracking.fall_terminated(state)
    return cost + weights.fall * fall.to(cost.dtype)


def escapee_cost(state: RobotState, opponent_pos, flag_pos, flag_visible=1.0,
                 weights=ChaseWeights()):
    """Negative distance from the chaser + distance to the flag (gated by
    its visibility, reference :682-697) + fall."""
    d_opp = torch.linalg.vector_norm((opponent_pos - state.base_pos)[..., :2], dim=-1)
    d_flag = torch.linalg.vector_norm((flag_pos - state.base_pos)[..., :2], dim=-1)
    cost = -weights.distance * d_opp + weights.distance * flag_visible * d_flag
    fall = tracking.fall_terminated(state)
    return cost + weights.fall * fall.to(cost.dtype)

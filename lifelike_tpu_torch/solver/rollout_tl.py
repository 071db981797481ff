"""Tile-layout horizon rollouts: the MPC inner loop's plain PyTorch version.

Port of lifelike_tpu.solver.rollout_tl. The mocap reference depends only on
(scenario, step), never on the candidate, so clip gathers, slerp and
reference FK are precomputed once per solve into (H, ...) tensors
(`precompute_reference`) and broadcast over the population.

`rollout_tracking` is the plain version of the CUDA rollout kernel
(ops.rollout_cuda.rollout_tracking_fused): same function, held against it.
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch.costs.tracking import TrackingWeights
from lifelike_tpu_torch.math import quat_tl
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import dynamics, engine_tl
from lifelike_tpu_torch.physics.dynamics import RobotState

# exponential scales, reference primitive_level_env.py:373-377
_S_JP = -1.0
_S_JV = -0.1
_S_EE = -40.0
_S_RP = (-20.0, -10.0)
_S_RV = (-2.0, -0.2)


class RefTraj(NamedTuple):
    """Per-step reference, tile layout with two trailing singleton batch axes.

    target_joint: (H, 4, 3, 1, 1) joints the controls are deltas on (time t_i)
    cost state (time t_{i+1}):
    joint_pos/joint_vel: (H, 4, 3, 1, 1)
    foot_pos: (H, 4, 3, 1, 1)
    base_pos/base_lin_vel/base_ang_vel: (H, 3, 1, 1)
    base_orn: (H, 4, 1, 1)
    """

    target_joint: torch.Tensor
    joint_pos: torch.Tensor
    joint_vel: torch.Tensor
    foot_pos: torch.Tensor
    base_pos: torch.Tensor
    base_orn: torch.Tensor
    base_lin_vel: torch.Tensor
    base_ang_vel: torch.Tensor


def precompute_reference(model, clips, clip_idx, t0, horizon, policy_dt) -> RefTraj:
    """Reference trajectory for one scenario (scalar clip_idx / t0) on the
    clips' device."""
    dev = clips.frames.device
    t0 = torch.as_tensor(t0, device=dev)
    dtype = torch.promote_types(t0.dtype, torch.float32)
    steps = torch.arange(horizon, dtype=dtype, device=dev)
    t_now = t0 + steps * policy_dt  # (H,)
    t_next = t_now + policy_dt
    ref_now = motion_lib.sample_frame(clips, clip_idx, t_now)  # leaves (H, k)
    ref_next = motion_lib.sample_frame(clips, clip_idx, t_next)
    rs = RobotState(*ref_next)
    foot = dynamics.forward_kinematics(model, rs).p_foot  # (H, 4, 3)

    def t43(x):  # (H, 12) -> (H, 4, 3, 1, 1)
        return x.reshape(x.shape[0], 4, 3)[..., None, None]

    def tk(x):  # (H, k) -> (H, k, 1, 1)
        return x[..., None, None]

    return RefTraj(
        target_joint=t43(ref_now.joint_pos),
        joint_pos=t43(ref_next.joint_pos),
        joint_vel=t43(ref_next.joint_vel),
        foot_pos=foot[..., None, None],
        base_pos=tk(ref_next.base_pos),
        base_orn=tk(ref_next.base_orn),
        base_lin_vel=tk(ref_next.base_lin_vel),
        base_ang_vel=tk(ref_next.base_ang_vel),
    )


def ref_step(ref: RefTraj, t) -> RefTraj:
    """The reference sliced at control step t."""
    return RefTraj(*(x[t] for x in ref))


def yaw_tl(q):
    """Base yaw from a tile-layout quaternion (4, Bs, L) -> (Bs, L)."""
    m = quat_tl.to_matrix(q)
    return torch.atan2(m[1, 0], m[0, 0])


def fall_mask_tl(s: B.TLState):
    """Reference check_terminate (legged_robot.py:158-179) in tile layout:
    roll > 45 deg or pitch > 60 deg. Returns bool (Bs, L)."""
    m = quat_tl.to_matrix(s.base_orn)
    fwd, up = m[:, 0], m[:, 2]
    left_z = up[0] * fwd[1] - up[1] * fwd[0]
    return (left_z.abs() > math.sin(math.pi / 4)) | (up[2] < math.cos(math.pi / 3))


def tracking_cost_step(s: B.TLState, foot_pos, ref_t: RefTraj, weights: TrackingWeights):
    """1 - tracking_reward in tile layout plus 5.0 x (fall | diverged);
    ref_t = RefTraj sliced at one step."""
    dt = s.base_pos.dtype
    w = torch.tensor(tuple(weights), dtype=dt, device=s.base_pos.device)
    w = w / torch.sum(w)
    r_jp = torch.exp(_S_JP * torch.sum((s.joint_pos - ref_t.joint_pos) ** 2, dim=(0, 1)))
    r_jv = torch.exp(_S_JV * torch.sum((s.joint_vel - ref_t.joint_vel) ** 2, dim=(0, 1)))
    r_ee = torch.exp(_S_EE * torch.sum((foot_pos - ref_t.foot_pos) ** 2, dim=(0, 1)))
    angle = quat_tl.rel_angle(ref_t.base_orn, s.base_orn)
    r_rp = torch.exp(
        _S_RP[0] * torch.sum((s.base_pos - ref_t.base_pos) ** 2, dim=0)
        + _S_RP[1] * angle**2
    )
    r_rv = torch.exp(
        _S_RV[0] * torch.sum((s.base_lin_vel - ref_t.base_lin_vel) ** 2, dim=0)
        + _S_RV[1] * torch.sum((s.base_ang_vel - ref_t.base_ang_vel) ** 2, dim=0)
    )
    reward = w[0] * r_jp + w[1] * r_jv + w[2] * r_ee + w[3] * r_rp + w[4] * r_rv
    cost = 1.0 - reward

    # fall / divergence penalties as masked arithmetic (no branches)
    fall = fall_mask_tl(s)
    pos_err = torch.sum((s.base_pos - ref_t.base_pos) ** 2, dim=0)
    diverged = (pos_err > 1.0) | (angle > 1.0)
    return cost + 5.0 * (fall | diverged).to(cost.dtype)


def rollout_tracking(c: B.TLConstants, params, state: B.TLState, controls, ref: RefTraj,
                     weights: TrackingWeights = TrackingWeights()):
    """controls: (H, 4, 3, Bs, L) joint-target deltas on ref.target_joint.

    Returns (total_cost (Bs, L), final TLState)."""
    s = state
    total = None
    for t in range(controls.shape[0]):
        ref_t = ref_step(ref, t)
        s = engine_tl.control_step(c, params, s, ref_t.target_joint + controls[t])
        kin = B.fk(c, s)
        cost = tracking_cost_step(s, kin.p_foot, ref_t, weights)
        total = cost if total is None else total + cost
    return total, s

"""Batched horizon rollouts of the quadruped on the readable engine.

Port of lifelike_tpu.solver.rollout: roll a population of control sequences
through physics.engine.control_step for H control steps, accumulating the
tracking cost against the motion library at each step. The batch-leading
MPPI oracle (solver.mppi) scores its candidates with it.
"""
import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import dynamics, engine
from lifelike_tpu_torch.physics.dynamics import RobotState


def ref_foot_positions(model, ref: motion_lib.FrameState):
    """Foot positions of the kinematic reference (FK on the ghost robot,
    reference compute_end_effector_info legged_robot.py:199-205)."""
    rs = RobotState(
        base_pos=ref.base_pos,
        base_orn=ref.base_orn,
        base_lin_vel=ref.base_lin_vel,
        base_ang_vel=ref.base_ang_vel,
        joint_pos=ref.joint_pos,
        joint_vel=ref.joint_vel,
    )
    return dynamics.forward_kinematics(model, rs).p_foot


def rollout_tracking(model, params: engine.PhysicsParams, clips: motion_lib.MotionClips,
                     state: RobotState, clip_idx, t0, controls, terrain_fn=None,
                     weights=tracking.TrackingWeights()):
    """Roll `controls` (..., H, 12) joint-target deltas from `state` at clip
    time t0; returns (total_cost (...,), final_state, per-step costs (..., H)).

    Controls are deltas on the reference joint positions at each step
    (warm-startable around the mocap); falls and dyn-kin divergence add a
    penalty of 5 instead of branching."""
    policy_dt = params.dt * params.substeps
    s, t, costs = state, t0, []
    for h in range(controls.shape[-2]):
        ref = motion_lib.sample_frame(clips, clip_idx, t)
        s = engine.control_step(model, params, s, ref.joint_pos + controls[..., h, :], terrain_fn)
        t = t + policy_dt
        ref_next = motion_lib.sample_frame(clips, clip_idx, t)
        kin = dynamics.forward_kinematics(model, s)
        cost = tracking.tracking_cost(s, kin.p_foot, ref_next, ref_foot_positions(model, ref_next),
                                      weights)
        bad = tracking.fall_terminated(s) | tracking.divergence_terminated(s, ref_next)
        costs.append(cost + 5.0 * bad.to(cost.dtype))
    costs = torch.stack(costs, dim=-1)
    return torch.sum(costs, dim=-1), s, costs

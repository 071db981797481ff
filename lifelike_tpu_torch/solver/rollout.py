"""Readable-engine helpers of the MPC rollouts.

Port of lifelike_tpu.solver.rollout (the part the PMC path uses).
"""
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import dynamics
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

"""Analytic 3-DoF leg inverse kinematics for the MAX quadruped.

Port of lifelike_tpu.robot.ik: closed-form IK for one leg chain of the MAX
robot (hip abduction about +x, hip pitch and knee about -y; geometry from
robot/max_urdf_data.py: joint2 sits (0, +-0.09, 0) from joint1, thigh
0.2115 m, shank 0.24 m, foot sphere fused at the shank tip), on tensors in
their own dtype and device. Used by the mocap retargeter
(motion/retarget.py); no data-dependent branching.

The knee branch is the robot's natural convention (theta3 >= 0, as in the
reference stand pose [-0.028, -0.779, 1.687]).
"""
import numpy as np
import torch

# Leg order FR, FL, HR, HL (robot/model.py LEG_NAMES; clip LegOrder).
# sy = sign of the leg's lateral (y) offsets: right legs -1, left legs +1.
LEG_SY = np.array([-1.0, 1.0, -1.0, 1.0])
HIP_OFFSET = np.array(  # joint1 origin in the base frame (max_urdf_data JOINTS)
    [
        [0.195, -0.06, 0.0],
        [0.195, 0.06, 0.0],
        [-0.195, -0.06, 0.0],
        [-0.195, 0.06, 0.0],
    ]
)
D_HIP = 0.09  # |joint2 y-offset from joint1|
L_THIGH = 0.2115
L_SHANK = 0.24
MAX_REACH = L_THIGH + L_SHANK


def leg_ik(p_rel, sy, eps=1e-9):
    """Joint angles (..., 3) reaching foot position p_rel (..., 3).

    p_rel: foot-sphere center relative to the leg's joint1 origin, in the
    base frame (a tensor). sy: +1 left legs, -1 right legs (broadcastable).
    Targets outside the reachable annulus are projected onto it (the sqrt
    and acos arguments are clamped), so the function is total — callers
    clamp to joint limits separately.

    Branch convention: the knee-positive, foot-below-hip-axis solution
    (planar z' < 0). Configurations with the foot folded above the hip axis
    map to the mirror solution (theta1 shifted by pi).
    """
    px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]
    d = torch.as_tensor(sy, dtype=p_rel.dtype, device=p_rel.device) * D_HIP

    # Abduction: rotate about +x so the leg plane (at lateral offset d)
    # contains the target. In the post-theta1 frame the foot has y' = d.
    rho_sq = py**2 + pz**2
    zp = -torch.sqrt(torch.clamp_min(rho_sq - d**2, eps))
    theta1 = torch.atan2(pz, py) - torch.atan2(zp, d)
    # wrap to (-pi, pi] so straight-down targets give theta1 ~ 0
    theta1 = torch.atan2(torch.sin(theta1), torch.cos(theta1))

    # Planar 2R in the leg plane: x' forward, z' down the leg.
    xp = px
    r_sq = xp**2 + zp**2
    c3 = (r_sq - L_THIGH**2 - L_SHANK**2) / (2.0 * L_THIGH * L_SHANK)
    theta3 = torch.arccos(torch.clamp(c3, -1.0, 1.0))  # knee-positive branch
    psi = torch.atan2(L_SHANK * torch.sin(theta3), L_THIGH + L_SHANK * torch.cos(theta3))
    theta2 = torch.atan2(xp, -zp) - psi

    return torch.stack([theta1, theta2, theta3], dim=-1)


def all_legs_ik(p_rel_all):
    """IK for all four legs at once: p_rel_all (..., 4, 3) -> (..., 4, 3)."""
    return leg_ik(p_rel_all, torch.as_tensor(LEG_SY, dtype=p_rel_all.dtype,
                                             device=p_rel_all.device))


def leg_fk(q, sy):
    """Foot position (..., 3) from joint angles (..., 3), relative to joint1:
    the forward map leg_ik inverts."""
    t1, t2, t3 = q[..., 0], q[..., 1], q[..., 2]
    d = torch.as_tensor(sy, dtype=q.dtype, device=q.device) * D_HIP
    xp = L_THIGH * torch.sin(t2) + L_SHANK * torch.sin(t2 + t3)
    zp = -(L_THIGH * torch.cos(t2) + L_SHANK * torch.cos(t2 + t3))
    # un-rotate the leg plane by theta1 about +x
    c1, s1 = torch.cos(t1), torch.sin(t1)
    py = d * c1 - zp * s1
    pz = d * s1 + zp * c1
    return torch.stack([xp, py, pz], dim=-1)

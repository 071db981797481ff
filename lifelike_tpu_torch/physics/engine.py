"""Physics stepping for the MAX quadruped: PD control + dynamics + contact.

Port of lifelike_tpu.physics.engine: 10 PD substeps at 500 Hz per 50 Hz
control step. PD law as reference legged_robot.py:119-148: targets clipped
to +-3 rad, tau = kp (q* - q) + kd (0 - qd), clipped to +-max_tau; URDF
joint damping and smoothed Coulomb joint friction act as passive torques,
plus a joint-limit spring/damper. Contact is against flat ground (or a
heightmap `terrain_fn`) and, with `scene=`, against every box of a
scene.boxes.BoxScene: feet, wheels and a six-sphere trunk proxy.

This readable batch-leading engine is the plant of the closed loops
(envs.primitive, envs.playground); the MPPI rollouts run the tile-layout
twin engine_tl, or the CUDA kernels on the card.
"""
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.math.quat import cross
from lifelike_tpu_torch.physics import dynamics
from lifelike_tpu_torch.physics.contact import (
    ContactParams,
    sphere_boxes_force,
    sphere_ground_force,
)
from lifelike_tpu_torch.physics.dynamics import RobotState, as_const


class PhysicsParams(NamedTuple):
    """Per-episode physics configuration."""

    kp: float = 50.0  # reference example_pmc_train.sh:75
    kd: float = 0.5
    max_tau: float = 18.0
    foot_friction: float = 0.5
    dt: float = 1.0 / 500.0
    substeps: int = 10
    ext_force: np.ndarray = np.zeros(3, np.float32)  # base push force (world)
    contact: ContactParams = ContactParams()
    # Frozen-mass fast path (tile-layout engine and kernel only): refactor
    # the mass matrix / Schur Cholesky every `mass_freeze` substeps, counted
    # from the start of each control step. 1 = exact.
    mass_freeze: int = 1


_LIMIT_K = 300.0  # joint-limit spring (N m / rad)
_LIMIT_D = 2.0
_TGT_CLIP = 3.0  # reference legged_robot.py:126
# Trunk collision proxy vs boxes: six r=0.07 spheres on a 3x2 grid in the
# body x/y plane, covering the ~0.36 x 0.22 x 0.12 m trunk. float32 on
# purpose: both engines and the CUDA kernel use these rounded values.
_TRUNK_RADIUS = 0.07
_TRUNK_OFFSETS = np.array(
    [[-0.12, -0.05, 0.0], [-0.12, 0.05, 0.0],
     [0.0, -0.05, 0.0], [0.0, 0.05, 0.0],
     [0.12, -0.05, 0.0], [0.12, 0.05, 0.0]], np.float32
)
# The hard-contact plant (physics/impulse.py) collides a denser 5x3 grid of
# the same r=0.07 spheres against boxes: at 0.06 / 0.05 m spacing the
# valleys between spheres are ~1.1 cm deep, so a hole bar's lower edge
# slides across the trunk instead of catching between spheres. The
# compliant plant and the rollouts keep the 3x2 proxy.
_TRUNK_OFFSETS_HARD = np.array(
    [[x, y, 0.0]
     for x in (-0.12, -0.06, 0.0, 0.06, 0.12)
     for y in (-0.05, 0.0, 0.05)], np.float32
)


def pd_torques(model, params: PhysicsParams, joint_pos, joint_vel, target_q):
    tgt = torch.clamp(target_q, -_TGT_CLIP, _TGT_CLIP)
    tau = params.kp * (tgt - joint_pos) + params.kd * (0.0 - joint_vel)
    return torch.clamp(tau, -params.max_tau, params.max_tau)


def passive_torques(model, joint_pos, joint_vel):
    damping = as_const(model.joint_damping, joint_pos).reshape(-1)
    friction = as_const(model.joint_friction, joint_pos).reshape(-1)
    # Coulomb friction smoothed over 0.5 rad/s
    tau = -damping * joint_vel - friction * torch.tanh(joint_vel / 0.5)
    lower = as_const(model.joint_lower_flat, joint_pos)
    upper = as_const(model.joint_upper_flat, joint_pos)
    below = torch.clamp_max(joint_pos - lower, 0.0)
    above = torch.clamp_min(joint_pos - upper, 0.0)
    tau = tau - _LIMIT_K * (below + above)
    return tau - _LIMIT_D * joint_vel * ((below < 0.0) | (above > 0.0))


def _terrain_plane(p):
    """Flat ground: height 0, normal +z. p: (..., 3)."""
    h = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    n = torch.zeros_like(p)
    n[..., 2] = 1.0
    return h, n


def substep(model, params: PhysicsParams, state: RobotState, target_q, terrain_fn=None,
            scene=None):
    """One 500 Hz physics substep (semi-implicit Euler).

    terrain_fn: p (..., 4, 3) -> (heights, normals), flat ground by default.
    scene: optional scene.boxes.BoxScene — box SDF forces (tops and vertical
    faces alike) on the feet, the wheels and the trunk proxy, on top of the
    ground contact."""
    terrain_fn = terrain_fn or _terrain_plane
    kin = dynamics.forward_kinematics(model, state)
    origin = state.base_pos

    tau_act = pd_torques(model, params, state.joint_pos, state.joint_vel, target_q)
    tau_j = (tau_act + passive_torques(model, state.joint_pos, state.joint_vel)).reshape(
        state.joint_pos.shape[:-1] + (4, 3)
    )
    tau_b = torch.zeros(
        state.base_pos.shape[:-1] + (6,), dtype=state.base_pos.dtype,
        device=state.base_pos.device,
    )

    # foot contacts (sphere fixed to the shank tips, link index 2)
    h, n = terrain_fn(kin.p_foot)
    f_foot = sphere_ground_force(
        kin.p_foot, kin.v_foot, model.foot_radius, h, n, params.contact,
        mu=params.foot_friction,
    )
    if scene is not None:
        f_foot = f_foot + sphere_boxes_force(
            kin.p_foot, kin.v_foot, model.foot_radius, scene.center, scene.half,
            scene.active, params.contact, params.foot_friction,
        )
    tb, tj = dynamics.point_force_to_generalized(kin, origin, kin.p_foot, f_foot, 2)
    tau_b = tau_b + tb
    tau_j = tau_j + tj

    # wheel contacts (fixed to the thighs, link index 1)
    v_wheel = kin.v_link_origin[..., :, 1, :] + cross(
        kin.w_link[..., :, 1, :], kin.p_wheel - kin.p_joint[..., :, 1, :]
    )
    hw, nw = terrain_fn(kin.p_wheel)
    f_wheel = sphere_ground_force(
        kin.p_wheel, v_wheel, model.wheel_radius, hw, nw, params.contact,
        mu=params.foot_friction,
    )
    if scene is not None:
        f_wheel = f_wheel + sphere_boxes_force(
            kin.p_wheel, v_wheel, model.wheel_radius, scene.center, scene.half,
            scene.active, params.contact, params.foot_friction,
        )
    tb, tj = dynamics.point_force_to_generalized(kin, origin, kin.p_wheel, f_wheel, 1)
    tau_b = tau_b + tb
    tau_j = tau_j + tj

    if scene is not None:
        # trunk proxy vs boxes only (the trunk never reaches the plane before
        # a fall ends the episode): a base wrench about the base origin
        offs_w = torch.einsum("...ij,pj->...pi", kin.R_base, as_const(_TRUNK_OFFSETS, origin))
        p_tr = state.base_pos[..., None, :] + offs_w
        v_tr = state.base_lin_vel[..., None, :] + cross(state.base_ang_vel[..., None, :], offs_w)
        f_tr = sphere_boxes_force(
            p_tr, v_tr, _TRUNK_RADIUS, scene.center, scene.half, scene.active,
            params.contact, params.foot_friction,
        )  # (..., 6, 3)
        tau_b = tau_b + torch.cat(
            [torch.sum(cross(offs_w, f_tr), dim=-2), torch.sum(f_tr, dim=-2)], dim=-1
        )

    # external world-frame force on the base origin (push randomizer)
    ext = torch.broadcast_to(as_const(params.ext_force, origin), origin.shape)
    tau_b = tau_b + torch.cat([torch.zeros_like(ext), ext], dim=-1)

    bias_b, bias_j = dynamics.bias_forces(model, kin, state, origin)
    Mb, F, Ml = dynamics.mass_matrix_blocks(model, kin, origin, state.base_pos)
    a_base, qdd = dynamics.forward_dynamics(Mb, F, Ml, tau_b - bias_b, tau_j - bias_j)

    # spatial -> point acceleration of the base origin
    w = state.base_ang_vel
    a_lin = a_base[..., 3:] + cross(w, state.base_lin_vel)
    a_ang = a_base[..., :3]

    dt = params.dt
    new_lin = state.base_lin_vel + a_lin * dt
    new_ang = w + a_ang * dt
    new_qd = state.joint_vel + qdd.reshape(state.joint_vel.shape) * dt
    return RobotState(
        base_pos=state.base_pos + new_lin * dt,
        base_orn=quat.integrate(state.base_orn, new_ang, dt),
        base_lin_vel=new_lin,
        base_ang_vel=new_ang,
        joint_pos=state.joint_pos + new_qd * dt,
        joint_vel=new_qd,
    )


def control_step(model, params: PhysicsParams, state: RobotState, target_q, terrain_fn=None,
                 scene=None):
    """One 50 Hz control step = `substeps` physics substeps with a held target
    (reference primitive_level_env.py:202-210)."""
    for _ in range(params.substeps):
        state = substep(model, params, state, target_q, terrain_fn, scene=scene)
    return state


def make_control_step(model, params: PhysicsParams, terrain_fn=None, scene=None):
    """f(state, target_q) -> state."""
    return partial(control_step, model, params, terrain_fn=terrain_fn, scene=scene)

"""Tile-layout physics stepping.

Port of lifelike_tpu.physics.engine_tl: the PD law, passive torques,
compliant contact (the ground plane or a heightmap `terrain_fn`, and with
`scene=` the box SDF forces on feet, wheels and the trunk proxy) and
semi-implicit Euler integration of physics.engine, with every field
batch-trailing (see physics.batched).

`control_step` here is the plain PyTorch version of the CUDA kernels'
physics (csrc/scalar_phys.cuh): the kernels are held against it.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.math import quat_tl
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics.batched import TLConstants, TLState
from lifelike_tpu_torch.physics.contact import ContactParams
from lifelike_tpu_torch.physics.engine import (
    _LIMIT_D,
    _LIMIT_K,
    _TGT_CLIP,
    _TRUNK_OFFSETS,
    _TRUNK_RADIUS,
    PhysicsParams,
)


def _plane_terrain(p):
    """p: (4, 3, Bs, L) -> heights (4, Bs, L), normals (4, 3, Bs, L)."""
    h = torch.zeros_like(p[:, 0])
    n = torch.zeros_like(p)
    n[:, 2] = 1.0
    return h, n


def sphere_ground_force(pos, vel, radius, h, n, cp: ContactParams, mu):
    """Tile-layout contact.sphere_ground_force.

    pos/vel/n: (4, 3, Bs, L); h: (4, Bs, L); mu broadcastable to (4, Bs, L).
    """
    gap = (pos[:, 2] - h) - radius
    pen = torch.clamp_min(-gap, 0.0)
    in_contact = pen > 0.0
    vn = torch.sum(vel * n, dim=1)
    fn = cp.kn * pen + cp.dn * torch.clamp_min(-vn, 0.0) * in_contact
    fn = torch.clamp_min(fn, 0.0) * in_contact
    vt = vel - vn[:, None] * n
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=1) + 1e-12)
    coef = torch.clamp_max(
        mu * fn / torch.sqrt(vt_norm**2 + cp.v_slip**2), cp.fric_visc_cap
    )
    return fn[:, None] * n - coef[:, None] * vt


class TLScene(NamedTuple):
    """Box scene in tile layout: one scenario broadcast over the population.

    center/half: (N, 3, 1, 1); active: (N, 1, 1) float mask.
    """

    center: torch.Tensor
    half: torch.Tensor
    active: torch.Tensor


def tl_scene(scene) -> TLScene:
    """Lift an unbatched scene.boxes.BoxScene into tile layout."""
    return TLScene(
        center=scene.center[..., None, None],
        half=scene.half[..., None, None],
        active=scene.active.to(scene.center.dtype)[..., None, None],
    )


def sphere_boxes_force(pos, vel, radius, ts: TLScene, cp: ContactParams, mu):
    """Tile-layout contact.sphere_boxes_force: per-box SDF penalty forces.

    pos/vel: (P, 3, Bs, L); returns (P, 3, Bs, L) forces summed over the N
    boxes. Inside a box the pushout normal is averaged over the faces tied
    for the least penetration (edges and corners)."""
    r = pos[:, None] - ts.center[None]  # (P, N, 3, Bs, L)
    q = r.abs() - ts.half[None]
    outside = torch.clamp_min(q, 0.0)
    d_out = torch.sqrt(torch.sum(outside * outside, dim=2) + 1e-9)  # (P, N, Bs, L)
    d_in = torch.amax(q, dim=2)
    inside = d_in < 0.0
    dist = torch.where(inside, d_in, d_out)
    sign = torch.where(r >= 0.0, 1.0, -1.0).to(pos.dtype)
    face = (q >= torch.amax(q, dim=2, keepdim=True)).to(pos.dtype)
    face = face / torch.sum(face, dim=2, keepdim=True).clamp_min(1.0)
    normal = torch.where(inside[:, :, None], sign * face, sign * outside / d_out[:, :, None])

    pen = torch.clamp_min(radius - dist, 0.0)
    in_contact = pen > 0.0
    v = vel[:, None]
    vn = torch.sum(v * normal, dim=2)
    fn = cp.kn * pen + cp.dn * torch.clamp_min(-vn, 0.0) * in_contact
    fn = torch.clamp_min(fn, 0.0) * in_contact
    vt = v - vn[:, :, None] * normal
    vt_norm2 = torch.sum(vt * vt, dim=2)
    coef = torch.clamp_max(
        mu * fn / torch.sqrt(vt_norm2 + 1e-12 + cp.v_slip**2), cp.fric_visc_cap
    )
    f = fn[:, :, None] * normal - coef[:, :, None] * vt
    return torch.sum(f * ts.active[None, :, None], dim=1)


def pd_torques(c: TLConstants, params: PhysicsParams, joint_pos, joint_vel, target_q):
    """target_q: (4, 3, Bs, L) or broadcastable. Reference legged_robot.py:119-148."""
    tgt = torch.clamp(target_q, -_TGT_CLIP, _TGT_CLIP)
    tau = params.kp * (tgt - joint_pos) + params.kd * (0.0 - joint_vel)
    return torch.clamp(tau, -params.max_tau, params.max_tau)


def passive_torques(c: TLConstants, joint_pos, joint_vel):
    tau = -c.damping * joint_vel - c.friction * torch.tanh(joint_vel / 0.5)
    below = torch.clamp_max(joint_pos - c.lower, 0.0)
    above = torch.clamp_min(joint_pos - c.upper, 0.0)
    tau = tau - _LIMIT_K * (below + above)
    return tau - _LIMIT_D * joint_vel * ((below < 0.0) | (above > 0.0))


class Frozen(NamedTuple):
    """Mass-side quantities factored once per `mass_freeze` substeps, all
    referenced about the world point `origin` (base position at freeze time)."""

    origin: torch.Tensor  # (3, Bs, L)
    terms: B.LegTerms
    fac: B.DynFactors


def freeze_mass(c: TLConstants, s: TLState) -> Frozen:
    kin = B.fk(c, s)
    origin = s.base_pos
    terms = B.leg_terms(c, kin, origin)
    Mb, F, Ml = B.mass_blocks(c, kin, origin, s.base_pos, terms=terms)
    return Frozen(origin=origin, terms=terms, fac=B.factor_dynamics(Mb, F, Ml))


def substep(c: TLConstants, params: PhysicsParams, s: TLState, target_q,
            terrain_fn=None, frozen: Frozen = None, scene: TLScene = None):
    """One 500 Hz step. terrain_fn: p (4, 3, Bs, L) -> (heights (4, Bs, L),
    normals (4, 3, Bs, L)) under the feet and wheels, the plane by default.
    `frozen`: optional freeze_mass output — the mass factorization and leg
    terms are then not rebuilt from the current configuration
    (PhysicsParams.mass_freeze fast path). `scene`: box contact on feet,
    wheels and the trunk proxy, on top of the ground."""
    terrain_fn = terrain_fn or _plane_terrain
    kin = B.fk(c, s)
    if frozen is None:
        origin = s.base_pos
        terms = B.leg_terms(c, kin, origin)
    else:
        origin = frozen.origin
        terms = frozen.terms

    tau_j = pd_torques(c, params, s.joint_pos, s.joint_vel, target_q)
    tau_j = tau_j + passive_torques(c, s.joint_pos, s.joint_vel)
    tau_b = torch.zeros_like(torch.cat([s.base_ang_vel, s.base_lin_vel], dim=0))

    mu = params.foot_friction
    h, n = terrain_fn(kin.p_foot)
    f_foot = sphere_ground_force(
        kin.p_foot, kin.v_foot, c.foot_radius, h, n, params.contact, mu
    )
    if scene is not None:
        f_foot = f_foot + sphere_boxes_force(
            kin.p_foot, kin.v_foot, c.foot_radius, scene, params.contact, mu
        )
    tb, tj = B.point_forces_to_generalized(
        kin, origin, kin.p_foot, f_foot, 2, S=terms.S
    )
    tau_b = tau_b + tb
    tau_j = tau_j + tj

    hw, nw = terrain_fn(kin.p_wheel)
    f_wheel = sphere_ground_force(
        kin.p_wheel, kin.v_wheel, c.wheel_radius, hw, nw, params.contact, mu
    )
    if scene is not None:
        f_wheel = f_wheel + sphere_boxes_force(
            kin.p_wheel, kin.v_wheel, c.wheel_radius, scene, params.contact, mu
        )
    tb, tj = B.point_forces_to_generalized(
        kin, origin, kin.p_wheel, f_wheel, 1, S=terms.S
    )
    tau_b = tau_b + tb
    tau_j = tau_j + tj

    if scene is not None:
        # trunk proxy vs boxes: a base wrench about the BASE position (the
        # moment arm is the rotated offset, not p - origin)
        offs = torch.as_tensor(_TRUNK_OFFSETS, dtype=s.base_pos.dtype,
                               device=s.base_pos.device)
        offs_w = [torch.einsum("ij...,j->i...", kin.R_base, o) for o in offs]
        pos = torch.stack([s.base_pos + o for o in offs_w])
        vel = torch.stack([s.base_lin_vel + quat_tl.cross(s.base_ang_vel, o) for o in offs_w])
        f_tr = sphere_boxes_force(pos, vel, _TRUNK_RADIUS, scene, params.contact, mu)
        torque = sum(quat_tl.cross(o, f_tr[p]) for p, o in enumerate(offs_w))
        tau_b = tau_b + torch.cat([torque, torch.sum(f_tr, dim=0)], dim=0)

    ext = torch.as_tensor(params.ext_force, dtype=s.base_pos.dtype,
                          device=s.base_pos.device).reshape(3, 1, 1)
    tau_b = torch.cat([tau_b[:3], tau_b[3:] + ext], dim=0)

    w = s.base_ang_vel
    if frozen is None:
        bias_b, bias_j = B.bias_forces(c, kin, s, origin, terms=terms)
        Mb, F, Ml = B.mass_blocks(c, kin, origin, s.base_pos, terms=terms)
        a_base, qdd = B.forward_dynamics(Mb, F, Ml, tau_b - bias_b, tau_j - bias_j)
        a_lin = a_base[3:] + quat_tl.cross(w, s.base_lin_vel)
    else:
        # Everything stays referenced at the frozen origin O: the base
        # spatial velocity there is [w; v + w x (O - p)], and the solved
        # linear acceleration transfers back with the alpha x (p - O) term.
        r = s.base_pos - origin
        v_at_o = torch.cat([w, s.base_lin_vel - quat_tl.cross(w, r)], dim=0)
        bias_b, bias_j = B.bias_forces(c, kin, s, origin, terms=terms, v_base=v_at_o)
        a_base, qdd = B.forward_dynamics_apply(
            frozen.fac, tau_b - bias_b, tau_j - bias_j
        )
        a_lin = (
            a_base[3:]
            + quat_tl.cross(a_base[:3], r)
            + quat_tl.cross(w, s.base_lin_vel)
        )
    a_ang = a_base[:3]

    dt = params.dt
    new_lin = s.base_lin_vel + a_lin * dt
    new_ang = w + a_ang * dt
    new_qd = s.joint_vel + qdd * dt
    return TLState(
        base_pos=s.base_pos + new_lin * dt,
        base_orn=quat_tl.integrate(s.base_orn, new_ang, dt),
        base_lin_vel=new_lin,
        base_ang_vel=new_ang,
        joint_pos=s.joint_pos + new_qd * dt,
        joint_vel=new_qd,
    )


def control_step(c: TLConstants, params: PhysicsParams, s: TLState, target_q,
                 terrain_fn=None, scene: TLScene = None):
    """One 50 Hz control step: `substeps` physics substeps with a held target.

    With mass_freeze > 1 the mass matrix is refactored at substep
    i % mass_freeze == 0, counted from the start of this control step."""
    freeze = max(int(params.mass_freeze), 1)
    frozen = None
    for i in range(params.substeps):
        if freeze > 1 and i % freeze == 0:
            frozen = freeze_mass(c, s)
        s = substep(c, params, s, target_q, terrain_fn, frozen=frozen, scene=scene)
    return s

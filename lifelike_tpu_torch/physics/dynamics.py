"""Batched rigid-body dynamics for the MAX quadruped (readable oracle).

Port of lifelike_tpu.physics.dynamics. The fixed topology — a floating base
with four independent 3-DoF legs — vectorizes over (batch, legs):

  * forward kinematics / velocities: closed-form chains, all four legs at once
  * mass matrix: world-frame CRBA about the base origin; the joint-joint block
    is four 3x3 blocks, so forward dynamics is four 3x3 solves plus one 6x6
    Schur-complement solve
  * bias forces: world-frame RNEA with the gravity-as-base-acceleration trick

Spatial vectors are [angular; linear] at a common origin (the base position)
in world axes. State: base_pos, base_orn (xyzw), base_lin_vel, base_ang_vel
(world frame), joint_pos, joint_vel (..., 12) leg-major FR,FL,HR,HL.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.math.quat import cross
from lifelike_tpu_torch.math.spatial import (
    apply_inertia,
    cross_force,
    cross_motion,
    skew,
    spatial_inertia,
)

GRAVITY = 9.80665  # matches reference legged_robot.py:260


class RobotState(NamedTuple):
    """Every leaf has an identical leading batch shape."""

    base_pos: torch.Tensor  # (..., 3)
    base_orn: torch.Tensor  # (..., 4) xyzw
    base_lin_vel: torch.Tensor  # (..., 3) world
    base_ang_vel: torch.Tensor  # (..., 3) world
    joint_pos: torch.Tensor  # (..., 12)
    joint_vel: torch.Tensor  # (..., 12)


class Kinematics(NamedTuple):
    """Forward-kinematics products reused by dynamics, contact and costs."""

    R_base: torch.Tensor  # (..., 3, 3)
    R_link: torch.Tensor  # (..., 4, 3, 3, 3) world rotation per leg link
    p_joint: torch.Tensor  # (..., 4, 3, 3) world joint positions [leg, link]
    axis_w: torch.Tensor  # (..., 4, 3, 3) world joint axes
    p_foot: torch.Tensor  # (..., 4, 3) world foot-sphere centers
    v_foot: torch.Tensor  # (..., 4, 3) world foot-sphere velocities
    p_wheel: torch.Tensor  # (..., 4, 3) world wheel centers
    w_link: torch.Tensor  # (..., 4, 3, 3) world angular velocity per link
    v_link_origin: torch.Tensor  # (..., 4, 3, 3) world velocity of link origins


def as_const(x, like):
    """Model constant (numpy / float) as a tensor of `like`'s dtype/device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _axis_rotation(axis, angle):
    """Rotation matrix exp(skew(axis) * angle); axis is unit, static."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    KK = K @ K
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * KK


def forward_kinematics(model, state: RobotState) -> Kinematics:
    ref = state.base_pos
    q = state.joint_pos.reshape(state.joint_pos.shape[:-1] + (4, 3))
    qd = state.joint_vel.reshape(q.shape)
    R_base = quat.to_matrix(state.base_orn)

    offs = as_const(model.joint_offset, ref)  # (4, 3, 3)
    axes = as_const(model.joint_axis, ref)

    R_link, p_joint, axis_w, w_link, v_origin = [], [], [], [], []
    R_parent = R_base[..., None, :, :]  # (..., 1->4, 3, 3)
    p_parent = state.base_pos[..., None, :]
    w_parent = state.base_ang_vel[..., None, :]
    v_parent = state.base_lin_vel[..., None, :]
    for j in range(3):
        p_j = p_parent + torch.einsum("...lij,lj->...li", R_parent, offs[:, j])
        v_j = v_parent + cross(w_parent, p_j - p_parent)
        a_w = torch.einsum("...lij,lj->...li", R_parent, axes[:, j])
        R_j = R_parent @ _axis_rotation(axes[:, j], q[..., j])
        w_j = w_parent + a_w * qd[..., j : j + 1]
        R_link.append(R_j)
        p_joint.append(p_j)
        axis_w.append(a_w)
        w_link.append(w_j)
        v_origin.append(v_j)
        R_parent, p_parent, w_parent, v_parent = R_j, p_j, w_j, v_j

    R_link = torch.stack(R_link, dim=-3)  # (..., 4 legs, 3 links, 3, 3)
    p_joint = torch.stack(p_joint, dim=-2)  # (..., 4, 3, 3)
    axis_w = torch.stack(axis_w, dim=-2)
    w_link = torch.stack(w_link, dim=-2)
    v_origin = torch.stack(v_origin, dim=-2)

    foot_off = as_const(model.foot_offset, ref)  # (4, 3)
    R3 = R_link[..., :, 2, :, :]
    p_foot = p_joint[..., :, 2, :] + torch.einsum("...lij,lj->...li", R3, foot_off)
    v_foot = v_origin[..., :, 2, :] + cross(
        w_link[..., :, 2, :], p_foot - p_joint[..., :, 2, :]
    )
    wheel_off = as_const(model.wheel_offset, ref)
    R2 = R_link[..., :, 1, :, :]
    p_wheel = p_joint[..., :, 1, :] + torch.einsum("...lij,lj->...li", R2, wheel_off)

    return Kinematics(
        R_base=R_base,
        R_link=R_link,
        p_joint=p_joint,
        axis_w=axis_w,
        p_foot=p_foot,
        v_foot=v_foot,
        p_wheel=p_wheel,
        w_link=w_link,
        v_link_origin=v_origin,
    )


def _link_spatial_inertias(model, kin: Kinematics, origin):
    """Spatial inertia of each leg link about `origin`, world axes:
    (..., 4, 3, 6, 6)."""
    mass = as_const(model.link_mass, origin)  # (4, 3)
    com = as_const(model.link_com, origin)  # (4, 3, 3)
    Icom = as_const(model.link_inertia, origin)  # (4, 3, 3, 3)
    R = kin.R_link  # (..., 4, 3, 3, 3)
    com_w = kin.p_joint + torch.einsum("...lkij,lkj->...lki", R, com)
    I_world = R @ Icom @ R.transpose(-1, -2)
    d = com_w - origin[..., None, None, :]
    return spatial_inertia(mass[..., :, :, None, None], d, I_world)


def _base_spatial_inertia(model, kin: Kinematics, origin, base_pos):
    com_w = base_pos + torch.einsum(
        "...ij,j->...i", kin.R_base, as_const(model.base_com, origin)
    )
    I_world = kin.R_base @ as_const(model.base_inertia, origin) @ kin.R_base.transpose(
        -1, -2
    )
    d = com_w - origin
    return spatial_inertia(model.base_mass, d, I_world)


def _motion_subspaces(kin: Kinematics, origin):
    """Revolute motion subspaces about the common origin: S = [a; a x (O - p)],
    (..., 4, 3, 6)."""
    a = kin.axis_w
    r = origin[..., None, None, :] - kin.p_joint
    return torch.cat([a, cross(a, r)], dim=-1)


def mass_matrix_blocks(model, kin: Kinematics, origin, base_pos):
    """World-frame CRBA exploiting leg independence.

    Returns (Mb (..., 6, 6), F (..., 4, 3, 6), Ml (..., 4, 3, 3)).
    """
    I_links = _link_spatial_inertias(model, kin, origin)  # (...,4,3,6,6)
    S = _motion_subspaces(kin, origin)  # (...,4,3,6)
    # composite inertia per joint: reverse cumsum along the link axis
    Ic = torch.flip(torch.cumsum(torch.flip(I_links, dims=(-3,)), dim=-3), dims=(-3,))
    F = torch.einsum("...ljab,...ljb->...lja", Ic, S)
    SI = torch.einsum("...lia,...ljab->...lijb", S, Ic)  # S_i^T Ic_j
    H = torch.einsum("...lijb,...ljb->...lij", SI, S)
    iu = torch.triu(torch.ones((3, 3), dtype=torch.bool, device=H.device))
    Ml = torch.where(iu, H, H.transpose(-1, -2))
    Mb = _base_spatial_inertia(model, kin, origin, base_pos) + torch.sum(
        I_links, dim=(-4, -3)
    )
    return Mb, F, Ml


def bias_forces(model, kin: Kinematics, state: RobotState, origin):
    """World-frame RNEA with qdd = 0: (tau_base (..., 6), tau_joint (..., 4, 3))."""
    dtype = state.base_pos.dtype
    qd = state.joint_vel.reshape(state.joint_vel.shape[:-1] + (4, 3))
    S = _motion_subspaces(kin, origin)  # (...,4,3,6)

    v_base = torch.cat([state.base_ang_vel, state.base_lin_vel], dim=-1)
    a_grav = torch.zeros_like(v_base)
    a_grav[..., 5] = GRAVITY

    v_parent = v_base[..., None, :]
    a_parent = a_grav[..., None, :]
    v_links, a_links = [], []
    for j in range(3):
        Sj = S[..., :, j, :]
        vj = v_parent + Sj * qd[..., j : j + 1]
        aj = a_parent + cross_motion(v_parent, Sj) * qd[..., j : j + 1]
        v_links.append(vj)
        a_links.append(aj)
        v_parent, a_parent = vj, aj
    v_links = torch.stack(v_links, dim=-2)  # (...,4,3,6)
    a_links = torch.stack(a_links, dim=-2)

    I_links = _link_spatial_inertias(model, kin, origin)  # (...,4,3,6,6)
    f_links = apply_inertia(I_links, a_links) + cross_force(
        v_links, apply_inertia(I_links, v_links)
    )
    f_acc = torch.flip(torch.cumsum(torch.flip(f_links, dims=(-2,)), dim=-2), dims=(-2,))
    tau_joint = torch.einsum("...ljb,...ljb->...lj", S, f_acc)

    I_base = _base_spatial_inertia(model, kin, origin, state.base_pos)
    f_base = apply_inertia(I_base, a_grav) + cross_force(
        v_base, apply_inertia(I_base, v_base)
    )
    tau_base = f_base + torch.sum(f_links, dim=(-3, -2))
    return tau_base.to(dtype), tau_joint.to(dtype)


def point_force_to_generalized(kin: Kinematics, origin, points, forces, link_index):
    """World-frame point forces (..., 4, 3), one per leg on link `link_index`
    -> (tau_base (..., 6), tau_joint (..., 4, 3))."""
    n = cross(points - origin[..., None, :], forces)
    Fsp = torch.cat([n, forces], dim=-1)  # (...,4,6)
    tau_base = torch.sum(Fsp, dim=-2)
    S = _motion_subspaces(kin, origin)
    tau_joint = torch.einsum("...ljb,...lb->...lj", S, Fsp)
    mask = (torch.arange(3, device=tau_joint.device) <= link_index).to(tau_joint.dtype)
    return tau_base, tau_joint * mask


def _inv3_sym(A, reg=1e-9):
    """Closed-form inverse of symmetric 3x3 blocks (..., 3, 3)."""
    a = A[..., 0, 0] + reg
    b = A[..., 0, 1]
    c = A[..., 0, 2]
    d = A[..., 1, 1] + reg
    e = A[..., 1, 2]
    f = A[..., 2, 2] + reg
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / det
    r0 = torch.stack([A11, A12, A13], dim=-1)
    r1 = torch.stack([A12, A22, A23], dim=-1)
    r2 = torch.stack([A13, A23, A33], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2) * inv_det[..., None, None]


def _chol6(A, reg=1e-9):
    """Unrolled Cholesky of SPD (..., 6, 6) blocks -> nested lower factor."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j] + reg
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp_min(s, 1e-12))
        L[j][j] = Ljj
        inv_Ljj = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj
    return L


def _chol6_solve(L, b):
    """Solve L L^T x = b for b (..., 6, n) given the factor from _chol6."""
    n = 6
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return torch.stack(x, dim=-2)


class DynFactorsBL(NamedTuple):
    """Factored structured mass matrix, batch-leading layout."""

    F: torch.Tensor  # (..., 4, 3, 6)
    Ml_inv: torch.Tensor  # (..., 4, 3, 3)
    FtMinv: torch.Tensor  # (..., 4, 3, 6)
    chol: list  # nested lower Cholesky factor of the 6x6 Schur complement


def factor_dynamics(Mb, F, Ml, reg=1e-9) -> DynFactorsBL:
    Ml_inv = _inv3_sym(Ml, reg)
    FtMinv = torch.einsum("...lij,...lja->...lia", Ml_inv, F)
    Schur = Mb - torch.einsum("...lja,...ljb->...ab", F, FtMinv)
    return DynFactorsBL(F=F, Ml_inv=Ml_inv, FtMinv=FtMinv, chol=_chol6(Schur, reg))


def forward_dynamics_apply(fac: DynFactorsBL, tau_base, tau_joint):
    """tau_base (..., 6), tau_joint (..., 4, 3) -> (a_base (..., 6), qdd (..., 4, 3))."""
    rhs = tau_base - torch.einsum("...lja,...lj->...a", fac.FtMinv, tau_joint)
    a_base = _chol6_solve(fac.chol, rhs[..., None])[..., 0]
    qdd = torch.einsum(
        "...lij,...lj->...li", fac.Ml_inv,
        tau_joint - torch.einsum("...lja,...a->...lj", fac.F, a_base),
    )
    return a_base, qdd


def minv_apply_rows(fac: DynFactorsBL, rows):
    """Apply M^{-1} to n stacked generalized-force rows (..., n, 18) with the
    shared factorization (the impulse plant's constraint rows reuse the
    substep's forward-dynamics factor). Returns (..., n, 18)."""
    rhs_b = rows[..., :, :6]
    rhs_j = rows[..., :, 6:].reshape(rows.shape[:-1] + (4, 3))
    rhs = rhs_b - torch.einsum("...lja,...nlj->...na", fac.FtMinv, rhs_j)
    a_b = _chol6_solve(fac.chol, rhs.transpose(-1, -2)).transpose(-1, -2)  # (..., n, 6)
    qdd = torch.einsum(
        "...lij,...nlj->...nli", fac.Ml_inv,
        rhs_j - torch.einsum("...lja,...na->...nlj", fac.F, a_b),
    )
    return torch.cat([a_b, qdd.reshape(qdd.shape[:-2] + (12,))], dim=-1)


def forward_dynamics(Mb, F, Ml, tau_base, tau_joint, reg=1e-9):
    """Solve [[Mb, F^T], [F, Ml]] [a_b; qdd] = [tau_base; tau_joint] by the
    Schur complement on the 6x6 base block."""
    return forward_dynamics_apply(factor_dynamics(Mb, F, Ml, reg), tau_base, tau_joint)

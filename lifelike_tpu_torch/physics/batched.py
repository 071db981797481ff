"""Tile-layout physics core: batch-trailing rigid-body dynamics.

Port of lifelike_tpu.physics.batched. Same math as physics.dynamics, laid
out with the small structure axes (legs 4, links 3, spatial 3/6) LEADING and
the candidate batch TRAILING as two axes (Bs, L). On the GPU the trailing
axes are contiguous, so every small elementwise op reads and writes whole
coalesced rows — and this module is the plain PyTorch version of the CUDA
rollout kernel's physics (csrc/scalar_phys.cuh).

Linear solves are closed-form and elementwise over the batch: a cofactor
inverse for the per-leg 3x3 joint blocks and an unrolled Cholesky for the
6x6 base Schur complement.

State (TLState): base_pos (3, Bs, L), base_orn (4, Bs, L) xyzw,
base_lin_vel / base_ang_vel (3, Bs, L) world frame, joint_pos / joint_vel
(4, 3, Bs, L) leg-major.
"""
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.math import quat_tl
from lifelike_tpu_torch.physics.dynamics import GRAVITY, RobotState

# ---------------------------------------------------------------- state


class TLState(NamedTuple):
    base_pos: torch.Tensor  # (3, Bs, L)
    base_orn: torch.Tensor  # (4, Bs, L)
    base_lin_vel: torch.Tensor  # (3, Bs, L)
    base_ang_vel: torch.Tensor  # (3, Bs, L)
    joint_pos: torch.Tensor  # (4, 3, Bs, L)
    joint_vel: torch.Tensor  # (4, 3, Bs, L)


def map_state(fn, s):
    """Apply `fn` to every leaf of a TLState / RobotState."""
    return type(s)(*(fn(x) for x in s))


def tl_from_state(s: RobotState, batch2d=None) -> TLState:
    """Transpose a batch-leading RobotState (..., k) into tile layout.

    batch2d: optional (Bs, L) to reshape the flattened batch into; defaults
    to (B, 1).
    """

    def t(x, k):
        b = x.shape[: x.ndim - len(k)]
        nb = int(np.prod(b)) if b else 1
        shp = tuple(batch2d) if batch2d is not None else (nb, 1)
        y = torch.movedim(x.reshape((nb,) + tuple(x.shape[len(b):])), 0, -1)
        return y.reshape(tuple(y.shape[:-1]) + shp)

    jp = s.joint_pos.reshape(s.joint_pos.shape[:-1] + (4, 3))
    jv = s.joint_vel.reshape(jp.shape)
    return TLState(
        base_pos=t(s.base_pos, (3,)),
        base_orn=t(s.base_orn, (4,)),
        base_lin_vel=t(s.base_lin_vel, (3,)),
        base_ang_vel=t(s.base_ang_vel, (3,)),
        joint_pos=t(jp, (4, 3)),
        joint_vel=t(jv, (4, 3)),
    )


def state_from_tl(tl: TLState, batch_shape=None) -> RobotState:
    def t(x):
        y = x.reshape(tuple(x.shape[:-2]) + (-1,))
        y = torch.movedim(y, -1, 0)  # (B, structure...)
        if batch_shape is not None:
            y = y.reshape(tuple(batch_shape) + tuple(y.shape[1:]))
        return y

    jp = t(tl.joint_pos)
    return RobotState(
        base_pos=t(tl.base_pos),
        base_orn=t(tl.base_orn),
        base_lin_vel=t(tl.base_lin_vel),
        base_ang_vel=t(tl.base_ang_vel),
        joint_pos=jp.reshape(tuple(jp.shape[:-2]) + (12,)),
        joint_vel=t(tl.joint_vel).reshape(tuple(jp.shape[:-2]) + (12,)),
    )


# ---------------------------------------------------------------- constants


class TLConstants(NamedTuple):
    """Model constants with two trailing singleton batch axes."""

    joint_offset: torch.Tensor  # (4, 3, 3, 1, 1) [leg, link, comp]
    axis_K: torch.Tensor  # (4, 3, 3, 3, 1, 1) skew(axis)
    axis_KK: torch.Tensor  # (4, 3, 3, 3, 1, 1)
    axis: torch.Tensor  # (4, 3, 3, 1, 1)
    link_mass: torch.Tensor  # (4, 3, 1, 1)
    link_com: torch.Tensor  # (4, 3, 3, 1, 1)
    link_inertia: torch.Tensor  # (4, 3, 3, 3, 1, 1)
    base_mass: float
    base_com: torch.Tensor  # (3, 1, 1)
    base_inertia: torch.Tensor  # (3, 3, 1, 1)
    foot_offset: torch.Tensor  # (4, 3, 1, 1)
    foot_radius: float
    wheel_offset: torch.Tensor  # (4, 3, 1, 1)
    wheel_radius: float
    damping: torch.Tensor  # (4, 3, 1, 1)
    friction: torch.Tensor  # (4, 3, 1, 1)
    lower: torch.Tensor  # (4, 3, 1, 1)
    upper: torch.Tensor  # (4, 3, 1, 1)
    link_mass_rc: torch.Tensor  # (4, 3, 1, 1) reverse-cumulated chain masses
    total_mass: float


def _skew_np(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def tl_constants(model, dtype=torch.float32, device="cuda") -> TLConstants:
    """Model constants as tensors on `device` (cast from the float64 numpy
    model in one step, as the reference casts its numpy constants)."""
    dev = _device.resolve_device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def e2(a):
        return torch.as_tensor(
            np.ascontiguousarray(np.asarray(a, np_dtype)[..., None, None]), device=dev
        )

    K = np.stack(
        [[_skew_np(model.joint_axis[l, j]) for j in range(3)] for l in range(4)]
    )
    return TLConstants(
        joint_offset=e2(model.joint_offset),
        axis_K=e2(K),
        axis_KK=e2(K @ K),
        axis=e2(model.joint_axis),
        link_mass=e2(model.link_mass),
        link_com=e2(model.link_com),
        link_inertia=e2(model.link_inertia),
        base_mass=float(model.base_mass),
        base_com=e2(model.base_com),
        base_inertia=e2(model.base_inertia),
        foot_offset=e2(model.foot_offset),
        foot_radius=float(model.foot_radius),
        wheel_offset=e2(model.wheel_offset),
        wheel_radius=float(model.wheel_radius),
        damping=e2(model.joint_damping),
        friction=e2(model.joint_friction),
        lower=e2(model.joint_lower),
        upper=e2(model.joint_upper),
        link_mass_rc=e2(np.flip(np.cumsum(np.flip(model.link_mass, 1), 1), 1)),
        total_mass=float(model.total_mass),
    )


# ---------------------------------------------------------------- small ops


def _mv(M, v):
    """(..., i, j, Bs, L) x (..., j, Bs, L) -> (..., i, Bs, L)."""
    return torch.sum(M * v.unsqueeze(-4), dim=-3)


def _mm(A, B):
    """(..., i, k, Bs, L) @ (..., k, j, Bs, L) -> (..., i, j, Bs, L)."""
    return torch.sum(A.unsqueeze(-3) * B.unsqueeze(-5), dim=-4)


def _dot(a, b):
    return torch.sum(a * b, dim=-3)


def _cross(a, b):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-3
    )


def _skew(c):
    z = torch.zeros_like(c[..., 0, :, :])
    c0, c1, c2 = c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :]
    r0 = torch.stack([z, -c2, c1], dim=-3)
    r1 = torch.stack([c2, z, -c0], dim=-3)
    r2 = torch.stack([-c1, c0, z], dim=-3)
    return torch.stack([r0, r1, r2], dim=-4)


def _rev_cumsum3(x, dim):
    """Reverse cumulative sum over a length-3 axis, unrolled."""
    a0, a1, a2 = torch.movedim(x, dim, 0)
    return torch.stack([a0 + a1 + a2, a1 + a2, a2], dim=dim)


def inv3_sym(A, reg=1e-9):
    """Closed-form inverse of symmetric 3x3 blocks A (..., 3, 3, Bs, L)."""
    a = A[..., 0, 0, :, :] + reg
    b = A[..., 0, 1, :, :]
    c = A[..., 0, 2, :, :]
    d = A[..., 1, 1, :, :] + reg
    e = A[..., 1, 2, :, :]
    f = A[..., 2, 2, :, :] + reg
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / det
    r0 = torch.stack([A11, A12, A13], dim=-3)
    r1 = torch.stack([A12, A22, A23], dim=-3)
    r2 = torch.stack([A13, A23, A33], dim=-3)
    return torch.stack([r0, r1, r2], dim=-4) * inv_det[..., None, None, :, :]


def chol6(A, reg=1e-9):
    """Unrolled Cholesky of SPD 6x6 blocks A (6, 6, Bs, L) -> packed lower
    factor (21, Bs, L), row-major lower-triangle order."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j] + reg
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp_min(s, 1e-12))
        L[j][j] = Ljj
        inv_Ljj = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj
    return torch.stack([L[i][k] for i in range(n) for k in range(i + 1)])


def chol6_solve(Lp, b):
    """Solve L L^T x = b given the packed factor from chol6. b: (6, Bs, L)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    idx = 0
    for i in range(n):
        for k in range(i + 1):
            L[i][k] = Lp[idx]
            idx += 1
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def solve_spd6(A, b, reg=1e-9):
    """Unrolled Cholesky solve of SPD 6x6 systems, elementwise over the
    batch. A: (6, 6, Bs, L), b: (6, Bs, L) -> x: (6, Bs, L)."""
    return chol6_solve(chol6(A, reg), b)


# ---------------------------------------------------------------- kinematics


class TLKin(NamedTuple):
    R_base: torch.Tensor  # (3, 3, Bs, L)
    R_link: torch.Tensor  # (4, 3, 3, 3, Bs, L)
    p_joint: torch.Tensor  # (4, 3, 3, Bs, L) joint origins, world
    axis_w: torch.Tensor  # (4, 3, 3, Bs, L)
    w_link: torch.Tensor  # (4, 3, 3, Bs, L)
    v_origin: torch.Tensor  # (4, 3, 3, Bs, L)
    p_foot: torch.Tensor  # (4, 3, Bs, L)
    v_foot: torch.Tensor  # (4, 3, Bs, L)
    p_wheel: torch.Tensor  # (4, 3, Bs, L)
    v_wheel: torch.Tensor  # (4, 3, Bs, L)


def fk(c: TLConstants, s: TLState) -> TLKin:
    R_base = quat_tl.to_matrix(s.base_orn)  # (3,3,Bs,L)
    q = s.joint_pos  # (4,3,Bs,L)
    qd = s.joint_vel

    R_parent = R_base[None].expand((4,) + tuple(R_base.shape))
    p_parent = s.base_pos[None].expand((4,) + tuple(s.base_pos.shape))
    w_parent = s.base_ang_vel[None].expand((4,) + tuple(s.base_ang_vel.shape))
    v_parent = s.base_lin_vel[None].expand((4,) + tuple(s.base_lin_vel.shape))

    eye = torch.eye(3, dtype=q.dtype, device=q.device)[:, :, None, None]
    Rl, Pj, Aw, Wl, Vo = [], [], [], [], []
    for j in range(3):
        off = c.joint_offset[:, j]  # (4,3,1,1)
        p_j = p_parent + _mv(R_parent, off)
        v_j = v_parent + _cross(w_parent, p_j - p_parent)
        a_w = _mv(R_parent, c.axis[:, j])
        ang = q[:, j]  # (4,Bs,L)
        sn = torch.sin(ang)[:, None, None]
        cs = torch.cos(ang)[:, None, None]
        R_joint = eye + sn * c.axis_K[:, j] + (1.0 - cs) * c.axis_KK[:, j]
        R_j = _mm(R_parent, R_joint)
        w_j = w_parent + a_w * qd[:, j][:, None]
        Rl.append(R_j)
        Pj.append(p_j)
        Aw.append(a_w)
        Wl.append(w_j)
        Vo.append(v_j)
        R_parent, p_parent, w_parent, v_parent = R_j, p_j, w_j, v_j

    R_link = torch.stack(Rl, dim=1)  # (4,3links,3,3,Bs,L)
    p_joint = torch.stack(Pj, dim=1)  # (4,3,3,Bs,L)
    axis_w = torch.stack(Aw, dim=1)
    w_link = torch.stack(Wl, dim=1)
    v_origin = torch.stack(Vo, dim=1)

    R3 = R_link[:, 2]
    p_foot = p_joint[:, 2] + _mv(R3, c.foot_offset)
    v_foot = v_origin[:, 2] + _cross(w_link[:, 2], p_foot - p_joint[:, 2])
    R2 = R_link[:, 1]
    p_wheel = p_joint[:, 1] + _mv(R2, c.wheel_offset)
    v_wheel = v_origin[:, 1] + _cross(w_link[:, 1], p_wheel - p_joint[:, 1])
    return TLKin(
        R_base=R_base,
        R_link=R_link,
        p_joint=p_joint,
        axis_w=axis_w,
        w_link=w_link,
        v_origin=v_origin,
        p_foot=p_foot,
        v_foot=v_foot,
        p_wheel=p_wheel,
        v_wheel=v_wheel,
    )


# ------------------------------------------------------------ inertias/CRBA

# Inertias stay in their 10-parameter form (mass m, first moment h = m*c,
# rotational inertia about the origin I_o) and are applied to 6-vectors
# directly; no (..., 6, 6) spatial matrices are materialized.


def _sym_from_upper(u00, u01, u02, u11, u12, u22):
    """Symmetric (..., 3, 3, Bs, L) matrix from its 6 upper components."""
    r0 = torch.stack([u00, u01, u02], dim=-3)
    r1 = torch.stack([u01, u11, u12], dim=-3)
    r2 = torch.stack([u02, u12, u22], dim=-3)
    return torch.stack([r0, r1, r2], dim=-4)


def _rotate_sym(R, I):
    """R @ I @ R^T for symmetric I, computing only the 6 unique entries."""
    A = _mm(R, I)

    def row(i):
        return A[..., i, :, :, :]

    def rrow(i):
        return R[..., i, :, :, :]

    u00 = _dot(row(0), rrow(0))
    u01 = _dot(row(0), rrow(1))
    u02 = _dot(row(0), rrow(2))
    u11 = _dot(row(1), rrow(1))
    u12 = _dot(row(1), rrow(2))
    u22 = _dot(row(2), rrow(2))
    return _sym_from_upper(u00, u01, u02, u11, u12, u22)


def _shift_sym(m, d):
    """Parallel-axis term m*(d.d*eye - d d^T) from 6 components."""
    d0, d1, d2 = d[..., 0, :, :], d[..., 1, :, :], d[..., 2, :, :]
    dd = d0 * d0 + d1 * d1 + d2 * d2
    return _sym_from_upper(
        m * (dd - d0 * d0),
        -m * (d0 * d1),
        -m * (d0 * d2),
        m * (dd - d1 * d1),
        -m * (d1 * d2),
        m * (dd - d2 * d2),
    )


def _inertia_params_links(c: TLConstants, kin: TLKin, origin):
    """Per-link (h (4,3,3,Bs,L), I_o (4,3,3,3,Bs,L)) about `origin`, world axes."""
    R = kin.R_link
    com_w = kin.p_joint + _mv(R, c.link_com)
    d = com_w - origin[None, None]
    I_cw = _rotate_sym(R, c.link_inertia)
    h = c.link_mass[..., None, :, :] * d
    I_o = I_cw + _shift_sym(c.link_mass, d)
    return h, I_o


def _inertia_params_base(c: TLConstants, kin: TLKin, origin, base_pos):
    com_w = base_pos + _mv(kin.R_base, c.base_com)
    d = com_w - origin
    I_cw = _rotate_sym(kin.R_base, c.base_inertia)
    h = c.base_mass * d
    I_o = I_cw + _shift_sym(c.base_mass, d)
    return h, I_o


def _inertia_apply(m, h, I_o, vec6):
    """[I_o w + h x v ; m v + w x h] for motion vec6 = [w; v]."""
    w = vec6[..., :3, :, :]
    v = vec6[..., 3:, :, :]
    ang = _mv(I_o, w) + _cross(h, v)
    lin = m * v + _cross(w, h)
    return torch.cat([ang, lin], dim=-3)


def motion_subspaces(kin: TLKin, origin):
    """S = [a; a x (O - p)]: (4, 3, 6, Bs, L)."""
    a = kin.axis_w
    r = origin[None, None] - kin.p_joint
    return torch.cat([a, _cross(a, r)], dim=-3)


class LegTerms(NamedTuple):
    """Per-substep shared terms: motion subspaces + link inertia params."""

    S: torch.Tensor  # (4, 3, 6, Bs, L)
    h_l: torch.Tensor  # (4, 3, 3, Bs, L)
    Io_l: torch.Tensor  # (4, 3, 3, 3, Bs, L)


def leg_terms(c: TLConstants, kin: TLKin, origin) -> LegTerms:
    h_l, Io_l = _inertia_params_links(c, kin, origin)
    return LegTerms(S=motion_subspaces(kin, origin), h_l=h_l, Io_l=Io_l)


def mass_blocks(c: TLConstants, kin: TLKin, origin, base_pos, terms=None):
    if terms is None:
        terms = leg_terms(c, kin, origin)
    h_l, Io_l, S = terms.h_l, terms.Io_l, terms.S
    h_c = _rev_cumsum3(h_l, dim=1)
    Io_c = _rev_cumsum3(Io_l, dim=1)
    m_c = c.link_mass_rc[..., None, :, :]  # (4,3,1,1,1)
    F = _inertia_apply(m_c, h_c, Io_c, S)  # (4,3,6,Bs,L)
    # Ml[l,i,j] = S_i . F_j for i <= j
    H = torch.sum(S[:, :, None] * F[:, None, :], dim=-3)  # (4,i,j,Bs,L)
    iu = torch.triu(torch.ones((3, 3), dtype=torch.bool, device=H.device))
    Ml = torch.where(iu[None, :, :, None, None], H, H.transpose(1, 2))
    h_b, Io_b = _inertia_params_base(c, kin, origin, base_pos)
    h_tot = h_b + torch.sum(h_l, dim=(0, 1))
    Io_tot = Io_b + torch.sum(Io_l, dim=(0, 1))
    hx = _skew(h_tot)
    eye = torch.eye(3, dtype=h_tot.dtype, device=h_tot.device)[:, :, None, None]
    m_eye = torch.broadcast_to(c.total_mass * eye, hx.shape)
    top = torch.cat([Io_tot, hx], dim=-3)
    bot = torch.cat([-hx, m_eye], dim=-3)
    Mb = torch.cat([top, bot], dim=-4)
    return Mb, F, Ml


# ---------------------------------------------------------------- RNEA bias


def _cross_motion(v, m):
    w, vl = v[..., :3, :, :], v[..., 3:, :, :]
    mw, ml = m[..., :3, :, :], m[..., 3:, :, :]
    return torch.cat([_cross(w, mw), _cross(w, ml) + _cross(vl, mw)], dim=-3)


def _cross_force(v, f):
    w, vl = v[..., :3, :, :], v[..., 3:, :, :]
    fw, fl = f[..., :3, :, :], f[..., 3:, :, :]
    return torch.cat([_cross(w, fw) + _cross(vl, fl), _cross(w, fl)], dim=-3)


def bias_forces(c: TLConstants, kin: TLKin, s: TLState, origin, terms=None,
                v_base=None):
    if terms is None:
        terms = leg_terms(c, kin, origin)
    qd = s.joint_vel  # (4,3,Bs,L)
    S = terms.S
    if v_base is None:
        v_base = torch.cat([s.base_ang_vel, s.base_lin_vel], dim=0)
    a_grav = torch.zeros_like(v_base)
    a_grav[5] = GRAVITY

    v_parent = v_base[None].expand((4,) + tuple(v_base.shape))
    a_parent = a_grav[None].expand((4,) + tuple(a_grav.shape))
    vs, accs = [], []
    for j in range(3):
        Sj = S[:, j]
        vj = v_parent + Sj * qd[:, j][:, None]
        aj = a_parent + _cross_motion(v_parent, Sj) * qd[:, j][:, None]
        vs.append(vj)
        accs.append(aj)
        v_parent, a_parent = vj, aj
    v_links = torch.stack(vs, dim=1)  # (4,3,6,Bs,L)
    a_links = torch.stack(accs, dim=1)

    h_l, Io_l = terms.h_l, terms.Io_l
    m_l = c.link_mass[..., None, :, :]
    f_links = _inertia_apply(m_l, h_l, Io_l, a_links) + _cross_force(
        v_links, _inertia_apply(m_l, h_l, Io_l, v_links)
    )
    f_acc = _rev_cumsum3(f_links, dim=1)
    tau_joint = _dot(S, f_acc)  # (4,3,Bs,L)

    h_b, Io_b = _inertia_params_base(c, kin, origin, s.base_pos)
    f_base = _inertia_apply(c.base_mass, h_b, Io_b, a_grav) + _cross_force(
        v_base, _inertia_apply(c.base_mass, h_b, Io_b, v_base)
    )
    tau_base = f_base + torch.sum(f_links, dim=(0, 1))
    return tau_base, tau_joint


def point_forces_to_generalized(kin: TLKin, origin, points, forces, link_index,
                                S=None):
    """points/forces (4, 3, Bs, L) acting on link `link_index` of each leg."""
    n = _cross(points - origin[None], forces)
    Fsp = torch.cat([n, forces], dim=-3)  # (4,6,Bs,L)
    tau_base = torch.sum(Fsp, dim=0)
    if S is None:
        S = motion_subspaces(kin, origin)
    tau_joint = _dot(S, Fsp[:, None])  # (4,3,Bs,L)
    mask = (torch.arange(3, device=tau_joint.device) <= link_index).to(tau_joint.dtype)
    return tau_base, tau_joint * mask[None, :, None, None]


class DynFactors(NamedTuple):
    """Configuration-dependent pieces of the leg-structured Schur solve."""

    F: torch.Tensor  # (4, 3, 6, Bs, L)
    Ml_inv: torch.Tensor  # (4, 3, 3, Bs, L)
    FtMinv: torch.Tensor  # (4, 3, 6, Bs, L)
    chol: torch.Tensor  # (21, Bs, L) packed Cholesky of the Schur complement


def factor_dynamics(Mb, F, Ml, reg=1e-9) -> DynFactors:
    eye = torch.eye(3, dtype=Ml.dtype, device=Ml.device)[None, :, :, None, None] * reg
    Ml_inv = inv3_sym(Ml + eye)  # (4,3,3,Bs,L)
    FtMinv = torch.sum(
        Ml_inv[..., :, :, None, :, :] * F[:, None, :, :, :, :], dim=2
    )  # (4,3,6,Bs,L)
    Schur = Mb - torch.sum(
        F[:, :, :, None, :, :] * FtMinv[:, :, None, :, :, :], dim=(0, 1)
    )  # (6,6,Bs,L)
    return DynFactors(F=F, Ml_inv=Ml_inv, FtMinv=FtMinv, chol=chol6(Schur, reg))


def forward_dynamics_apply(fac: DynFactors, tau_base, tau_joint):
    rhs = tau_base - torch.sum(fac.FtMinv * tau_joint[..., None, :, :], dim=(0, 1))
    a_base = chol6_solve(fac.chol, rhs)
    resid = tau_joint - torch.sum(fac.F * a_base[None, None], dim=2)  # (4,3,Bs,L)
    qdd = torch.sum(fac.Ml_inv * resid[:, None, :, :, :], dim=2)
    return a_base, qdd


def forward_dynamics(Mb, F, Ml, tau_base, tau_joint, reg=1e-9):
    """Leg-structured Schur solve in tile layout."""
    return forward_dynamics_apply(factor_dynamics(Mb, F, Ml, reg), tau_base, tau_joint)

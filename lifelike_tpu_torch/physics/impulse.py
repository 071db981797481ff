"""Hard-contact mode: velocity-level projected Gauss-Seidel impulses.

Port of lifelike_tpu.physics.impulse, the fidelity and eval plant: Bullet's
btSequentialImpulseConstraintSolver discipline (reference
legged_robot.py:260-264: 10 solver iterations, 1 substep, g=9.80665) as a
fixed-structure batched program:

  * the unconstrained velocity step through the leg-structured CRBA / RNEA
    of physics/dynamics.py (PD torque plus URDF joint damping; Coulomb joint
    friction and joint limits are impulse rows, as Bullet treats URDF
    <dynamics> tags),
  * a static row system — 8 contact spheres (4 feet, 4 wheels) x (normal +
    2 tangents), with a box scene one deepest-box row triple per foot,
    wheel and 5x3 trunk sphere, then per joint (friction, lower limit,
    upper limit) — where inactive rows are clamped to zero impulse, so the
    Gauss-Seidel sweep equals iterating only the active rows in the same
    order (tools/bullet_oracle.py builds the compacted list),
  * Baumgarte stabilization erp=0.2, friction clamped to mu x the normal
    impulse, impulses warm-started across substeps.

The sweep is ops.pgs_cuda.pgs_sweep: the hand-written CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor.
"""
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.math.quat import cross
from lifelike_tpu_torch.math.spatial import skew
from lifelike_tpu_torch.ops import pgs_cuda
from lifelike_tpu_torch.physics import dynamics
from lifelike_tpu_torch.physics.dynamics import RobotState, as_const
from lifelike_tpu_torch.physics.engine import _TRUNK_OFFSETS_HARD, _TRUNK_RADIUS

NV = 18  # 3 ang + 3 lin + 12 joints (generalized velocity [w, v_origin, qd])
N_SPHERES = 8  # 4 feet (link 2) + 4 wheels (link 1)
N_TRUNK = 15  # the 5x3 trunk grid (engine._TRUNK_OFFSETS_HARD), box contact only
N_BOX_SPHERES = N_SPHERES + N_TRUNK  # feet + wheels + trunk vs boxes
N_CONTACT_ROWS = 3 * N_SPHERES  # normal, tangent-x, tangent-y per sphere
N_JOINT_ROWS = 3 * 12  # friction, lower-limit, upper-limit per joint
N_ROWS = N_CONTACT_ROWS + N_JOINT_ROWS  # 60 (flat-ground system)
# box-scene system: plane rows, one deepest-box contact per sphere (Bullet's
# sphere-box manifold is a single point), then the joint rows
N_ROWS_BOX = N_CONTACT_ROWS + 3 * N_BOX_SPHERES + N_JOINT_ROWS  # 129


def _mu_idx(with_boxes: bool) -> np.ndarray:
    """Static friction-coupling map: row -> index of its normal row (-1)."""
    n_sph = N_SPHERES + (N_BOX_SPHERES if with_boxes else 0)
    n = 3 * n_sph + N_JOINT_ROWS
    idx = np.full(n, -1, np.int32)
    for s in range(n_sph):
        idx[3 * s + 1] = 3 * s
        idx[3 * s + 2] = 3 * s
    return idx


# Row index of the normal row each friction / tangent row couples to (-1: none).
_MU_IDX = _mu_idx(False)
_MU_IDX_BOX = _mu_idx(True)


class ImpulseParams(NamedTuple):
    """Hard-contact stepping configuration (reference legged_robot.py:240-264
    values). kp, kd, max_tau, mu and ext_force may be tensors broadcastable
    to the batch (per-episode randomization)."""

    kp: float = 50.0
    kd: float = 0.5
    max_tau: float = 18.0
    mu: float = 0.5  # contact friction (reference foot friction 0.5)
    dt: float = 1.0 / 500.0
    substeps: int = 10
    iterations: int = 10  # Bullet numSolverIterations
    erp: float = 0.2
    slop: float = 0.0
    ext_force: np.ndarray = np.zeros(3, np.float32)  # PushRandomizer parity
    # Kept so that configurations carry across from the JAX package, where it
    # selects the Pallas sweep. Here it changes nothing: on a CUDA tensor the
    # sweep always runs the CUDA kernel (any batch, either system, per-element
    # mu), on a CPU tensor always the plain version.
    use_pallas_pgs: bool = False


def init_lam(batch_shape=(), dtype=torch.float32, scene=None, device="cuda"):
    """Zero warm-start impulses; carry through control_step calls. Box
    scenes carry the larger N_ROWS_BOX system."""
    n = N_ROWS if scene is None else N_ROWS_BOX
    return torch.zeros(tuple(batch_shape) + (n,), dtype=dtype,
                       device=_device.resolve_device(device))


def _tangent_basis(n):
    """Deterministic orthonormal tangents for a unit normal (..., 3).

    t1 = n x z unless n is (anti)parallel to z, then n x x — the branch and
    threshold of tools/bullet_oracle.py (row parity requires them)."""
    ez = torch.zeros_like(n)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    t1a = cross(n, ez)
    t1b = cross(n, ex)
    use_b = torch.sum(t1a * t1a, dim=-1, keepdim=True) < 1e-6
    t1 = torch.where(use_b, t1b, t1a)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True).clamp_min(1e-12)
    return t1, cross(n, t1)


def _box_sdf(p, center, half):
    """Signed distance + outward unit normal of a point vs boxes.

    p (..., 3) vs center / half (..., K, 3) -> (dist (..., K), n (..., K, 3)).
    Inside, the normal is averaged over the faces tied for least penetration."""
    r = p[..., None, :] - center
    q = r.abs() - half
    outside = torch.clamp_min(q, 0.0)
    d_out = torch.sqrt(torch.sum(outside * outside, dim=-1) + 1e-12)
    d_in = torch.amax(q, dim=-1)
    inside = d_in < 0.0
    dist = torch.where(inside, d_in, d_out)
    sign = torch.where(r >= 0.0, 1.0, -1.0).to(p.dtype)
    face = (q >= d_in[..., None]).to(p.dtype)
    face = face / torch.sum(face, dim=-1, keepdim=True).clamp_min(1.0)
    n = torch.where(inside[..., None], sign * face, sign * outside / d_out[..., None])
    return dist, n


def _point_rows(kin, base_pos, p, leg_link_mask):
    """Point-velocity Jacobian rows of world points fixed to leg links:
    v_p = v_origin + w x (p - base) + sum_{i<=link} qd_i a_i x (p - p_i).

    p: (..., 4, 3) one point per leg; leg_link_mask: (3,) 1.0 for joints at
    or above the attachment link. Returns (..., 4, 3 rows, 18), rows = the
    x / y / z components of the point velocity."""
    J_ang = -skew(p - base_pos[..., None, :])  # (..., 4, 3, 3)
    J_lin = torch.eye(3, dtype=p.dtype, device=p.device).expand(J_ang.shape)
    Jq = cross(kin.axis_w, p[..., :, None, :] - kin.p_joint)  # (..., 4 legs, 3 joints, 3)
    Jq = Jq * leg_link_mask[:, None]
    # per leg only its own 3 joint columns of the 12-joint block are nonzero
    leg_sel = torch.eye(4, dtype=p.dtype, device=p.device)
    Jq_full = torch.einsum("...ljc,lm->...lcmj", Jq, leg_sel)  # (..., 4, 3, 4, 3)
    Jq_full = Jq_full.reshape(Jq_full.shape[:-2] + (12,))
    return torch.cat([J_ang, J_lin, Jq_full], dim=-1)


def _box_rows(model, p: ImpulseParams, state: RobotState, kin, Jf, Jw, scene):
    """One deepest-box contact row triple per sphere (feet, wheels, trunk).

    Bullet's sphere-box collision emits a single manifold point; the deepest
    active box per sphere reproduces it. Returns (J (..., 69, 18), b, lo,
    hi (..., 69)) in the order feet 0-3, wheels 0-3, trunk 0-14 — the order
    in which tools/bullet_oracle.py appends its box rows. The scene's boxes
    may carry the state's batch axes ((..., K, 3)) or none ((K, 3))."""
    dtype = state.base_pos.dtype
    inf = torch.tensor(float("inf"), dtype=dtype, device=state.base_pos.device)
    batch = tuple(state.base_pos.shape[:-1])

    # trunk spheres: world positions + base-attached point Jacobians
    offs_w = torch.einsum("...ij,pj->...pi", quat.to_matrix(state.base_orn),
                          as_const(_TRUNK_OFFSETS_HARD, state.base_pos))  # (..., 15, 3)
    p_tr = state.base_pos[..., None, :] + offs_w
    J_ang = -skew(offs_w)  # p - base == offs_w
    J_lin = torch.eye(3, dtype=dtype, device=J_ang.device).expand(J_ang.shape)
    J_tr = torch.cat([J_ang, J_lin, J_ang.new_zeros(batch + (N_TRUNK, 3, 12))], dim=-1)

    pts = torch.cat([kin.p_foot, kin.p_wheel, p_tr], dim=-2)  # (..., 23, 3)
    Jp = torch.cat([Jf, Jw, J_tr], dim=-3)  # (..., 23, 3, 18)
    radii = torch.cat([
        torch.full((4,), model.foot_radius, dtype=dtype, device=pts.device),
        torch.full((4,), model.wheel_radius, dtype=dtype, device=pts.device),
        torch.full((N_TRUNK,), _TRUNK_RADIUS, dtype=dtype, device=pts.device),
    ])

    # the sphere axis goes in front of the box axis of a batched scene
    dist, n = _box_sdf(pts, scene.center[..., None, :, :], scene.half[..., None, :, :])
    dist = torch.where(scene.active[..., None, :], dist, inf)  # (..., 23, K)
    pen = radii[:, None] - dist
    k_best = torch.argmax(pen, dim=-1, keepdim=True)  # the first of tied maxima
    pen_b = torch.gather(pen, -1, k_best)[..., 0]
    n_b = torch.gather(n, -2, k_best[..., None].expand(k_best.shape + (3,)))[..., 0, :]
    active = pen_b > 0.0

    t1, t2 = _tangent_basis(n_b)
    Jrows = torch.stack([torch.einsum("...sc,...scv->...sv", x, Jp) for x in (n_b, t1, t2)],
                        dim=-2)  # (..., 23, 3, 18)

    b_n = p.erp * torch.clamp_min(pen_b - p.slop, 0.0) / p.dt * active
    zero = torch.zeros_like(b_n)
    b = torch.stack([b_n, zero, zero], dim=-1)
    hi = torch.stack([torch.where(active, inf, 0.0), zero, zero], dim=-1)
    nb = 3 * N_BOX_SPHERES
    return (Jrows.reshape(batch + (nb, NV)), b.reshape(batch + (nb,)),
            torch.zeros(batch + (nb,), dtype=dtype, device=b.device), hi.reshape(batch + (nb,)))


def _build_rows(model, p: ImpulseParams, state: RobotState, kin, scene=None):
    """Assemble the static row system: J (..., N, 18), b, lo, hi (..., N).

    Row order is tools/bullet_oracle.py's compacted active list (feet then
    wheels, each n / t1 / t2; then, with a box scene, one deepest-box
    contact per foot / wheel / trunk sphere; then per joint friction, lower,
    upper), with inactive rows clamped lo = hi = 0 so that their updates are
    no-ops."""
    dtype = state.base_pos.dtype
    dev = state.base_pos.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    batch = tuple(state.joint_pos.shape[:-1])

    mask_foot = torch.tensor([1.0, 1.0, 1.0], dtype=dtype, device=dev)  # link 2: all 3 joints
    mask_wheel = torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev)  # link 1: joints 0, 1
    Jf = _point_rows(kin, state.base_pos, kin.p_foot, mask_foot)  # (..., 4, 3, 18)
    Jw = _point_rows(kin, state.base_pos, kin.p_wheel, mask_wheel)

    def sphere_rows(Jp, pts, radius):
        pen = radius - pts[..., 2]  # (..., 4)
        active = pen > 0.0
        b_n = p.erp * torch.clamp_min(pen - p.slop, 0.0) / p.dt * active
        # rows per sphere: [z (normal), x, y]
        Jrows = torch.stack([Jp[..., :, 2, :], Jp[..., :, 0, :], Jp[..., :, 1, :]], dim=-2)
        zero = torch.zeros_like(b_n)
        b = torch.stack([b_n, zero, zero], dim=-1)  # (..., 4, 3)
        lo = torch.zeros_like(b)  # tangent bounds come from mu * lam_n in the sweep
        hi = torch.stack([torch.where(active, inf, 0.0), zero, zero], dim=-1)
        return Jrows, b, lo, hi

    Jf_r, bf, lof, hif = sphere_rows(Jf, kin.p_foot, model.foot_radius)
    Jw_r, bw, lo_w, hi_w = sphere_rows(Jw, kin.p_wheel, model.wheel_radius)

    # joint rows: friction (bilateral box +-fric*dt), lower limit, upper limit
    q = state.joint_pos
    fric = as_const(model.joint_friction, q).reshape(-1)
    lower = as_const(model.joint_lower_flat, q)
    upper = as_const(model.joint_upper_flat, q)
    e_j = torch.eye(NV, dtype=dtype, device=dev)[6:].expand(batch + (12, NV))

    lim = fric * p.dt
    zero12 = torch.zeros(batch + (12,), dtype=dtype, device=dev)
    lo_fric = (-lim).expand(batch + (12,))
    hi_fric = lim.expand(batch + (12,))

    low_act = q < lower
    b_low = p.erp * (lower - q) / p.dt * low_act
    hi_low = torch.where(low_act, inf, 0.0)

    up_act = q > upper
    b_up = p.erp * (q - upper) / p.dt * up_act
    hi_up = torch.where(up_act, inf, 0.0)

    J_joint = torch.stack([e_j, e_j, -e_j], dim=-2)  # (..., 12, 3, 18)
    b_joint = torch.stack([zero12, b_low, b_up], dim=-1)  # (..., 12, 3)
    lo_joint = torch.stack([lo_fric, zero12, zero12], dim=-1)
    hi_joint = torch.stack([hi_fric, hi_low, hi_up], dim=-1)

    def flat(x, tail):
        return x.reshape(batch + tail)

    box = ([], [], [], []) if scene is None else [
        [x] for x in _box_rows(model, p, state, kin, Jf, Jw, scene)]
    J = torch.cat([flat(Jf_r, (12, NV)), flat(Jw_r, (12, NV))] + box[0]
                  + [flat(J_joint, (36, NV))], dim=-2)
    b = torch.cat([flat(bf, (12,)), flat(bw, (12,))] + box[1] + [flat(b_joint, (36,))], dim=-1)
    lo = torch.cat([flat(lof, (12,)), flat(lo_w, (12,))] + box[2] + [flat(lo_joint, (36,))],
                   dim=-1)
    hi = torch.cat([flat(hif, (12,)), flat(hi_w, (12,))] + box[3] + [flat(hi_joint, (36,))],
                   dim=-1)
    return J, b, lo, hi


def _pgs(p: ImpulseParams, v, lam0, J, MinvJT, d, b, lo, hi, mu_idx=_MU_IDX):
    """Projected Gauss-Seidel, rows in their static (oracle) order: the plain
    version of the sweep (ops.pgs_cuda.pgs_sweep_plain).

    v: (..., 18) free velocity after the warm-start impulses. Returns
    (v, lam)."""
    return pgs_cuda.pgs_sweep_plain(v, lam0, J, MinvJT, d, b, lo, hi, p.mu, mu_idx,
                                    iterations=p.iterations)


def init_comp(batch_shape=(), dtype=torch.float32, device="cuda"):
    """Zero Kahan compensation carry for the compensated integrator:
    (base_pos comp (..., 3), joint_pos comp (..., 12))."""
    dev = _device.resolve_device(device)
    b = tuple(batch_shape)
    return (torch.zeros(b + (3,), dtype=dtype, device=dev),
            torch.zeros(b + (12,), dtype=dtype, device=dev))


def _kahan_add(x, inc, comp):
    """Compensated x + inc with carry `comp` (Kahan-Neumaier step)."""
    y = inc - comp
    t = x + y
    return t, (t - x) - y


class FrictionMap(NamedTuple):
    mu_idx: torch.Tensor  # (n_rows,) int32: the normal row of each friction row, else -1
    coupled: torch.Tensor  # (n_rows,) bool: mu_idx >= 0
    normal_row: torch.Tensor  # (n_rows,) int64: mu_idx where coupled, else 0


_FRICTION_MAPS = {}


def friction_map(with_boxes, device) -> FrictionMap:
    """The friction map of the flat (60-row) or box-scene (129-row) system
    on `device`, made once per device: the sweep reads mu_idx, the warm
    start the other two."""
    key = (bool(with_boxes), str(device))
    if key not in _FRICTION_MAPS:
        idx = _MU_IDX_BOX if with_boxes else _MU_IDX
        _FRICTION_MAPS[key] = FrictionMap(
            mu_idx=torch.as_tensor(idx, dtype=torch.int32, device=device),
            coupled=torch.as_tensor(idx >= 0, device=device),
            normal_row=torch.as_tensor(np.maximum(idx, 0).astype(np.int64), device=device))
    return _FRICTION_MAPS[key]


def sweep_system(model, p: ImpulseParams, state: RobotState, lam, target_q, scene=None):
    """The impulse system of one substep, as the sweep takes it:
    (v, lam0, J, MinvJT, d, b, lo, hi, mu_idx) — the free velocity after the
    warm-start impulses, the warm-start impulses, the rows, M^-1 J^T, the
    diagonal J M^-1 J^T, the bias and bounds, and the friction map (an int32
    tensor on the state's device, friction_map's mu_idx)."""
    dtype = state.base_pos.dtype
    dt = p.dt
    kin = dynamics.forward_kinematics(model, state)
    origin = state.base_pos

    # PD + joint damping only; Coulomb friction and limits are impulse rows
    # (Bullet treats URDF joint friction as a zero-velocity motor with a
    # force limit)
    tgt = torch.clamp(target_q, -3.0, 3.0)
    tau_j = p.kp * (tgt - state.joint_pos) + p.kd * (0.0 - state.joint_vel)
    max_tau = torch.as_tensor(p.max_tau, dtype=dtype, device=tau_j.device)
    tau_j = torch.minimum(torch.maximum(tau_j, -max_tau), max_tau)
    tau_j = tau_j - as_const(model.joint_damping, state.joint_pos).reshape(-1) * state.joint_vel
    tau_j = tau_j.reshape(state.joint_pos.shape[:-1] + (4, 3))

    ext = torch.broadcast_to(as_const(p.ext_force, state.base_pos), state.base_pos.shape)
    tau_b = torch.cat([torch.zeros_like(ext), ext], dim=-1)

    bias_b, bias_j = dynamics.bias_forces(model, kin, state, origin)
    Mb, F, Ml = dynamics.mass_matrix_blocks(model, kin, origin, state.base_pos)
    fac = dynamics.factor_dynamics(Mb, F, Ml)
    a_base, qdd = dynamics.forward_dynamics_apply(fac, tau_b - bias_b, tau_j - bias_j)

    # spatial -> point acceleration of the base origin, then an explicit step
    # of the generalized velocity [w, v_origin, qd]
    w = state.base_ang_vel
    a_lin = a_base[..., 3:] + cross(w, state.base_lin_vel)
    v_free = torch.cat([
        w + a_base[..., :3] * dt,
        state.base_lin_vel + a_lin * dt,
        state.joint_vel + qdd.reshape(state.joint_vel.shape) * dt,
    ], dim=-1)

    J, b, lo, hi = _build_rows(model, p, state, kin, scene=scene)
    MinvJT = dynamics.minv_apply_rows(fac, J)  # (..., n_rows, 18)
    d = torch.einsum("...ni,...ni->...n", J, MinvJT)

    # warm start: rows inactive now contribute nothing and re-clamp to 0
    # (hi == lo == 0 for them), as the oracle rebuilds its keys per substep
    fm = friction_map(scene is not None, hi.device)
    lam0 = torch.where((hi > 0.0) | (lo < 0.0) | fm.coupled, lam, 0.0)
    # tangent warm impulses only when their sphere is active this substep
    lam0 = torch.where(fm.coupled & (hi[..., fm.normal_row] <= 0.0), 0.0, lam0)
    v = v_free + torch.einsum("...nk,...n->...k", MinvJT, lam0)
    return v, lam0, J, MinvJT, d, b, lo, hi, fm.mu_idx


def substep(model, p: ImpulseParams, state: RobotState, lam, target_q, scene=None, comp=None):
    """One 500 Hz hard-contact substep. lam: (..., N_ROWS[_BOX]) warm-start
    impulses from the previous substep. scene: optional scene.boxes.BoxScene
    — adds the deepest-box contact rows to the system.

    comp: optional init_comp carry — Kahan-compensated position integration
    (500 substeps of pos += v*dt accumulate float32 rounding that marginal
    contact then amplifies). Returns (state, lam) or (state, lam, comp')."""
    dt = p.dt
    *system, mu_idx = sweep_system(model, p, state, lam, target_q, scene=scene)
    v, lam = pgs_cuda.pgs_sweep(*system, p.mu, mu_idx, iterations=p.iterations)

    w_new, lin_new, qd_new = v[..., 0:3], v[..., 3:6], v[..., 6:]
    if comp is None:
        new_pos = state.base_pos + lin_new * dt
        new_q = state.joint_pos + qd_new * dt
    else:
        cp, cq = comp
        new_pos, cp = _kahan_add(state.base_pos, lin_new * dt, cp)
        new_q, cq = _kahan_add(state.joint_pos, qd_new * dt, cq)
        comp = (cp, cq)
    out = RobotState(
        base_pos=new_pos,
        base_orn=quat.integrate(state.base_orn, w_new, dt),
        base_lin_vel=lin_new,
        base_ang_vel=w_new,
        joint_pos=new_q,
        joint_vel=qd_new,
    )
    if comp is None:
        return out, lam
    return out, lam, comp


def control_step(model, p: ImpulseParams, state: RobotState, lam, target_q, scene=None,
                 comp=None):
    """One 50 Hz control step: `substeps` hard-contact substeps with a held
    target (reference primitive_level_env.py:202-210). Returns (state, lam)
    — or (state, lam, comp') when a compensation carry is passed."""
    for _ in range(p.substeps):
        if comp is None:
            state, lam = substep(model, p, state, lam, target_q, scene=scene)
        else:
            state, lam, comp = substep(model, p, state, lam, target_q, scene=scene, comp=comp)
    return (state, lam) if comp is None else (state, lam, comp)


def make_control_step(model, p: ImpulseParams, scene=None, compensated=False):
    """f((state, lam[, comp]), target_q) -> the carry of the same form."""

    def step(carry, target_q):
        return control_step(model, p, carry[0], carry[1], target_q, scene=scene)

    def step_comp(carry, target_q):
        return control_step(model, p, carry[0], carry[1], target_q, scene=scene, comp=carry[2])

    return step_comp if compensated else step

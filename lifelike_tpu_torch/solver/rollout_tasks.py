"""Terrain-traversal (EPMC) and Chase-Tag (SEPMC) MPC rollouts in tile layout.

Port of lifelike_tpu.solver.rollout_tasks: horizon rollouts through the
tile-layout physics with box-scene contact, scored by

  * traversal: the negated playground rewards (joystick / average-speed
    families, reference playground_env.py:479-539) plus dense shaping,
    posture, fall and a soft clearance hinge;
  * chase: chaser distance + heading, escapee evasion + flag distance
    (reference chase_tag_game_env.py:640-697), with the opponent following
    a precomputed plan trajectory (`rollout_plan`) — alternating best
    response between the two robots' solvers supplies the coupling.

The contact scene, the gait reference and the opponent's plan depend only
on the scenario and the step, never on the candidate, so they are built
once per solve and broadcast over the (Bs, L) population.

`rollout_traversal_gait`, `rollout_chase_gait` and `rollout_plan_gait` are
the plain versions of the CUDA kernels of ops.traversal_cuda (K2, K4, K3):
same functions, held against them. The batch-leading cost oracles are in
costs/traversal.py and costs/chase.py.
"""
import torch

from lifelike_tpu_torch.costs.chase import ChaseWeights
from lifelike_tpu_torch.costs.traversal import STAND_POSE, TraversalWeights
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine_tl
from lifelike_tpu_torch.solver.rollout_tl import fall_mask_tl, yaw_tl


def clearance_cost_tl(ts: engine_tl.TLScene, base_pos, margin=0.15, tall_threshold=0.3,
                      crawl_gap=0.0):
    """Tile-layout costs.traversal.clearance_cost: base_pos (3, Bs, L) ->
    (Bs, L). crawl_gap > 0 exempts boxes whose bottom face clears it."""
    d = (base_pos[None, :2] - ts.center[:, :2]).abs()  # (N, 2, Bs, L)
    out = torch.clamp_min(d - ts.half[:, :2], 0.0)
    horiz = torch.sqrt(torch.sum(out * out, dim=1))  # (N, Bs, L)
    tall = (ts.center[:, 2] + ts.half[:, 2]) > tall_threshold
    blocking = tall * ts.active
    if crawl_gap > 0.0:
        bottom = ts.center[:, 2] - ts.half[:, 2]
        blocking = blocking * (bottom < crawl_gap)
    pen = torch.clamp_min(margin - horiz, 0.0) * blocking
    return torch.sum(pen**2, dim=0)


def posture_cost_tl(s: B.TLState, w):
    """costs.traversal.posture_cost in tile layout: height hinge +
    uprightness + stand-pose regularization (+ the crawl ceiling)."""
    z = s.base_pos[2]
    up_z = 1.0 - 2.0 * (s.base_orn[0] ** 2 + s.base_orn[1] ** 2)
    stand = torch.tensor(STAND_POSE, dtype=s.joint_pos.dtype,
                         device=s.joint_pos.device).reshape(4, 3)
    pose_err = torch.mean((s.joint_pos - stand[..., None, None]) ** 2, dim=(0, 1))
    cost = (
        w.height * torch.clamp_min(w.height_min - z, 0.0)
        + w.upright * (1.0 - up_z)
        + w.pose * pose_err
    )
    if getattr(w, "ceiling", 0.0) > 0.0:
        cost = cost + w.ceiling_w * torch.clamp_min(z - w.ceiling, 0.0)
    return cost


def _direction_terms(s: B.TLState, target_pos):
    """Unit direction to the target, speed along it (absolute for the
    parity reward, signed for shaping) and the heading alignment.
    target_pos (3, Bs, L)-broadcastable. Returns (dist, |spd|, spd, align)."""
    diff = target_pos[:2] - s.base_pos[:2]  # (2, Bs, L)
    d = torch.sqrt(torch.sum(diff * diff, dim=0)).clamp_min(1e-8)
    dir_w = diff / d[None]
    spd_signed = s.base_lin_vel[0] * dir_w[0] + s.base_lin_vel[1] * dir_w[1]
    yaw = yaw_tl(s.base_orn)
    align = torch.cos(yaw) * dir_w[0] + torch.sin(yaw) * dir_w[1]
    return d, spd_signed.abs(), spd_signed, align


def _dense_shaping_tl(spd_signed, align, target_spd, w: TraversalWeights):
    """Dense speed / heading shaping on the SIGNED speed (the parity
    reward's |v . dir| would score backward motion like forward)."""
    return (
        w.velocity * (spd_signed - target_spd).abs() / (1.0 + target_spd)
        + w.heading * (1.0 - align)
    )


def joystick_cost_tl(s: B.TLState, target_pos, target_spd,
                     w: TraversalWeights = TraversalWeights()):
    """1 - reward_vel * reward_rotation + dense shaping + posture + fall."""
    _, spd, spd_sg, align = _direction_terms(s, target_pos)
    r_vel = torch.exp(-(spd - target_spd).abs())
    r_rot = torch.exp((align - 1.0) * 5.0)
    cost = 1.0 - r_vel * r_rot + _dense_shaping_tl(spd_sg, align, target_spd, w)
    cost = cost + posture_cost_tl(s, w)
    return cost + w.fall * fall_mask_tl(s).to(cost.dtype)


def avg_speed_cost_tl(s: B.TLState, target_pos, target_spd, last_dist, init_dist,
                      max_steps=1000, w: TraversalWeights = TraversalWeights()):
    """Negated average_speed stage reward: 0.1 * dist-progress
    - 0.2/max_steps * rotation, plus shaping, posture and fall.
    Returns (cost, new_dist)."""
    d, _, spd_sg, align = _direction_terms(s, target_pos)
    r_rot = torch.exp((align - 1.0) * 5.0)
    r_dist = (d - last_dist) / init_dist
    cost = 0.1 * r_dist - (0.2 / float(max_steps)) * r_rot
    cost = cost + _dense_shaping_tl(spd_sg, align, target_spd, w)
    cost = cost + posture_cost_tl(s, w)
    return cost + w.fall * fall_mask_tl(s).to(cost.dtype), d


def _target_tl(target_pos):
    return target_pos if target_pos.dim() == 3 else target_pos[:, None, None]


def _start_dist(state: B.TLState, tp):
    return torch.sqrt(torch.sum((tp[:2] - state.base_pos[:2]) ** 2, dim=0)).clamp_min(1e-8)


def _stage_cost(s, ts, tp, target_spd, last_d, d0, reward_type, max_steps, weights):
    if reward_type == "joystick":
        cost = joystick_cost_tl(s, tp, target_spd, weights)
        new_d = last_d
    else:
        cost, new_d = avg_speed_cost_tl(s, tp, target_spd, last_d, d0, max_steps, weights)
    cost = cost + weights.clearance * clearance_cost_tl(ts, s.base_pos,
                                                        crawl_gap=weights.crawl_gap)
    return cost, new_d


def rollout_traversal(c: B.TLConstants, params, state: B.TLState, controls,
                      ts: engine_tl.TLScene, target_pos, target_spd,
                      reward_type="joystick", max_steps=1000,
                      weights: TraversalWeights = TraversalWeights()):
    """controls: (H, 4, 3, Bs, L) joint-target deltas on the INITIAL pose
    (over an open-loop horizon the initial pose is the stationary nominal).
    target_pos: (3,) or (3, Bs, L); target_spd scalar.
    Returns (total_cost (Bs, L), final TLState)."""
    q0 = state.joint_pos
    tp = _target_tl(target_pos)
    d0 = _start_dist(state, tp)
    s, last_d, total = state, d0, None
    for t in range(controls.shape[0]):
        s = engine_tl.control_step(c, params, s, q0 + controls[t], scene=ts)
        cost, last_d = _stage_cost(s, ts, tp, target_spd, last_d, d0, reward_type,
                                   max_steps, weights)
        total = cost if total is None else total + cost
    return total, s


def rollout_traversal_gait(c: B.TLConstants, params, state: B.TLState, controls,
                           ts: engine_tl.TLScene, ref, target_pos, target_spd,
                           reward_type="joystick", max_steps=1000,
                           weights: TraversalWeights = TraversalWeights(),
                           gait_weight=1.0, gait_vel_weight=0.02):
    """Gait-prior traversal rollout: controls are deltas on a walk clip's
    joint trajectory (ref: rollout_tl.RefTraj; u = 0 replays the gait) and
    the stage cost adds gait_weight x joint-space clip tracking to the
    traversal terms. The gait term is skipped when gait_weight == 0, as in
    the CUDA kernel, so a diverged candidate's non-finite tracking error
    cannot turn its cost into 0 * inf = NaN.
    Returns (total_cost (Bs, L), final TLState)."""
    tp = _target_tl(target_pos)
    d0 = _start_dist(state, tp)
    s, last_d, total = state, d0, None
    for t in range(controls.shape[0]):
        s = engine_tl.control_step(c, params, s, ref.target_joint[t] + controls[t], scene=ts)
        cost, last_d = _stage_cost(s, ts, tp, target_spd, last_d, d0, reward_type,
                                   max_steps, weights)
        if gait_weight != 0.0:
            gait = torch.mean((s.joint_pos - ref.joint_pos[t]) ** 2, dim=(0, 1))
            gait = gait + gait_vel_weight * torch.mean((s.joint_vel - ref.joint_vel[t]) ** 2,
                                                       dim=(0, 1))
            cost = cost + gait_weight * gait
        total = cost if total is None else total + cost
    return total, s


# ----------------------------------------------------------------- chase


def chaser_cost_tl(s: B.TLState, opp_pos, w: ChaseWeights = ChaseWeights()):
    """costs.chase.chaser_cost in tile layout: distance + heading alignment
    to the opponent + fall. opp_pos (3, Bs, L)-broadcastable."""
    diff = opp_pos[:2] - s.base_pos[:2]
    d = torch.sqrt(torch.sum(diff * diff, dim=0))
    dir_w = diff / d[None].clamp_min(1e-8)
    yaw = yaw_tl(s.base_orn)
    align = torch.cos(yaw) * dir_w[0] + torch.sin(yaw) * dir_w[1]
    r_rot = torch.exp((align - 1.0) * 2.0)
    cost = w.distance * d + w.heading * (1.0 - r_rot)
    return cost + w.fall * fall_mask_tl(s).to(cost.dtype)


def escapee_cost_tl(s: B.TLState, opp_pos, flag_pos, flag_visible=1.0,
                    w: ChaseWeights = ChaseWeights()):
    """costs.chase.escapee_cost in tile layout: evade the chaser while
    closing on the (visible) flag, + fall."""
    d_opp = torch.sqrt(torch.sum((opp_pos[:2] - s.base_pos[:2]) ** 2, dim=0))
    d_flag = torch.sqrt(torch.sum((flag_pos[:2] - s.base_pos[:2]) ** 2, dim=0))
    cost = -w.distance * d_opp + w.distance * flag_visible * d_flag
    return cost + w.fall * fall_mask_tl(s).to(cost.dtype)


def _chase_stage_cost(s, ts, opp_t, fp, chaser_m, weights):
    """Role-mixed stage cost: chaser_m in {0, 1} selects the role by masked
    arithmetic, so one solve serves both roles without a host branch."""
    c_ch = chaser_cost_tl(s, opp_t, weights)
    c_es = escapee_cost_tl(s, opp_t, fp, 1.0, weights)
    cost = chaser_m * c_ch + (1.0 - chaser_m) * c_es
    cost = cost + posture_cost_tl(s, weights)
    return cost + 0.5 * clearance_cost_tl(ts, s.base_pos)


def _role_mask(is_chaser, like):
    return torch.as_tensor(is_chaser, device=like.device).to(like.dtype)


def rollout_chase(c: B.TLConstants, params, state: B.TLState, controls, ts: engine_tl.TLScene,
                  opp_traj, flag_pos, is_chaser, weights: ChaseWeights = ChaseWeights()):
    """Chase-Tag horizon rollout for ONE robot against a fixed opponent plan.

    controls: (H, 4, 3, Bs, L) deltas on the initial pose; opp_traj
    (H, 3, 1, 1) opponent base positions (precomputed once per solve);
    flag_pos (3,) or (3, Bs, L); is_chaser: bool / 0-1 scalar or 0-d tensor.
    Returns (total_cost (Bs, L), final TLState)."""
    q0 = state.joint_pos
    fp = _target_tl(flag_pos)
    chaser_m = _role_mask(is_chaser, state.base_pos)
    s, total = state, None
    for t in range(controls.shape[0]):
        s = engine_tl.control_step(c, params, s, q0 + controls[t], scene=ts)
        cost = _chase_stage_cost(s, ts, opp_traj[t], fp, chaser_m, weights)
        total = cost if total is None else total + cost
    return total, s


def rollout_chase_gait(c: B.TLConstants, params, state: B.TLState, controls,
                       ts: engine_tl.TLScene, ref, opp_traj, flag_pos, is_chaser,
                       weights: ChaseWeights = ChaseWeights(), gait_weight=1.0,
                       gait_vel_weight=0.02):
    """Chase rollout with the walk-clip gait prior (see
    rollout_traversal_gait): controls are deltas on ref.target_joint, and the
    gait term is skipped when gait_weight == 0, as in the CUDA kernel.
    Returns (total_cost (Bs, L), final TLState)."""
    fp = _target_tl(flag_pos)
    chaser_m = _role_mask(is_chaser, state.base_pos)
    s, total = state, None
    for t in range(controls.shape[0]):
        s = engine_tl.control_step(c, params, s, ref.target_joint[t] + controls[t], scene=ts)
        cost = _chase_stage_cost(s, ts, opp_traj[t], fp, chaser_m, weights)
        if gait_weight != 0.0:
            gait = torch.mean((s.joint_pos - ref.joint_pos[t]) ** 2, dim=(0, 1))
            gait = gait + gait_vel_weight * torch.mean((s.joint_vel - ref.joint_vel[t]) ** 2,
                                                       dim=(0, 1))
            cost = cost + gait_weight * gait
        total = cost if total is None else total + cost
    return total, s


def rollout_plan_gait(c: B.TLConstants, params, state: B.TLState, u_plan,
                      ts: engine_tl.TLScene, ref):
    """rollout_plan with the gait-prior control convention (deltas on the
    clip joints). u_plan (H, 4, 3) or (H, 4, 3, Bs, L); returns the base
    positions (H, 3, Bs, L)."""
    u_seq = u_plan[..., None, None] if u_plan.dim() == 3 else u_plan
    s, traj = state, []
    for t in range(u_seq.shape[0]):
        s = engine_tl.control_step(c, params, s, ref.target_joint[t] + u_seq[t], scene=ts)
        traj.append(s.base_pos)
    return torch.stack(traj)


def rollout_plan(c: B.TLConstants, params, state: B.TLState, u_plan, ts: engine_tl.TLScene):
    """Roll ONE control plan (H, 4, 3) for a single scenario (batch (1, 1))
    and return its base-position trajectory (H, 3, 1, 1) — the opponent's
    hoisted path for rollout_chase."""
    q0 = state.joint_pos
    s, traj = state, []
    for t in range(u_plan.shape[0]):
        s = engine_tl.control_step(c, params, s, q0 + u_plan[t][..., None, None], scene=ts)
        traj.append(s.base_pos)
    return torch.stack(traj)

"""MPC controllers for the EPMC (terrain traversal) and SEPMC (Chase Tag)
tasks.

Port of lifelike_tpu.solver.mpc_tasks: receding-horizon MPPI
(solver.mppi_tl.mppi_update) over the task rollouts, solved online by
sampling instead of a policy network —

  * traversal: randomized obstacle courses toward a joystick / course
    target (reference max_game_elements/playground_env.py). Each solve
    prunes the scene to the CONTACT_K boxes nearest the reachable corridor
    and scores every candidate with ops.traversal_cuda.rollout_traversal_fused
    (K2); the multigait controller runs one MPPI update per gait prior of a
    bank and executes the cheapest (or the gated) prior's plan.
  * chase: two-robot Chase Tag in the V4 arena (reference
    max_game/chase_tag_game_env.py:640-697). The two robots are coupled by
    alternating best response: each robot's candidates
    (ops.traversal_cuda.rollout_chase_fused, K4) play against the
    opponent's current plan, rolled into a base trajectory by
    ops.traversal_cuda.rollout_plan_fused (K3) once per turn. Arena tables
    are small (at most 12 boxes), so no contact prune is applied.

Each wrapper is the CUDA kernel on the card and its plain PyTorch version on
the CPU, and every controller always goes through it; the raw-delta
controllers (`make_traversal_controller`, `make_chase_solver`) reduce the
gait-prior kernels to the raw-delta rollouts (rollout_tasks.rollout_traversal,
rollout_chase, rollout_plan) with gait_weight = 0 and a constant reference
at the robot's current joints.
"""
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.costs.traversal import TraversalWeights
from lifelike_tpu_torch.ops import rollout_cuda, traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.scene import boxes
from lifelike_tpu_torch.solver import mppi_tl, rollout_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig

# Corridor prune for playground scenes (capacity 48): 8 boxes cover every
# box an H-step rollout touches at the reference obstacle spacings.
CONTACT_K = 8


def _tl_single(robot_state):
    """Unbatched RobotState -> TLState with batch (1, 1)."""
    return B.tl_from_state(B.map_state(lambda x: x[None], robot_state))


def _corridor_scene(params, cfg: MPPIConfig, robot_state, scene, target_pos, target_spd,
                    contact_k):
    """Sub-scene of the contact_k boxes nearest the segment from the base to
    where the horizon can reach toward the target,
    [p, p + min(dist to target, speed * H * policy_dt) * dir]."""
    p0 = robot_state.base_pos
    to_tgt = target_pos[:2] - p0[:2]
    d_tgt = torch.linalg.vector_norm(to_tgt) + 1e-9
    policy_dt = params.dt * params.substeps
    spd = torch.as_tensor(target_spd, dtype=p0.dtype, device=p0.device)
    reach = torch.minimum(d_tgt, spd * cfg.horizon * policy_dt)
    p1 = p0.clone()
    p1[:2] = p0[:2] + to_tgt / d_tgt * reach
    return boxes.nearest_boxes_corridor(scene, p0, p1, contact_k)


def _check_device(device, c):
    dev = _device.resolve_device(device)
    if c.joint_offset.device.type != dev.type:
        raise ValueError(f"constants on {c.joint_offset.device}, controller device {dev}")
    return dev


def make_traversal_controller(model, c: B.TLConstants, params, cfg: MPPIConfig,
                              reward_type="joystick", max_steps=1000, contact_k=CONTACT_K,
                              device="cuda"):
    """EPMC MPC: f(generator, robot_state, scene, target_pos, target_spd,
    u_warm (H, 4, 3), eps=None) -> (target_q_exec (12,), u_warm', diag).

    Controls are deltas on the current joints; the executed control is an
    absolute joint target (envs.playground consumes
    `target_q_exec - robot.joint_pos`). eps: injected raw normals, see
    mppi_tl.mppi_update."""
    _check_device(device, c)

    def controller(generator, robot_state, scene, target_pos, target_spd, u_warm, eps=None):
        table = traversal_cuda.pack_boxes(_corridor_scene(
            params, cfg, robot_state, scene, target_pos, target_spd, contact_k))
        tl = _tl_single(robot_state)
        q0 = robot_state.joint_pos
        ref = traversal_cuda.constant_reference(q0, cfg.horizon)

        def score(u_cand):
            return traversal_cuda.rollout_traversal_fused(
                c, params, tl, u_cand, table, ref, target_pos, target_spd, reward_type,
                max_steps, gait_weight=0.0)

        u_opt, diag = mppi_tl.mppi_update(cfg, generator, u_warm, score, eps=eps)
        u_exec = (q0.reshape(4, 3) + u_opt[0]).reshape(12)
        u_next = torch.cat([u_opt[1:], u_opt[-1:]], dim=0)
        return u_exec, u_next, diag

    return controller


def make_gait_traversal_controller(model, c: B.TLConstants, params, cfg: MPPIConfig, clips,
                                   reward_type="joystick", max_steps=1000,
                                   contact_k=CONTACT_K, clip_idx=0, gait_weight=1.0,
                                   device="cuda"):
    """EPMC MPC with a mocap gait prior: controls are deltas on the clip's
    joint trajectory from clip time t_clip, and the cost adds gait_weight x
    joint-space clip tracking (rollout_tasks.rollout_traversal_gait).

    f(generator, robot_state, scene, target_pos, target_spd, t_clip, u_warm,
    eps=None) -> (target_q_exec (12,), u_warm', diag). The caller advances
    t_clip by policy_dt per control step, so the gait phase persists across
    replans."""
    dev = _check_device(device, c)
    if clips.frames.device.type != dev.type:
        raise ValueError(f"clips on {clips.frames.device}, controller device {dev}")
    policy_dt = params.dt * params.substeps

    def controller(generator, robot_state, scene, target_pos, target_spd, t_clip, u_warm,
                   eps=None):
        table = traversal_cuda.pack_boxes(_corridor_scene(
            params, cfg, robot_state, scene, target_pos, target_spd, contact_k))
        tl = _tl_single(robot_state)
        ref = rollout_tl.precompute_reference(model, clips, clip_idx, t_clip, cfg.horizon,
                                              policy_dt)

        def score(u_cand):
            return traversal_cuda.rollout_traversal_fused(
                c, params, tl, u_cand, table, ref, target_pos, target_spd, reward_type,
                max_steps, gait_weight=gait_weight)

        u_opt, diag = mppi_tl.mppi_update(cfg, generator, u_warm, score, eps=eps)
        u_exec = (ref.target_joint[0, ..., 0, 0] + u_opt[0]).reshape(12)
        u_next = torch.cat([u_opt[1:], u_opt[-1:]], dim=0)
        return u_exec, u_next, diag

    return controller


def _prior_tuples(priors, gait_weight):
    """(clip indices, TraversalWeights, speed scales, gait weights) of the
    prior tuples (clip index[, weights[, speed scale[, gait weight]]]); a
    missing or None element takes its default."""
    def part(p, i, default):
        return p[i] if len(p) > i and p[i] is not None else default

    return ([int(p[0]) for p in priors],
            [part(p, 1, TraversalWeights()) for p in priors],
            [float(part(p, 2, 1.0)) for p in priors],
            [float(part(p, 3, gait_weight)) for p in priors])


def select_prior(costs, force_sel=-1):
    """The prior to execute: force_sel where it is >= 0, else the argmin of
    the priors' weighted costs (P,). As jnp.argmin, torch.argmin returns the
    first NaN where a cost is NaN, and the first of equal minima. A 0-d
    int64 tensor on the costs' device (no host read)."""
    fs = torch.as_tensor(force_sel, dtype=torch.int64, device=costs.device)
    return torch.where(fs >= 0, fs, torch.argmin(costs))


def make_multigait_traversal_controller(model, c: B.TLConstants, params, cfg: MPPIConfig, clips,
                                        priors, reward_type="joystick", max_steps=1000,
                                        contact_k=CONTACT_K, gait_weight=1.0, device="cuda"):
    """Traversal MPC with a BANK of gait priors (e.g. walk loop + jump): one
    MPPI solve per prior each replan, the cheapest weighted plan wins.

    priors: tuples whose first element is the clip index; an optional second
    element is a per-prior TraversalWeights (a crouch prior must relax the
    stand-height hinge and set crawl_gap, or the posture / clearance costs
    veto the very crawl it exists for); an optional third a speed scale on
    target_spd; an optional fourth a gait weight (default `gait_weight`).

    f(generator, robot_state, scene, target_pos, target_spd, t_clips (P,),
    u_warms (P, H, 4, 3), force_sel=-1, eps=None) -> (u_exec (12,), u_warms'
    (P, H, 4, 3), sel (0-d int64 tensor), {"prior_costs": (P,)}). One
    corridor prune per replan serves every prior; each prior's MPPI update
    scores its candidates with K2 (rollout_traversal_fused) at that prior's
    weights, speed scale and gait weight, one launch per prior per
    iteration, in prior order. force_sel >= 0 pins that prior (the eval
    loop's per-obstacle skill gating); otherwise `select_prior`. eps:
    injected raw normals, P lists of cfg.iterations tensors, one per prior
    (the reference splits its key once per prior)."""
    dev = _check_device(device, c)
    if clips.frames.device.type != dev.type:
        raise ValueError(f"clips on {clips.frames.device}, controller device {dev}")
    policy_dt = params.dt * params.substeps
    clip_ids, prior_weights, spd_scales, gait_weights = _prior_tuples(priors, gait_weight)

    def controller(generator, robot_state, scene, target_pos, target_spd, t_clips, u_warms,
                   force_sel=-1, eps=None):
        table = traversal_cuda.pack_boxes(_corridor_scene(
            params, cfg, robot_state, scene, target_pos, target_spd, contact_k))
        tl = _tl_single(robot_state)
        u_execs, u_nexts, costs = [], [], []
        for pi, cid in enumerate(clip_ids):
            ref = rollout_tl.precompute_reference(model, clips, cid, t_clips[pi], cfg.horizon,
                                                  policy_dt)
            rows = rollout_cuda.pack_reference(ref)

            def score(u_cand, rows=rows, w=prior_weights[pi], ss=spd_scales[pi],
                      gw=gait_weights[pi]):
                return traversal_cuda.rollout_traversal_fused(
                    c, params, tl, u_cand, table, rows, target_pos, target_spd * ss,
                    reward_type, max_steps, weights=w, gait_weight=gw)

            u_opt, diag = mppi_tl.mppi_update(cfg, generator, u_warms[pi], score,
                                              eps=None if eps is None else eps[pi])
            u_execs.append((ref.target_joint[0, ..., 0, 0] + u_opt[0]).reshape(12))
            u_nexts.append(torch.cat([u_opt[1:], u_opt[-1:]], dim=0))
            costs.append(diag["weighted_cost"])
        costs = torch.stack(costs)
        sel = select_prior(costs, force_sel)
        u_exec = torch.stack(u_execs).index_select(0, sel.reshape(1))[0]
        return u_exec, torch.stack(u_nexts), sel, {"prior_costs": costs}

    return controller


def _best_response(cfg: MPPIConfig, generator, c, params, n_best_response, states, refs, table,
                   flag_pos, with_flag, u_warm, gait_weight, eps):
    """Alternating best response of the two robots: for each round and each
    robot i, K3 rolls the opponent j's current plan into its base
    trajectory and one MPPI update of robot i's plan scores its candidates
    against it with K4. The trajectory stays on the device; the role is
    with_flag[i] as a tensor, so no step reads it on the host.
    Returns (plans [u_0, u_1], the last update's diagnostics)."""
    u = [u_warm[0], u_warm[1]]
    diag = {}
    for rnd in range(n_best_response):
        for i in (0, 1):
            j = 1 - i
            opp = traversal_cuda.rollout_plan_fused(c, params, states[j], u[j], table, refs[j])

            def score(u_cand, i=i, opp=opp):
                return traversal_cuda.rollout_chase_fused(
                    c, params, states[i], u_cand, table, refs[i], opp, flag_pos, with_flag[i],
                    gait_weight=gait_weight)

            u[i], diag = mppi_tl.mppi_update(cfg, generator, u[i], score,
                                             eps=None if eps is None else eps[2 * rnd + i])
    return u, diag


def _robot_states(robots):
    """Agent-leading RobotState (leaves (2, k)) -> two TLStates, batch (1, 1)."""
    return [_tl_single(B.map_state(lambda x, i=i: x[i], robots)) for i in (0, 1)]


def _shift(u):
    return torch.stack([torch.cat([ui[1:], ui[-1:]], dim=0) for ui in u])


def make_chase_solver(model, c: B.TLConstants, params, cfg: MPPIConfig, n_best_response=2,
                      device="cuda"):
    """SEPMC MPC for BOTH robots by alternating best response.

    f(generator, robots (RobotState, agent axis 2 leading), scene, flag_pos,
    with_flag (2,) bool, u_warm (2, H, 4, 3), eps=None) ->
    (target_q_exec (2, 12), u_warm' (2, H, 4, 3), diag).

    with_flag[i] True = robot i is the chaser (reference
    chase_tag_game_env.py:640-652 role convention). Controls are deltas on
    each robot's current joints (K3 and K4 with a constant reference there
    and gait_weight 0). eps: injected raw normals, one sequence of
    cfg.iterations tensors per (round, robot) update in solve order, see
    mppi_tl.mppi_update."""
    _check_device(device, c)

    def solve(generator, robots, scene, flag_pos, with_flag, u_warm, eps=None):
        table = traversal_cuda.pack_boxes(scene)
        refs = [traversal_cuda.constant_reference(robots.joint_pos[i], cfg.horizon)
                for i in (0, 1)]
        u, diag = _best_response(cfg, generator, c, params, n_best_response,
                                 _robot_states(robots), refs, table, flag_pos, with_flag, u_warm,
                                 0.0, eps)
        q0 = robots.joint_pos.reshape(2, 4, 3)
        u_exec = torch.stack([(q0[i] + u[i][0]).reshape(12) for i in (0, 1)])
        return u_exec, _shift(u), diag

    return solve


def make_gait_chase_solver(model, c: B.TLConstants, params, cfg: MPPIConfig, clips,
                           n_best_response=2, clip_idx=0, gait_weight=1.0, device="cuda"):
    """Chase solver with the walk-gait prior for BOTH robots (see
    make_gait_traversal_controller): controls are deltas on the clip's joint
    trajectory from clip time t_clip, and K4 adds gait_weight x joint-space
    clip tracking.

    f(generator, robots, scene, flag_pos, with_flag, t_clip, u_warm
    (2, H, 4, 3), eps=None) -> (target_q_exec (2, 12), u_warm', diag)."""
    dev = _check_device(device, c)
    if clips.frames.device.type != dev.type:
        raise ValueError(f"clips on {clips.frames.device}, controller device {dev}")
    policy_dt = params.dt * params.substeps

    def solve(generator, robots, scene, flag_pos, with_flag, t_clip, u_warm, eps=None):
        table = traversal_cuda.pack_boxes(scene)
        ref = rollout_tl.precompute_reference(model, clips, clip_idx, t_clip, cfg.horizon,
                                              policy_dt)
        rows = rollout_cuda.pack_reference(ref)  # packed once for all four launches
        u, diag = _best_response(cfg, generator, c, params, n_best_response,
                                 _robot_states(robots), [rows, rows], table, flag_pos, with_flag,
                                 u_warm, gait_weight, eps)
        tj0 = ref.target_joint[0, ..., 0, 0]
        u_exec = torch.stack([(tj0 + u[i][0]).reshape(12) for i in (0, 1)])
        return u_exec, _shift(u), diag

    return solve

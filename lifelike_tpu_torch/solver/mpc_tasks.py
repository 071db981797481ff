"""MPC controllers for the EPMC terrain-traversal task.

Port of the traversal controllers of lifelike_tpu.solver.mpc_tasks:
receding-horizon MPPI (solver.mppi_tl.mppi_update) over randomized
obstacle courses toward a joystick / course target (reference
max_game_elements/playground_env.py), solved online by sampling instead of
a policy network. Each solve prunes the scene to the CONTACT_K boxes nearest
the reachable corridor and scores every candidate with
ops.traversal_cuda.rollout_traversal_fused — the CUDA kernel on the card,
its plain PyTorch version on the CPU. Both controllers always go through
that wrapper; `make_traversal_controller` reduces it to the raw-delta
rollout (solver.rollout_tasks.rollout_traversal) with gait_weight = 0 and a
constant reference at the current joints.
"""
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.ops import traversal_cuda
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


def _corridor_boxes(params, cfg: MPPIConfig, robot_state, scene, target_pos, target_spd,
                    contact_k):
    """Box table (contact_k, 8) of the boxes nearest the segment from the
    base to where the horizon can reach toward the target,
    [p, p + min(dist to target, speed * H * policy_dt) * dir]."""
    p0 = robot_state.base_pos
    to_tgt = target_pos[:2] - p0[:2]
    d_tgt = torch.linalg.vector_norm(to_tgt) + 1e-9
    policy_dt = params.dt * params.substeps
    spd = torch.as_tensor(target_spd, dtype=p0.dtype, device=p0.device)
    reach = torch.minimum(d_tgt, spd * cfg.horizon * policy_dt)
    p1 = p0.clone()
    p1[:2] = p0[:2] + to_tgt / d_tgt * reach
    return traversal_cuda.pack_boxes(boxes.nearest_boxes_corridor(scene, p0, p1, contact_k))


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
        table = _corridor_boxes(params, cfg, robot_state, scene, target_pos, target_spd,
                                contact_k)
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
        table = _corridor_boxes(params, cfg, robot_state, scene, target_pos, target_spd,
                                contact_k)
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

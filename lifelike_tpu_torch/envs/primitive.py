"""Primitive-level (PMC) environment: batched mocap tracking on one device.

Port of lifelike_tpu.envs.primitive: dynamic robot + kinematic reference
ghost, 50 Hz control / 500 Hz physics, observation
  prop   = stack of 3 x [joint_pos 12, joint_vel 12, root_ang_vel_loc 3,
                         root_lin_vel_loc 3, e_g 3]
  prop_a = stack of 3 x last actions (12)
  future = 72-d future-goal features at +{1/30,1/15,1/3,1} s
action = delta joint positions (12) added to the current joints and PD-held
for the control step's substeps. Reward is the 5-term tracking reward;
termination on fall, clip end, dyn-kin divergence or integrator blowup
(reference primitive_level_env.py:337-348), and, with set_obstacle, on
touching the clip's current jump obstacle (motion_lib.ObstacleEvents;
reference :173-193).
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import dynamics, engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.solver.rollout import ref_foot_positions

PROP_SIZE = 33
ACTION_SIZE = 12
FUTURE_SIZE = 72
STACK = 3


class PrimitiveEnvConfig(NamedTuple):
    params: engine.PhysicsParams = engine.PhysicsParams()
    weights: tracking.TrackingWeights = tracking.TrackingWeights(
        # canonical training weights, reference example_pmc_train.sh:78
        joint_pos=0.3, joint_vel=0.05, end_effector=0.1, root_pose=0.5, root_vel=0.05
    )
    set_obstacle: bool = False  # jump-event obstacles (reference :173-193)
    obstacle_height: float = 0.2

    @property
    def policy_dt(self):
        return self.params.dt * self.params.substeps


class PrimitiveEnvState(NamedTuple):
    robot: RobotState
    t: torch.Tensor  # (...,) clip time in seconds
    clip_idx: torch.Tensor  # (...,) int
    prop_hist: torch.Tensor  # (..., STACK, PROP_SIZE)
    act_hist: torch.Tensor  # (..., STACK, ACTION_SIZE)
    steps: torch.Tensor  # (...,) int episode steps
    ep_ret: torch.Tensor  # (...,) accumulated episode reward


class Observation(NamedTuple):
    prop: torch.Tensor  # (..., STACK*PROP_SIZE)
    prop_a: torch.Tensor  # (..., STACK*ACTION_SIZE)
    future: torch.Tensor  # (..., FUTURE_SIZE)


def _proprioception(state: RobotState):
    """33-d proprioceptive features (reference primitive_level_env.py:247-254)."""
    lin_loc = quat.rotate_inv(state.base_orn, state.base_lin_vel)
    ang_loc = quat.rotate_inv(state.base_orn, state.base_ang_vel)
    e_g = quat.to_matrix(state.base_orn)[..., 2, :]
    return torch.cat([state.joint_pos, state.joint_vel, ang_loc, lin_loc, e_g], dim=-1)


def _observe(clips, cfg, env: PrimitiveEnvState) -> Observation:
    fut = motion_lib.sample_future(clips, env.clip_idx, env.t)
    future = motion_lib.future_goal_features(env.robot.base_pos, env.robot.base_orn, fut)
    return Observation(
        prop=env.prop_hist.reshape(tuple(env.prop_hist.shape[:-2]) + (-1,)),
        prop_a=env.act_hist.reshape(tuple(env.act_hist.shape[:-2]) + (-1,)),
        future=future,
    )


def from_robot(clips, cfg, robot: RobotState, clip_idx, t):
    """Fresh episode state at `robot` (clip `clip_idx`, time `t`)."""
    prop = _proprioception(robot)
    batch = tuple(prop.shape[:-1])
    dev = prop.device
    env = PrimitiveEnvState(
        robot=robot,
        t=t,
        clip_idx=clip_idx,
        prop_hist=prop[..., None, :].expand(batch + (STACK, PROP_SIZE)).clone(),
        act_hist=torch.zeros(batch + (STACK, ACTION_SIZE), dtype=prop.dtype, device=dev),
        steps=torch.zeros(batch, dtype=torch.int32, device=dev),
        ep_ret=torch.zeros(batch, dtype=prop.dtype, device=dev),
    )
    return env, _observe(clips, cfg, env)


def reset(model, clips, cfg: PrimitiveEnvConfig, generator, clip_probs=None, batch=()):
    """Sample clip + phase and initialize from the interpolated frame
    (reference motion_lib.py:48-57 random-phase reset). Tensors live on the
    clips' device; `generator` must be on that device."""
    dev = clips.frames.device
    n = clips.num_clips
    if clip_probs is None:
        clip_probs = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    num = int(torch.tensor(batch).prod()) if batch else 1
    clip_idx = torch.multinomial(clip_probs, num, replacement=True,
                                 generator=generator).reshape(batch)
    dtype = clips.frames.dtype
    duration = (clips.lengths.long()[clip_idx] - clips.margin - 1).to(dtype) * clips.frame_step
    t0 = torch.rand(batch, generator=generator, dtype=dtype, device=dev) * duration
    ref = motion_lib.sample_frame(clips, clip_idx, t0)
    return from_robot(clips, cfg, RobotState(*ref), clip_idx, t0)


def step(model, clips, cfg: PrimitiveEnvConfig, env: PrimitiveEnvState, action, obstacles=None):
    """One 50 Hz step. Returns (env', obs, reward, done, info).

    obstacles: optional motion_lib.ObstacleEvents; with cfg.set_obstacle
    the clip's jump obstacle ends the episode when a foot or the base
    touches it (reference :337-348 done_collision)."""
    action = torch.as_tensor(action, dtype=env.robot.joint_pos.dtype,
                             device=env.robot.joint_pos.device)
    target_q = env.robot.joint_pos + action
    robot = engine.control_step(model, cfg.params, env.robot, target_q)
    t = env.t + cfg.policy_dt

    ref = motion_lib.sample_frame(clips, env.clip_idx, t)
    kin = dynamics.forward_kinematics(model, robot)
    ref_feet = ref_foot_positions(model, ref)
    reward = tracking.tracking_reward(robot, kin.p_foot, ref, ref_feet, cfg.weights)

    fall = tracking.fall_terminated(robot)
    ended = motion_lib.is_ended(clips, env.clip_idx, t)
    diverged = tracking.divergence_terminated(robot, ref)
    blown = tracking.blown_up(robot)
    done = fall | ended | diverged | blown
    # a blown-up row's reward is garbage; zero it so batches stay finite
    reward = torch.where(blown, torch.zeros_like(reward), reward)
    if cfg.set_obstacle and obstacles is not None:
        oxy, oyaw, oactive = motion_lib.current_obstacle(obstacles, env.clip_idx, t)
        pts = torch.cat([kin.p_foot, robot.base_pos[..., None, :]], dim=-2)
        done = done | (motion_lib.obstacle_collision(oxy, oyaw, cfg.obstacle_height, pts)
                       & oactive)

    prop = _proprioception(robot)
    ep_ret = env.ep_ret + reward
    env = PrimitiveEnvState(
        robot=robot,
        t=t,
        clip_idx=env.clip_idx,
        prop_hist=torch.cat([env.prop_hist[..., 1:, :], prop[..., None, :]], dim=-2),
        act_hist=torch.cat([env.act_hist[..., 1:, :], action[..., None, :]], dim=-2),
        steps=env.steps + 1,
        ep_ret=ep_ret,
    )
    obs = _observe(clips, cfg, env)
    # episode average reward normalized by the clip's max steps
    # (reference primitive_level_env.py:236)
    max_steps = (
        (clips.lengths.long()[env.clip_idx] - clips.margin).to(ep_ret.dtype)
        * clips.frame_step / cfg.policy_dt
    )
    info = {
        "fall": fall, "clip_ended": ended, "diverged": diverged,
        "ep_avg_reward": ep_ret / torch.clamp_min(max_steps, 1.0),
    }
    return env, obs, reward, done, info


def step_autoreset(model, clips, cfg: PrimitiveEnvConfig, env: PrimitiveEnvState, action,
                   generator, clip_probs=None):
    """step, then the episodes that ended start afresh from a random clip
    phase (reset's draws from `generator`) — done rows are overwritten, no
    branching on the batch."""
    env2, obs, reward, done, info = step(model, clips, cfg, env, action)
    env_reset, obs_reset = reset(model, clips, cfg, generator, clip_probs, tuple(env.t.shape))

    def sel(new, old):
        if isinstance(new, tuple):
            return type(new)(*(sel(a, b) for a, b in zip(new, old)))
        d = done.reshape(tuple(done.shape) + (1,) * (new.dim() - done.dim()))
        return torch.where(d, new, old)

    return sel(env_reset, env2), sel(obs_reset, obs), reward, done, info

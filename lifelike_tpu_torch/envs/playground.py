"""Playground (EPMC) environment: terrain traversal on one device.

Port of lifelike_tpu.envs.playground (reference
max_game_elements/playground_env.py): procedural obstacle course
(scene.playground_gen), randomized friction and pushes, observation
  prop (33x3 stacked), prop_a (12x3), percep_2d (25x13 heightmap),
  percep_1d (128-ray lidar), percep_front (25x13 forward depth),
  target (unit direction in the base frame 2 + target speed 1)
and the joystick / average-speed reward families. The action is the
A_LLC delta joint targets (12).

Contact runs against the full box SDF (physics.engine.control_step with
scene=): feet step onto obstacle tops and vertical faces push back, so walls
and hurdles are impassable. Collisions do not end the episode; termination
is fall / timeout / reach (/ integrator blowup). With
PlaygroundConfig.hard_contact the robot steps on the impulse (PGS) plant of
physics/impulse.py instead, box rows included: the fidelity and eval mode.
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.envs import randomizer
from lifelike_tpu_torch.envs.primitive import ACTION_SIZE, PROP_SIZE, STACK, _proprioception
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.physics import engine, impulse
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.scene import boxes, playground_gen


class PlaygroundConfig(NamedTuple):
    params: engine.PhysicsParams = engine.PhysicsParams(kd=1.0, max_tau=16.0)
    scene: playground_gen.PlaygroundConfig = playground_gen.PlaygroundConfig()
    push: randomizer.PushConfig = randomizer.PushConfig()
    max_steps: int = 1000  # reference example_epmc_train.sh:98
    friction_range: tuple = (0.4, 3.0)
    target_spd_range: tuple = (0.5, 3.0)
    cmd_vary_freq_range: tuple = (25, 200)
    # episodic observation-noise ranges (0 disables)
    obs_noise_pos_xy: float = 0.0
    obs_noise_yaw: float = 0.0
    obs_noise_pos_z: float = 0.0
    # hard-contact plant: step the robot with the impulse PGS solver
    # (physics/impulse.py box rows — Bullet's solver discipline,
    # legged_robot.py:260-264) instead of the compliant penalty engine. The
    # fidelity / eval mode; the sampling MPC keeps planning compliant.
    hard_contact: bool = False

    @property
    def policy_dt(self):
        return self.params.dt * self.params.substeps

    @property
    def reward_type(self):
        return "joystick" if self.scene.element_id == 0 else "average_speed"


class PlaygroundState(NamedTuple):
    robot: RobotState
    scene: boxes.BoxScene
    push: randomizer.PushState
    counter: torch.Tensor  # (...,) int32
    target_pos: torch.Tensor  # (..., 3)
    target_spd: torch.Tensor  # (...,)
    cmd_vary_freq: torch.Tensor  # (...,) int
    last_pos_diff: torch.Tensor  # (...,)
    init_pos_diff: torch.Tensor  # (...,)
    total_spd: torch.Tensor  # (...,)
    max_spd: torch.Tensor  # (...,)
    friction: torch.Tensor  # (...,)
    noise_bias: torch.Tensor  # (..., 4) [pos_x, pos_y, yaw, pos_z]
    prop_hist: torch.Tensor  # (..., STACK, PROP_SIZE)
    act_hist: torch.Tensor  # (..., STACK, ACTION_SIZE)


class PlaygroundObs(NamedTuple):
    prop: torch.Tensor
    prop_a: torch.Tensor
    percep_2d: torch.Tensor  # (..., 25, 13)
    percep_1d: torch.Tensor  # (..., 128)
    percep_front: torch.Tensor  # (..., 25, 13)
    target: torch.Tensor  # (..., 3)


# STATES_INFO_12_RUN_0 joints (reference constants.py:108-111)
_INIT_JOINTS = np.asarray(
    [-0.0278, -0.7790, 1.6873, -0.0276, -0.7777, 1.6838,
     -0.0278, -0.7334, 1.5669, -0.0276, -0.7319, 1.5632]
)


def _observe(cfg: PlaygroundConfig, s: PlaygroundState) -> PlaygroundObs:
    nb = s.noise_bias
    pos = s.robot.base_pos + torch.stack([nb[..., 0], nb[..., 1], torch.zeros_like(nb[..., 0])],
                                         dim=-1)
    yaw = quat.yaw(s.robot.base_orn) + nb[..., 2]
    p2d = boxes.perception_height(s.scene, pos, s.robot.base_orn)
    # episodic z-bias on the nonzero heights
    zb = nb[..., 3][..., None, None]
    p2d = torch.where((p2d > 0.01) & (p2d < 0.6), p2d + zb, torch.zeros_like(p2d))
    p1d = boxes.lidar(s.scene, pos, yaw)
    pfront = boxes.perception_front(s.scene, pos, s.robot.base_orn)

    diff = s.target_pos - pos
    dir_base = quat.rotate_inv(s.robot.base_orn, diff)[..., :2]
    dir_base = dir_base / torch.linalg.vector_norm(dir_base, dim=-1, keepdim=True).clamp_min(1e-8)
    target = torch.cat([dir_base, s.target_spd[..., None]], dim=-1)
    return PlaygroundObs(
        prop=s.prop_hist.reshape(tuple(s.prop_hist.shape[:-2]) + (-1,)),
        prop_a=s.act_hist.reshape(tuple(s.act_hist.shape[:-2]) + (-1,)),
        percep_2d=p2d,
        percep_1d=p1d,
        percep_front=pfront,
        target=target,
    )


def _uniform(gen, shape, lo, hi, dtype):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def reset(model, cfg: PlaygroundConfig, generator, batch=(), dtype=torch.float32):
    """Fresh episodes on the generator's device: a random scene per episode,
    the robot standing at [0, 0, 0.5] with a random yaw, random friction,
    target speed, re-targeting period and observation noise.
    Returns (state, obs)."""
    batch = tuple(batch)
    gen, dev = generator, generator.device
    if batch == ():
        scene = playground_gen.generate(gen, cfg.scene, dtype)
    else:
        scenes = [playground_gen.generate(gen, cfg.scene, dtype) for _ in range(math.prod(batch))]
        scene = boxes.BoxScene(*(torch.stack(x).reshape(batch + x[0].shape)
                                 for x in zip(*scenes)))

    yaw0 = _uniform(gen, batch, 0.0, 2.0 * math.pi, dtype)
    base_pos = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    base_pos[..., 2] = 0.5
    robot = RobotState(
        base_pos=base_pos,
        base_orn=quat.from_yaw(yaw0),
        base_lin_vel=torch.zeros(batch + (3,), dtype=dtype, device=dev),
        base_ang_vel=torch.zeros(batch + (3,), dtype=dtype, device=dev),
        joint_pos=torch.as_tensor(_INIT_JOINTS, dtype=dtype, device=dev).expand(batch + (12,))
        .clone(),
        joint_vel=torch.zeros(batch + (12,), dtype=dtype, device=dev),
    )
    friction = _uniform(gen, batch, *cfg.friction_range, dtype)
    lo, hi = cfg.cmd_vary_freq_range
    cmd_freq = torch.randint(lo, hi, batch, generator=gen, device=dev, dtype=torch.int32)
    spd = _uniform(gen, batch, *cfg.target_spd_range, dtype)
    scale = torch.tensor([cfg.obs_noise_pos_xy, cfg.obs_noise_pos_xy, cfg.obs_noise_yaw,
                          cfg.obs_noise_pos_z], dtype=dtype, device=dev)
    noise = _uniform(gen, batch + (4,), -1.0, 1.0, dtype) * scale
    pos_diff = torch.linalg.vector_norm((scene.target_pos - robot.base_pos)[..., :2], dim=-1)
    prop = _proprioception(robot)
    s = PlaygroundState(
        robot=robot,
        scene=scene,
        push=randomizer.push_reset(gen, cfg.push, cfg.policy_dt, batch, dtype),
        counter=torch.zeros(batch, dtype=torch.int32, device=dev),
        target_pos=scene.target_pos,
        target_spd=spd,
        cmd_vary_freq=cmd_freq,
        last_pos_diff=pos_diff,
        init_pos_diff=pos_diff,
        total_spd=torch.zeros(batch, dtype=dtype, device=dev),
        max_spd=torch.zeros(batch, dtype=dtype, device=dev),
        friction=friction,
        noise_bias=noise,
        prop_hist=prop[..., None, :].expand(batch + (STACK, PROP_SIZE)).clone(),
        act_hist=torch.zeros(batch + (STACK, ACTION_SIZE), dtype=dtype, device=dev),
    )
    return s, _observe(cfg, s)


def _heading_reward(robot: RobotState, dir_w, scale):
    yaw = quat.yaw(robot.base_orn)
    return torch.exp(
        (torch.cos(yaw) * dir_w[..., 0] + torch.sin(yaw) * dir_w[..., 1] - 1.0) * scale
    )


def step(model, cfg: PlaygroundConfig, s: PlaygroundState, action, generator):
    """action: (..., 12) delta joint targets (or a dict with 'A_LLC').
    Returns (state', obs, reward, done, info)."""
    a_llc = action["A_LLC"] if isinstance(action, dict) else action
    a_llc = torch.as_tensor(a_llc, dtype=s.robot.joint_pos.dtype, device=s.robot.joint_pos.device)
    gen = generator

    # joystick re-targeting every cmd_vary_freq steps
    retarget = (s.counter % s.cmd_vary_freq) == 0
    if cfg.scene.element_id == 0:
        theta = _uniform(gen, tuple(s.counter.shape), 0.0, 2.0 * math.pi, s.target_pos.dtype)
        new_target = s.robot.base_pos + 100.0 * torch.stack(
            [torch.cos(theta), torch.sin(theta), torch.zeros_like(theta)], dim=-1
        )
        target_pos = torch.where(retarget[..., None], new_target, s.target_pos)
        new_diff = torch.linalg.vector_norm((target_pos - s.robot.base_pos)[..., :2], dim=-1)
        last_pos_diff = torch.where(retarget, new_diff, s.last_pos_diff)
    else:
        target_pos = s.target_pos
        last_pos_diff = s.last_pos_diff
    new_spd = _uniform(gen, tuple(s.counter.shape), *cfg.target_spd_range, s.target_spd.dtype)
    target_spd = torch.where(retarget, new_spd, s.target_spd)

    push, ext_force = randomizer.push_step(gen, cfg.push, s.push, cfg.policy_dt)
    params = cfg.params._replace(foot_friction=s.friction[..., None], ext_force=ext_force)
    target_q = s.robot.joint_pos + a_llc
    if cfg.hard_contact:
        # impulse PGS plant; the warm-start impulses reset every control step
        # (within the step the substep chain still warm-starts)
        ip = impulse.ImpulseParams(
            kp=cfg.params.kp, kd=cfg.params.kd, max_tau=cfg.params.max_tau, mu=s.friction,
            dt=cfg.params.dt, substeps=cfg.params.substeps, ext_force=ext_force)
        lam = impulse.init_lam(s.robot.base_pos.shape[:-1], s.robot.base_pos.dtype,
                               scene=s.scene, device=s.robot.base_pos.device)
        robot, _ = impulse.control_step(model, ip, s.robot, lam, target_q, scene=s.scene)
    else:
        robot = engine.control_step(model, params, s.robot, target_q, scene=s.scene)

    # speed toward the target
    diff = (target_pos - robot.base_pos)[..., :2]
    pos_diff = torch.linalg.vector_norm(diff, dim=-1)
    dir_w = diff / pos_diff[..., None].clamp_min(1e-8)
    spd = (robot.base_lin_vel[..., 0] * dir_w[..., 0]
           + robot.base_lin_vel[..., 1] * dir_w[..., 1]).abs()
    total_spd = s.total_spd + spd
    max_spd = torch.maximum(s.max_spd, spd)

    counter = s.counter + 1
    fall = tracking.fall_terminated(robot)
    timeout = counter >= cfg.max_steps
    reached = pos_diff < 0.5
    blown = tracking.blown_up(robot)
    done = fall | timeout | reached | blown

    inv_max = 1.0 / float(cfg.max_steps)
    r_rot = _heading_reward(robot, dir_w, 5.0)
    if cfg.reward_type == "joystick":
        r_vel = torch.exp(-(spd - target_spd).abs())
        reward = r_vel * r_rot * inv_max
    else:  # average_speed
        r_dist = (pos_diff - last_pos_diff) / s.init_pos_diff.clamp_min(1e-8)
        reward = r_rot * inv_max * 0.1 * 2.0 - r_dist * 0.1
        avg_spd = total_spd / counter
        r_avg = torch.exp(-(avg_spd - target_spd).abs())
        reward = reward + torch.where(reached, r_avg, torch.zeros_like(r_avg))

    prop = _proprioception(robot)
    s = s._replace(
        robot=robot,
        push=push,
        counter=counter,
        target_pos=target_pos,
        target_spd=target_spd,
        last_pos_diff=pos_diff,
        total_spd=total_spd,
        max_spd=max_spd,
        prop_hist=torch.cat([s.prop_hist[..., 1:, :], prop[..., None, :]], dim=-2),
        act_hist=torch.cat([s.act_hist[..., 1:, :], a_llc[..., None, :]], dim=-2),
    )
    obs = _observe(cfg, s)
    info = {
        "fall": fall,
        "timeout": timeout,
        "reached": reached,
        "ave_spd": total_spd / counter,
        "max_spd": max_spd,
    }
    return s, obs, reward, done, info


def _select(done, new, old):
    d = done.reshape(tuple(done.shape) + (1,) * (new.dim() - done.dim()))
    return torch.where(d, new, old)


def step_autoreset(model, cfg: PlaygroundConfig, s: PlaygroundState, action, generator):
    """step, then episodes that ended start afresh (batched state)."""
    s2, obs, reward, done, info = step(model, cfg, s, action, generator)
    s_new, obs_new = reset(model, cfg, generator, tuple(s.counter.shape),
                           s.robot.base_pos.dtype)

    def sel(new, old):
        if isinstance(new, tuple):
            return type(new)(*(sel(a, b) for a, b in zip(new, old)))
        return _select(done, new, old)

    return sel(s_new, s2), sel(obs_new, obs), reward, done, info

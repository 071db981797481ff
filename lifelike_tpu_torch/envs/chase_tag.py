"""Chase Tag Game (SEPMC) environment: two-robot self-play on one device.

Port of lifelike_tpu.envs.chase_tag (reference
max_game/chase_tag_game_env.py): two MAX robots in the V4 arena
(scene.arena_gen), 25 Hz control / 500 Hz physics (20 substeps),
per-agent observation
  prop, prop_a, percept_2d, percept_1d, percept_front,
  percept_vec (pos 3 + cos/sin yaw),
  oppo_info (15 = visible + oppo pos + local pos diff + yaw diff cos/sin +
             local oppo lin/ang vel, zeroed when not visible) + cheat variant,
  flag_info (7 = visible + flag pos + local diff) + cheat,
  with_flag (2), control_spd (1)
and the game logic: the robot WITHOUT the flag-role grabs the flag to swap
roles (the flag teleports, +-1 reward on the switch frame, :573-581,
:640-652); a catch — robot 0's leg / wheel links touching the other robot
(:426-456) — ends the game with +-1 for the chaser (:412-419); visibility
is occlusion-aware (root-to-root segment, then a head -> convex-point ray
fan, against the arena boxes) within a field-of-view cone (:472-493).
Robot-robot interpenetration is resisted by a compliant trunk-sphere
spring-damper impulse applied at the control rate. Random draws (arena,
spawn, roles, pushes, flag moves) come from a torch.Generator: the
distributions are the reference's, the numbers not.
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.envs import randomizer
from lifelike_tpu_torch.envs.playground import _INIT_JOINTS
from lifelike_tpu_torch.envs.primitive import ACTION_SIZE, STACK, _proprioception
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.physics import dynamics, engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.scene import arena_fixed, arena_gen, boxes

FLAG_RADIUS = 0.3  # flag box 0.1 x 0.1 x 0.5 grab distance

# trunk collision box and handle offsets from max.urdf (robot/max_urdf_data):
# the reference's convex point set is feet + wheels + handles
# (legged_robot.py:150-156); the head point is the front handle (:154-156).
TRUNK_HALF = (0.283, 0.205, 0.11)
HEAD_OFFSET = (0.1415, 0.0, 0.085)
HIND_OFFSET = (-0.2485, 0.0, 0.085)
CATCH_MARGIN = 0.06  # link-sphere radius + Bullet contact slop
# compliant robot-robot trunk contact (one bounding sphere per trunk: the
# push direction stays well-defined at any interpenetration depth)
RR_RADIUS = 0.25  # between the trunk half-width and half-length
RR_KN = 2500.0  # N/m trunk-trunk spring
RR_DN = 60.0  # N s/m normal damping


class ChaseTagConfig(NamedTuple):
    params: engine.PhysicsParams = engine.PhysicsParams(
        kd=1.0, max_tau=16.0, substeps=20  # 25 Hz control (reference :23)
    )
    arena: arena_gen.ArenaConfig = arena_gen.ArenaConfig()
    version: str = "v4"  # GameManager arena version (game_manager.py:5-18)
    height_offset: tuple = (0.0, 0.0)  # randomize_height hook (v1-v3 arenas)
    push: randomizer.PushConfig = randomizer.PushConfig()
    max_steps: int = 1000
    friction_range: tuple = (0.4, 1.0)
    visible_angle: float = math.pi  # FOV half-angle (reference :31)
    control_spd_range: tuple = (0.5, 3.0)  # episodic_fix_spd (:262)

    @property
    def policy_dt(self):
        return self.params.dt * self.params.substeps


class ChaseTagState(NamedTuple):
    robots: RobotState  # leaves (..., 2, k) — agent axis after batch
    scene: boxes.BoxScene
    push: randomizer.PushState
    counter: torch.Tensor  # (...,) int32
    with_flag: torch.Tensor  # (..., 2) bool: True = chaser role
    flag_pos: torch.Tensor  # (..., 3)
    control_spd: torch.Tensor  # (...,)
    friction: torch.Tensor  # (...,)
    total_spd: torch.Tensor  # (..., 2)
    max_spd: torch.Tensor  # (..., 2)
    prop_hist: torch.Tensor  # (..., 2, STACK, 33)
    act_hist: torch.Tensor  # (..., 2, STACK, 12)


class ChaseTagObs(NamedTuple):
    """All leaves have an agent axis 2 after the batch axes."""

    prop: torch.Tensor
    prop_a: torch.Tensor
    percept_2d: torch.Tensor
    percept_1d: torch.Tensor
    percept_front: torch.Tensor
    percept_vec: torch.Tensor  # (..., 2, 5)
    oppo_info: torch.Tensor  # (..., 2, 15)
    oppo_info_cheat: torch.Tensor
    flag_info: torch.Tensor  # (..., 2, 7)
    flag_info_cheat: torch.Tensor
    with_flag: torch.Tensor  # (..., 2, 2)
    control_spd: torch.Tensor  # (..., 2, 1)


def _segment_visible(scene, p_from, p_to):
    """True when no active box blocks the segment p_from -> p_to."""
    d = p_to - p_from
    dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
    t = boxes.ray_box_distance(scene, p_from[..., None, :], (d / dist)[..., None, :],
                               math.inf)[..., 0]
    return t >= dist[..., 0]


def _scene_axes(scene, n):
    """The scene with n singleton axes before the box axis, so its leaves
    broadcast over per-agent (and per-point) queries."""
    ix = (Ellipsis,) + (None,) * n
    return boxes.BoxScene(center=scene.center[ix + (slice(None), slice(None))],
                          half=scene.half[ix + (slice(None), slice(None))],
                          active=scene.active[ix + (slice(None),)],
                          target_pos=scene.target_pos[ix + (slice(None),)])


def _convex_points(model, r: RobotState, kin=None):
    """(..., 2, 11, 3): base, front/hind handles, 4 feet, 4 wheels per robot
    — the reference's ray-target convex point set (legged_robot.py:150-156),
    with the base standing in for the trunk centroid."""
    if kin is None:
        kin = dynamics.forward_kinematics(model, r)
    Rm = quat.to_matrix(r.base_orn)

    def off(o):
        return r.base_pos + torch.einsum(
            "...ij,j->...i", Rm, torch.tensor(o, dtype=r.base_pos.dtype, device=Rm.device))

    return torch.cat(
        [r.base_pos[..., None, :], off(HEAD_OFFSET)[..., None, :], off(HIND_OFFSET)[..., None, :],
         kin.p_foot, kin.p_wheel],
        dim=-2,
    ), kin


def _link_catch(model, r: RobotState, kin=None):
    """Reference _check_contact_status(robot 0) (:426-456): any of robot 0's
    leg / wheel link spheres touching the other robot — against the
    opponent's trunk collision box (point SDF) and its foot / wheel spheres.
    Returns bool (...)."""
    if kin is None:
        kin = dynamics.forward_kinematics(model, r)
    legs0 = torch.cat([kin.p_foot[..., 0, :, :], kin.p_wheel[..., 0, :, :]], dim=-2)  # (..., 8, 3)
    pos1 = r.base_pos[..., 1, :]
    orn1 = r.base_orn[..., 1, :]
    local = quat.rotate_inv(orn1[..., None, :], legs0 - pos1[..., None, :])
    half = torch.tensor(TRUNK_HALF, dtype=local.dtype, device=local.device)
    outside = torch.clamp_min(local.abs() - half, 0.0)
    d_box = torch.linalg.vector_norm(outside, dim=-1)  # 0 inside the trunk box
    foot_r = float(model.foot_radius)
    hit_trunk = torch.any(d_box < foot_r + CATCH_MARGIN, dim=-1)
    legs1 = torch.cat([kin.p_foot[..., 1, :, :], kin.p_wheel[..., 1, :, :]], dim=-2)
    d_pp = torch.linalg.vector_norm(legs0[..., :, None, :] - legs1[..., None, :, :], dim=-1)
    hit_leg = torch.any(torch.any(d_pp < 2.0 * foot_r + CATCH_MARGIN, dim=-1), dim=-1)
    return hit_trunk | hit_leg


def _robot_contact_impulse(model, cfg: ChaseTagConfig, r: RobotState):
    """Compliant trunk-trunk contact: one bounding sphere per trunk,
    spring-damper normal force integrated over one control step into the
    base velocities. Returns dv (..., 2, 3)."""
    d = r.base_pos[..., 0, :] - r.base_pos[..., 1, :]
    dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-6)
    n = d / dist
    overlap = torch.clamp_min(2.0 * RR_RADIUS - dist, 0.0)
    v_rel = r.base_lin_vel[..., 0, :] - r.base_lin_vel[..., 1, :]
    vn = torch.sum(v_rel * n, dim=-1, keepdim=True)
    f = torch.where(overlap > 0.0, RR_KN * overlap - RR_DN * vn, torch.zeros_like(vn))
    f = torch.clamp_min(f, 0.0)  # unilateral: no sticking
    mass = float(model.base_mass + model.link_mass.sum())
    dv = (f * n) * (cfg.policy_dt / mass)
    return torch.stack([dv, -dv], dim=-2)


def _observe(model, cfg: ChaseTagConfig, s: ChaseTagState) -> ChaseTagObs:
    r = s.robots
    pos = r.base_pos  # (..., 2, 3)
    orn = r.base_orn
    yaw = quat.yaw(orn)

    scene_a = _scene_axes(s.scene, 1)  # per agent
    p2d = boxes.perception_height(scene_a, pos, orn)
    p1d = boxes.lidar(scene_a, pos, yaw)
    pfront = boxes.perception_front(scene_a, pos, orn)
    pvec = torch.cat([pos, torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]], dim=-1)

    # opponent info
    oppo_pos = torch.flip(pos, dims=(-2,))
    oppo_yaw = torch.flip(yaw, dims=(-1,))
    oppo_lin = torch.flip(r.base_lin_vel, dims=(-2,))
    oppo_ang = torch.flip(r.base_ang_vel, dims=(-2,))
    diff = oppo_pos - pos
    # reference _ray_test_visible (:472-493): root->root segment first, then
    # a fan of rays from the head point to the opponent's convex points
    seg_vis = _segment_visible(scene_a, pos, oppo_pos)
    pts, _ = _convex_points(model, r)  # (..., 2, P, 3)
    head = pts[..., 1, :]  # front handle (..., 2, 3)
    oppo_pts = torch.flip(pts, dims=(-3,))  # the opponent's points per agent
    ray_vis = torch.any(
        _segment_visible(_scene_axes(s.scene, 2), head[..., None, :].expand(oppo_pts.shape),
                         oppo_pts),
        dim=-1,
    )
    seg_vis = seg_vis | ray_vis
    dxy = diff[..., :2]
    cos_theta = ((torch.cos(yaw) * dxy[..., 0] + torch.sin(yaw) * dxy[..., 1])
                 / torch.linalg.vector_norm(dxy, dim=-1).clamp_min(1e-8))
    visible = seg_vis & (cos_theta >= math.cos(cfg.visible_angle))
    diff_local = quat.rotate_inv(orn, diff)
    yaw_diff = oppo_yaw - yaw
    oppo_state = torch.cat(
        [visible[..., None].to(pos.dtype), oppo_pos, diff_local,
         torch.cos(yaw_diff)[..., None], torch.sin(yaw_diff)[..., None],
         quat.rotate_inv(orn, oppo_lin), quat.rotate_inv(orn, oppo_ang)],
        dim=-1,
    )
    oppo_info = torch.where(visible[..., None], oppo_state, torch.zeros_like(oppo_state))

    # flag info (always visible, reference :560)
    flag = s.flag_pos[..., None, :]
    flag_diff_local = quat.rotate_inv(orn, flag - pos)
    ones = torch.ones_like(yaw[..., None])
    flag_state = torch.cat([ones, flag.expand(pos.shape), flag_diff_local], dim=-1)

    wf = s.with_flag.to(pos.dtype)
    with_flag = torch.stack([wf, torch.flip(wf, dims=(-1,))], dim=-2)
    return ChaseTagObs(
        prop=s.prop_hist.reshape(tuple(s.prop_hist.shape[:-2]) + (-1,)),
        prop_a=s.act_hist.reshape(tuple(s.act_hist.shape[:-2]) + (-1,)),
        percept_2d=p2d,
        percept_1d=p1d,
        percept_front=pfront,
        percept_vec=pvec,
        oppo_info=oppo_info,
        oppo_info_cheat=oppo_state,
        flag_info=flag_state,
        flag_info_cheat=flag_state,
        with_flag=with_flag,
        control_spd=s.control_spd[..., None, None].expand(tuple(yaw.shape) + (1,)),
    )


def _uniform(gen, shape, lo, hi, dtype):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def _arena(cfg: ChaseTagConfig, gen, batch, dtype):
    if cfg.version != "v4":  # fixed arena versions (GameManager parity)
        return arena_fixed.make_arena(cfg.version, gen, height_offset=cfg.height_offset,
                                      batch=batch, dtype=dtype)
    return arena_fixed.make_arena("v4", gen, element_config=cfg.arena, batch=batch, dtype=dtype)


def reset(model, cfg: ChaseTagConfig, generator, batch=(), dtype=torch.float32):
    """Fresh games on the generator's device: an arena per game, both robots
    standing at random spots in +-2 m (on whatever occupies the spot) with
    random yaws, a random flag and roles, pushes, friction and control
    speed. Returns (state, obs)."""
    batch = tuple(batch)
    gen, dev = generator, generator.device
    scene = _arena(cfg, gen, batch, dtype)
    pos_xy = _uniform(gen, batch + (2, 2), -2.0, 2.0, dtype)
    # stand on whatever occupies the spawn point (fixed-arena blocks, v4
    # cubes) instead of spawning inside it and getting ejected by contact
    ground = boxes.heightmap_at(scene, pos_xy)
    pos = torch.cat([pos_xy, (ground + 0.5)[..., None]], dim=-1)
    yaw0 = _uniform(gen, batch + (2,), 0.0, 2.0 * math.pi, dtype)
    robots = RobotState(
        base_pos=pos,
        base_orn=quat.from_yaw(yaw0),
        base_lin_vel=torch.zeros(batch + (2, 3), dtype=dtype, device=dev),
        base_ang_vel=torch.zeros(batch + (2, 3), dtype=dtype, device=dev),
        joint_pos=torch.as_tensor(_INIT_JOINTS, dtype=dtype, device=dev).expand(batch + (2, 12))
        .clone(),
        joint_vel=torch.zeros(batch + (2, 12), dtype=dtype, device=dev),
    )
    flag_xy = _uniform(gen, batch + (2,), -2.0, 2.0, dtype)
    flag_pos = torch.cat([flag_xy, torch.full(batch + (1,), 0.25, dtype=dtype, device=dev)], dim=-1)
    chaser0 = torch.rand(batch, generator=gen, device=dev) < 0.5
    with_flag = torch.stack([chaser0, ~chaser0], dim=-1)
    prop = _proprioception(robots)
    s = ChaseTagState(
        robots=robots,
        scene=scene,
        push=randomizer.push_reset(gen, cfg.push, cfg.policy_dt, batch, dtype),
        counter=torch.zeros(batch, dtype=torch.int32, device=dev),
        with_flag=with_flag,
        flag_pos=flag_pos,
        control_spd=_uniform(gen, batch, *cfg.control_spd_range, dtype),
        friction=_uniform(gen, batch, *cfg.friction_range, dtype),
        total_spd=torch.zeros(batch + (2,), dtype=dtype, device=dev),
        max_spd=torch.zeros(batch + (2,), dtype=dtype, device=dev),
        prop_hist=prop[..., None, :].expand(tuple(prop.shape[:-1]) + (STACK, prop.shape[-1]))
        .clone(),
        act_hist=torch.zeros(batch + (2, STACK, ACTION_SIZE), dtype=dtype, device=dev),
    )
    return s, _observe(model, cfg, s)


def step(model, cfg: ChaseTagConfig, s: ChaseTagState, actions, generator):
    """actions: (..., 2, 12) delta joint targets, or a dict with 'A_LLC'.

    Returns (state', obs, rewards (..., 2), done (...,), info)."""
    a_llc = actions["A_LLC"] if isinstance(actions, dict) else actions
    r0 = s.robots
    a_llc = torch.as_tensor(a_llc, dtype=r0.joint_pos.dtype, device=r0.joint_pos.device)
    gen = generator

    push, ext_force = randomizer.push_step(gen, cfg.push, s.push, cfg.policy_dt)
    params = cfg.params._replace(foot_friction=s.friction[..., None, None],
                                 ext_force=ext_force[..., None, :])
    # full box SDF contact: arena walls and blocks push back as hard bodies
    robots = engine.control_step(model, params, r0, r0.joint_pos + a_llc,
                                 scene=_scene_axes(s.scene, 1))
    # compliant robot-robot trunk contact (Bullet: rigid solver contact)
    robots = robots._replace(
        base_lin_vel=robots.base_lin_vel + _robot_contact_impulse(model, cfg, robots))

    counter = s.counter + 1
    spd = torch.linalg.vector_norm(robots.base_lin_vel[..., :2], dim=-1)  # (..., 2)
    total_spd = s.total_spd + spd
    max_spd = torch.maximum(s.max_spd, spd)

    # flag grab: the non-chaser touching the flag swaps roles (:573-581)
    dist_flag = torch.linalg.vector_norm((robots.base_pos - s.flag_pos[..., None, :])[..., :2],
                                         dim=-1)
    touch_flag = dist_flag < FLAG_RADIUS
    escapee_touches = torch.any(touch_flag & ~s.with_flag, dim=-1)
    with_flag = torch.where(escapee_touches[..., None], ~s.with_flag, s.with_flag)
    shape = tuple(s.counter.shape)
    new_flag_xy = _uniform(gen, shape + (2,), -2.0, 2.0, s.flag_pos.dtype)
    new_flag = torch.cat([new_flag_xy, torch.full(shape + (1,), 0.25, dtype=s.flag_pos.dtype,
                                                  device=s.flag_pos.device)], dim=-1)
    flag_pos = torch.where(escapee_touches[..., None], new_flag, s.flag_pos)

    # per-step reward: +-1 on the switch frame for the NEW chaser (:640-652)
    sw = escapee_touches.to(spd.dtype)
    rewards = torch.where(with_flag, sw[..., None], -sw[..., None])

    # terminations: the reference only checks robot 0's fall (:463)
    fall0 = tracking.fall_terminated(RobotState(*(x[..., 0, :] for x in robots)))
    timeout = counter >= cfg.max_steps
    # catch = robot 0's leg/wheel links touching the other robot (:426-456)
    contact = _link_catch(model, robots)
    # integrator-blowup guard over EITHER robot (NaN states compare False in
    # fall0 / contact and would never terminate)
    blown = torch.any(tracking.blown_up(robots), dim=-1)
    done = fall0 | timeout | contact | blown

    # terminal +-1: the chaser catches (:412-419)
    chaser_sign = torch.where(with_flag, 1.0, -1.0).to(rewards.dtype)
    rewards = rewards + torch.where((contact & done)[..., None], chaser_sign,
                                    torch.zeros_like(chaser_sign))

    prop = _proprioception(robots)
    s = s._replace(
        robots=robots,
        push=push,
        counter=counter,
        with_flag=with_flag,
        flag_pos=flag_pos,
        total_spd=total_spd,
        max_spd=max_spd,
        prop_hist=torch.cat([s.prop_hist[..., 1:, :], prop[..., None, :]], dim=-2),
        act_hist=torch.cat([s.act_hist[..., 1:, :], a_llc[..., None, :]], dim=-2),
    )
    obs = _observe(model, cfg, s)
    info = {
        "avg_spd0": total_spd[..., 0] / counter,
        "avg_spd1": total_spd[..., 1] / counter,
        "max_spd0": max_spd[..., 0],
        "max_spd1": max_spd[..., 1],
        "caught": contact,
    }
    return s, obs, rewards, done, info


def _select(done, new, old):
    if isinstance(new, tuple):
        return type(new)(*(_select(done, a, b) for a, b in zip(new, old)))
    d = done.reshape(tuple(done.shape) + (1,) * (new.dim() - done.dim()))
    return torch.where(d, new, old)


def step_autoreset(model, cfg: ChaseTagConfig, s: ChaseTagState, actions, generator):
    """step, then games that ended start afresh (batched state)."""
    s2, obs, rewards, done, info = step(model, cfg, s, actions, generator)
    s_new, obs_new = reset(model, cfg, generator, tuple(s.counter.shape),
                           s.robots.base_pos.dtype)
    return _select(done, s_new, s2), _select(done, obs_new, obs), rewards, done, info

"""Carry the JAX package's structures over to the port.

The MPC has no learned weights; its parameters are the robot model, the
tile-layout constants, the physics parameters, the clip library and the
states and references that flow between its layers. Each function here
takes one of those structures as the JAX package holds it — any object with
the same field names whose leaves are numpy arrays (or array-likes such as
a jax.Array converted by np.asarray) — and returns the port's structure on a
given device and dtype. Nothing here imports JAX or the JAX package.
"""
import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.envs.chase_tag import ChaseTagConfig, ChaseTagState
from lifelike_tpu_torch.envs.playground import PlaygroundState
from lifelike_tpu_torch.envs.primitive import PrimitiveEnvState
from lifelike_tpu_torch.envs.randomizer import PushConfig, PushState
from lifelike_tpu_torch.motion.motion_lib import MotionClips
from lifelike_tpu_torch.physics.batched import TLConstants, TLState
from lifelike_tpu_torch.physics.contact import ContactParams
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.physics.engine import PhysicsParams
from lifelike_tpu_torch.physics.impulse import ImpulseParams
from lifelike_tpu_torch.robot.model import MaxModel
from lifelike_tpu_torch.scene.arena_gen import ArenaConfig
from lifelike_tpu_torch.scene.boxes import BoxScene
from lifelike_tpu_torch.solver.ilqr import ILQRConfig
from lifelike_tpu_torch.solver.rollout_tl import RefTraj


def _tensor(x, device, dtype=None):
    a = np.array(x)  # copy: JAX buffers are read-only
    t = torch.as_tensor(a, device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _fields(obj, cls, device, dtype):
    dev = _device.resolve_device(device)
    return cls(**{f: _tensor(getattr(obj, f), dev, dtype) for f in cls._fields})


def max_model(m) -> MaxModel:
    """robot.model.MaxModel (numpy in both packages) -> the port's MaxModel."""
    kw = {}
    for name in MaxModel.__dataclass_fields__:
        v = getattr(m, name)
        kw[name] = float(v) if np.ndim(v) == 0 else np.array(v)
    return MaxModel(**kw)


def tl_constants(c, device="cuda", dtype=None) -> TLConstants:
    """physics.batched.TLConstants -> port TLConstants (floats stay floats)."""
    dev = _device.resolve_device(device)
    kw = {}
    for f in TLConstants._fields:
        v = getattr(c, f)
        kw[f] = float(v) if np.ndim(v) == 0 else _tensor(v, dev, dtype)
    return TLConstants(**kw)


def physics_params(p) -> PhysicsParams:
    """physics.engine.PhysicsParams -> port PhysicsParams (host scalars)."""
    cp = p.contact
    return PhysicsParams(
        kp=float(p.kp), kd=float(p.kd), max_tau=float(p.max_tau),
        foot_friction=float(p.foot_friction), dt=float(p.dt), substeps=int(p.substeps),
        ext_force=np.array(p.ext_force, np.float32),
        contact=ContactParams(*(float(getattr(cp, f)) for f in ContactParams._fields)),
        mass_freeze=int(p.mass_freeze),
    )


def impulse_params(p, device="cuda", dtype=None) -> ImpulseParams:
    """physics.impulse.ImpulseParams -> port ImpulseParams: scalar leaves as
    host numbers, per-element leaves (kp, kd, max_tau, mu, ext_force of a
    randomized batch) as tensors on `device`."""
    dev = _device.resolve_device(device)

    def leaf(x):
        return float(x) if np.ndim(x) == 0 else _tensor(x, dev, dtype)

    return ImpulseParams(
        kp=leaf(p.kp), kd=leaf(p.kd), max_tau=leaf(p.max_tau), mu=leaf(p.mu),
        dt=float(p.dt), substeps=int(p.substeps), iterations=int(p.iterations),
        erp=float(p.erp), slop=float(p.slop), ext_force=_tensor(p.ext_force, dev, dtype),
        use_pallas_pgs=bool(p.use_pallas_pgs),
    )


def ilqr_config(cfg) -> ILQRConfig:
    """solver.ilqr.ILQRConfig -> port ILQRConfig, field by field (host
    scalars; the line-search alphas as a tuple of floats)."""
    ints = ("iterations", "lin_substeps")
    kw = {f: (int if f in ints else float)(getattr(cfg, f)) for f in ILQRConfig._fields
          if f != "line_search"}
    return ILQRConfig(line_search=tuple(float(a) for a in cfg.line_search), **kw)


def motion_clips(mc, device="cuda") -> MotionClips:
    dev = _device.resolve_device(device)
    return MotionClips(
        frames=_tensor(mc.frames, dev), lengths=_tensor(mc.lengths, dev),
        frame_step=float(mc.frame_step), margin=int(mc.margin),
    )


def ref_traj(r, device="cuda", dtype=None) -> RefTraj:
    return _fields(r, RefTraj, device, dtype)


def tl_state(s, device="cuda", dtype=None) -> TLState:
    return _fields(s, TLState, device, dtype)


def robot_state(s, device="cuda", dtype=None) -> RobotState:
    return _fields(s, RobotState, device, dtype)


def primitive_env_state(e, device="cuda", dtype=None) -> PrimitiveEnvState:
    """envs.primitive.PrimitiveEnvState (robot, t, clip_idx, histories)."""
    dev = _device.resolve_device(device)
    kw = {f: _tensor(getattr(e, f), dev, dtype) for f in PrimitiveEnvState._fields
          if f != "robot"}
    return PrimitiveEnvState(robot=robot_state(e.robot, dev, dtype), **kw)


def box_scene(b, device="cuda", dtype=None) -> BoxScene:
    """scene.boxes.BoxScene (center, half, active mask, target_pos)."""
    return _fields(b, BoxScene, device, dtype)


def playground_state(e, device="cuda", dtype=None) -> PlaygroundState:
    """envs.playground.PlaygroundState (robot, scene, push state, episode
    counters and histories); integer and bool leaves keep their types."""
    dev = _device.resolve_device(device)
    nested = {"robot": robot_state(e.robot, dev, dtype),
              "scene": box_scene(e.scene, dev, dtype),
              "push": _fields(e.push, PushState, dev, dtype)}
    kw = {f: _tensor(getattr(e, f), dev, dtype) for f in PlaygroundState._fields
          if f not in nested}
    return PlaygroundState(**nested, **kw)


def chase_tag_state(e, device="cuda", dtype=None) -> ChaseTagState:
    """envs.chase_tag.ChaseTagState (robots with the agent axis, arena
    scene, push state, game counters, roles, flag, histories); integer and
    bool leaves keep their types."""
    dev = _device.resolve_device(device)
    nested = {"robots": robot_state(e.robots, dev, dtype),
              "scene": box_scene(e.scene, dev, dtype),
              "push": _fields(e.push, PushState, dev, dtype)}
    kw = {f: _tensor(getattr(e, f), dev, dtype) for f in ChaseTagState._fields
          if f not in nested}
    return ChaseTagState(**nested, **kw)


def chase_tag_config(cfg) -> ChaseTagConfig:
    """envs.chase_tag.ChaseTagConfig (plant parameters, arena elements and
    version, pushes, episode and randomization ranges) with host scalars."""
    return ChaseTagConfig(
        params=physics_params(cfg.params),
        arena=ArenaConfig(*(bool(x) for x in cfg.arena)),
        version=str(cfg.version),
        height_offset=tuple(float(x) for x in cfg.height_offset),
        push=PushConfig(*(tuple(float(y) for y in x) if isinstance(x, tuple) else float(x)
                          for x in cfg.push)),
        max_steps=int(cfg.max_steps),
        friction_range=tuple(float(x) for x in cfg.friction_range),
        visible_angle=float(cfg.visible_angle),
        control_spd_range=tuple(float(x) for x in cfg.control_spd_range),
    )

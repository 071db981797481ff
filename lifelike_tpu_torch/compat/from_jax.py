"""Carry the JAX package's structures over to the port.

The MPC has no learned weights; its parameters are the robot model, the
tile-layout constants, the physics parameters, the clip library and the
states and references that flow between its layers. Each function here
takes one of those structures as the JAX package holds it — any object with
the same field names whose leaves are numpy arrays (or array-likes such as
a jax.Array converted by np.asarray) — and returns the port's structure on a
given device and dtype. The policy networks' weights come over as their
Flax parameter trees (`pmc_params`, `epmc_params`, `sepmc_params`), an
optax Adam state as the port's optimizer state (`adam_state`), and the JAX
package's training checkpoints are read without JAX or optax
(`read_train_checkpoint`). Nothing here imports JAX or the JAX package.
"""
import pickle
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.envs.chase_tag import ChaseTagConfig, ChaseTagObs, ChaseTagState
from lifelike_tpu_torch.envs.playground import PlaygroundObs, PlaygroundState
from lifelike_tpu_torch.envs.primitive import PrimitiveEnvState
from lifelike_tpu_torch.envs.randomizer import PushConfig, PushState
from lifelike_tpu_torch.learning import learner, recurrent
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import epmc, pmc, sepmc
from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.motion.motion_lib import MotionClips
from lifelike_tpu_torch.parallel.scenario_sweep import ScenarioBatch
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


def scenario_batch(b, device="cuda", dtype=None) -> ScenarioBatch:
    """parallel.scenario_sweep.ScenarioBatch (stacked arenas, robots with
    the agent axis after the scenario axis, flags, roles); the roles stay
    bool."""
    dev = _device.resolve_device(device)
    return ScenarioBatch(scene=box_scene(b.scene, dev, dtype),
                         robots=robot_state(b.robots, dev, dtype),
                         flag_pos=_tensor(b.flag_pos, dev, dtype),
                         with_flag=_tensor(b.with_flag, dev))


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


def pmc_params(tree, cfg=None, device="cuda", dtype=torch.float32) -> pmc.PMCNet:
    """A PMCNet (models.pmc.PMCConfig `cfg`, default the canonical one)
    holding the weights of a Flax-layout tree (`PMCNet().init` output, a
    ModelPool snapshot), on `device` in `dtype`."""
    dev = _device.resolve_device(device)
    net = pmc.PMCNet(cfg or pmc.PMCConfig()).to(device=dev, dtype=dtype)
    return pmc.load_params(net, tree)


def epmc_params(tree, cfg=None, device="cuda", dtype=torch.float32) -> epmc.EPMCNet:
    """An EPMCNet holding the weights of a Flax-layout EPMCNet tree."""
    dev = _device.resolve_device(device)
    net = epmc.EPMCNet(cfg or epmc.EPMCConfig()).to(device=dev, dtype=dtype)
    return epmc.load_params(net, tree)


def sepmc_params(tree, cfg=None, device="cuda", dtype=torch.float32) -> sepmc.SEPMCNet:
    """A SEPMCNet holding the weights of a Flax-layout SEPMCNet tree."""
    dev = _device.resolve_device(device)
    net = sepmc.SEPMCNet(cfg or sepmc.SEPMCConfig()).to(device=dev, dtype=dtype)
    return sepmc.load_params(net, tree)


# ---------------------------------------------------------------------------
# Optimizer state and training checkpoints
# ---------------------------------------------------------------------------


class EmptyState(NamedTuple):
    """Stand-in for optax's EmptyState in a checkpoint read by
    read_train_checkpoint."""


class ScaleByAdamState(NamedTuple):
    count: np.ndarray
    mu: dict
    nu: dict


class MaskedState(NamedTuple):
    inner_state: object


class MaskedNode(NamedTuple):
    """A frozen leaf's place in a masked (multi_transform) optax state."""


class PartitionState(NamedTuple):
    inner_states: dict


def _find_adam(state):
    if hasattr(state, "_fields") and {"count", "mu", "nu"} <= set(state._fields):
        return state
    children = (state.values() if isinstance(state, dict)
                else state if isinstance(state, (tuple, list)) else ())
    for c in children:
        found = _find_adam(c)
        if found is not None:
            return found
    return None


def adam_state(opt_state, optimizer: learner.ClipAdam):
    """Load the Adam moments of an optax state — optax.chain(clip, adam)'s
    `(EmptyState, (ScaleByAdamState, EmptyState))`, or the same under a
    multi_transform's masked partition — into `optimizer` (a
    learner.ClipAdam over a net's trainable parameters): count -> step, mu
    -> exp_avg, nu -> exp_avg_sq, each parameter's moments read at its Flax
    path (kernels transposed as the weights are). Returns the optimizer."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")

    def flat(tree):
        parts = []
        for name, p in zip(optimizer.names, optimizer.params):
            path = P.flax_path(name, p)
            node = tree
            for k in path:
                node = node[k]
            a = P.to_torch_layout(path, node)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: moment {tuple(a.shape)} vs parameter "
                                 f"{tuple(p.shape)}")
            parts.append(a.reshape(-1))
        return torch.cat(parts).to(optimizer.exp_avg)

    optimizer.load_state_dict({"names": optimizer.names, "step": int(np.asarray(adam.count)),
                               "exp_avg": flat(adam.mu), "exp_avg_sq": flat(adam.nu)})
    return optimizer


# The classes a JAX TrainCheckpoint pickle may name, and what each is read
# as: numpy's array reconstruction, optax's state records (stand-ins above)
# and the JAX package's NamedTuples of env state, rollouts and replay (the
# port's classes of the same fields).
_CHECKPOINT_CLASSES = {
    **{(m, n): None for m in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
       for n in ("_reconstruct", "ndarray", "dtype", "scalar")},
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax.transforms._masking", "MaskedState"): MaskedState,
    ("optax.transforms._masking", "MaskedNode"): MaskedNode,
    ("optax.transforms._combining", "PartitionState"): PartitionState,
    ("lifelike_tpu.envs.primitive", "PrimitiveEnvState"): PrimitiveEnvState,
    ("lifelike_tpu.physics.dynamics", "RobotState"): RobotState,
    ("lifelike_tpu.learning.learner", "Rollout"): learner.Rollout,
    ("lifelike_tpu.learning.replay", "Replay"): rp.Replay,
    ("lifelike_tpu.learning.recurrent", "RecurrentRollout"): recurrent.RecurrentRollout,
    ("lifelike_tpu.envs.playground", "PlaygroundState"): PlaygroundState,
    ("lifelike_tpu.envs.playground", "PlaygroundObs"): PlaygroundObs,
    ("lifelike_tpu.envs.chase_tag", "ChaseTagState"): ChaseTagState,
    ("lifelike_tpu.envs.chase_tag", "ChaseTagObs"): ChaseTagObs,
    ("lifelike_tpu.envs.randomizer", "PushState"): PushState,
    ("lifelike_tpu.scene.boxes", "BoxScene"): BoxScene,
}


class _CheckpointUnpickler(pickle.Unpickler):
    """Resolves only the allowlisted classes; refuses every other global."""

    def find_class(self, module, name):
        if (module, name) not in _CHECKPOINT_CLASSES:
            raise pickle.UnpicklingError(
                f"blocked global {module}.{name} in a JAX TrainCheckpoint (allowlist: numpy "
                "arrays, optax states, the JAX package's state NamedTuples)")
        cls = _CHECKPOINT_CLASSES[(module, name)]
        return cls if cls is not None else super().find_class(module, name)


def read_train_checkpoint(path):
    """The JAX package's TrainCheckpoint file (`{"step": int, "trees":
    {...}}`, numpy leaves) without JAX or optax: optax's states come back as
    this module's stand-ins (EmptyState, ScaleByAdamState, ...), the JAX
    package's NamedTuples as the port's classes of the same fields, arrays
    as numpy. Any other global in the pickle is refused."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def replay_buffer(rep, device="cuda", dtype=None) -> rp.Replay:
    """learning.replay.Replay (numpy data tree, cursor, filled) -> the port's
    Replay with the buffers on `device` (floats in `dtype` when given)."""
    dev = _device.resolve_device(device)
    return rp.Replay(data=rp.tree_map(lambda x: _tensor(x, dev, dtype), rep.data),
                     cursor=int(np.asarray(rep.cursor)), filled=int(np.asarray(rep.filled)))

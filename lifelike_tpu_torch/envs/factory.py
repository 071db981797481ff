"""Env factory: the reference's construction API for the three tasks.

Port of lifelike_tpu.envs.factory (reference create_pybullet_envs.py): the
same flat `env_config` vocabulary (arena_id, control_freq, kp / kd /
max_tau, data_path, element_id, friction ranges, hard_contact, ...) builds
the corresponding batched env. `create_*_game` returns the multi-agent form
the reference actors consume; `create_*_env` the single-agent form (the
reference wrapper only tuple-izes, so both share one EnvBundle).

A bundle exposes reset / step / step_autoreset closed over the model and
config. Where the JAX bundle takes a key, these take a torch.Generator on
the env's device (the same draws' distributions, not their numbers).
`device` (default "cuda", no silent fallback) is the bundle's device: the
clips live there, and reset / step / step_autoreset raise when given a
generator or a state on another device, so a bundle built for the card
never steps on the CPU.
"""
from typing import Any, Callable, NamedTuple

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.envs import chase_tag, playground, primitive, randomizer
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_gen, playground_gen


class EnvBundle(NamedTuple):
    name: str
    model: Any
    cfg: Any
    reset: Callable  # (generator, batch=()) -> (state, obs)
    step: Callable  # (state, action, generator) -> (state, obs, reward, done, info)
    step_autoreset: Callable
    num_agents: int
    clips: Any = None
    device: Any = None  # torch.device the bundle runs on


def _device_of(x):
    """The device of a generator or tensor, or of the first tensor of a
    (nested) state; None when there is none."""
    if isinstance(x, torch.Generator) or torch.is_tensor(x):
        return x.device
    for y in x if isinstance(x, (tuple, list)) else ():
        d = _device_of(y)
        if d is not None:
            return d
    return None


def _check_on(dev, *objs):
    for x in objs:
        got = None if x is None else _device_of(x)
        if got is not None and (got.type != dev.type
                                or dev.index is not None and got.index != dev.index):
            raise ValueError(f"the env bundle runs on {dev}; got a {type(x).__name__} on {got}")


def _bind(dev, reset, step, step_autoreset):
    """reset / step / step_autoreset that first check their generator and
    state against the bundle's device."""

    def reset_(gen, batch=()):
        _check_on(dev, gen)
        return reset(gen, batch)

    def step_(s, a, gen=None):
        _check_on(dev, s, gen)
        return step(s, a, gen)

    def step_autoreset_(s, a, gen):
        _check_on(dev, s, gen)
        return step_autoreset(s, a, gen)

    return dict(reset=reset_, step=step_, step_autoreset=step_autoreset_, device=dev)


def _physics(env_config, kd_default, tau_default):
    return engine.PhysicsParams(
        kp=env_config.get("kp", 50.0),
        kd=env_config.get("kd", kd_default),
        max_tau=env_config.get("max_tau", tau_default),
        foot_friction=env_config.get("foot_lateral_friction", 0.5),
        substeps=int(
            env_config.get("sim_freq", 500.0) / env_config.get("control_freq", 50.0)
        ),
    )


def create_tracking_game(device="cuda", **env_config) -> EnvBundle:
    """PMC mocap-tracking env (reference create_pybullet_envs.py:21-64)."""
    assert env_config.get("arena_id", "LeggedRobotTracking") == "LeggedRobotTracking"
    dev = _device.resolve_device(device)
    model = build_max_model()
    clips = motion_lib.load_clips(
        env_config["data_path"],
        policy_step=1.0 / env_config.get("control_freq", 50.0),
        device=dev,
    )
    rw = env_config.get("reward_weights", None)
    cfg = primitive.PrimitiveEnvConfig(
        params=_physics(env_config, kd_default=0.5, tau_default=18.0),
        weights=(
            primitive.tracking.TrackingWeights(**rw)
            if rw
            else primitive.PrimitiveEnvConfig().weights
        ),
    )
    return EnvBundle(
        name="tracking",
        model=model,
        cfg=cfg,
        num_agents=1,
        clips=clips,
        **_bind(
            dev,
            lambda gen, batch: primitive.reset(model, clips, cfg, gen, batch=batch),
            lambda s, a, gen: primitive.step(model, clips, cfg, s, a),
            lambda s, a, gen: primitive.step_autoreset(model, clips, cfg, s, a, gen),
        ),
    )


def create_playground_game(device="cuda", **env_config) -> EnvBundle:
    """EPMC terrain-traversal env (reference create_pybullet_envs.py:67-101)."""
    dev = _device.resolve_device(device)
    rz = env_config.get("env_randomize_config", {})
    push_cfg = randomizer.PushConfig(
        **{
            k: v
            for k, v in rz.get("disturb_force_config", {}).items()
            if k in randomizer.PushConfig._fields
        }
    )
    model = build_max_model()
    cfg = playground.PlaygroundConfig(
        params=_physics(env_config, kd_default=1.0, tau_default=16.0),
        scene=playground_gen.PlaygroundConfig(
            element_id=rz.get("element_id", 0),
            **(
                {"hole_min_gap": rz["hole_config"].get("min_gap_height", 0.25),
                 "hole_max_gap": rz["hole_config"].get("max_gap_height", 0.3)}
                if rz.get("element_id", 0) == 2 and "hole_config" in rz
                else {}
            ),
        ),
        push=push_cfg,
        max_steps=env_config.get("max_steps", 1000),
        friction_range=tuple(rz.get("friction_range", (0.4, 3.0))),
        target_spd_range=tuple(rz.get("target_spd_range", (0.5, 3.0))),
        cmd_vary_freq_range=tuple(rz.get("cmd_vary_freq_range", (25, 200))),
        # hard_contact=True steps the env on the impulse PGS plant
        # (physics/impulse.py box rows, K5 on the card) — the fidelity / eval mode
        hard_contact=bool(env_config.get("hard_contact", False)),
    )
    return EnvBundle(
        name="playground",
        model=model,
        cfg=cfg,
        num_agents=1,
        **_bind(
            dev,
            lambda gen, batch: playground.reset(model, cfg, gen, batch=batch),
            lambda s, a, gen: playground.step(model, cfg, s, a, gen),
            lambda s, a, gen: playground.step_autoreset(model, cfg, s, a, gen),
        ),
    )


def create_chase_tag_game(device="cuda", **env_config) -> EnvBundle:
    """SEPMC two-robot Chase Tag (reference create_pybullet_envs.py:104-140)."""
    dev = _device.resolve_device(device)
    rz = env_config.get("env_randomize_config", {})
    el = rz.get("element_config", {})
    model = build_max_model()
    cfg = chase_tag.ChaseTagConfig(
        params=_physics(env_config, kd_default=1.0, tau_default=16.0)._replace(
            substeps=int(
                env_config.get("sim_freq", 500.0) / env_config.get("control_freq", 25.0)
            )
        ),
        arena=arena_gen.ArenaConfig(
            rand_cube=bool(el.get("rand_cube", False)),
            hurdle=bool(el.get("hurdle", False)),
            hole=bool(el.get("hole", False)),
        ),
        version=env_config.get("version", "v4"),
        height_offset=tuple(rz.get("height_offset", (0.0, 0.0))),
        max_steps=env_config.get("max_steps", 1000),
        friction_range=tuple(rz.get("friction_range", (0.4, 1.0))),
        visible_angle=env_config.get("visible_angle", 3.141592653589793),
    )
    return EnvBundle(
        name="chase_tag",
        model=model,
        cfg=cfg,
        num_agents=2,
        **_bind(
            dev,
            lambda gen, batch: chase_tag.reset(model, cfg, gen, batch=batch),
            lambda s, a, gen: chase_tag.step(model, cfg, s, a, gen),
            lambda s, a, gen: chase_tag.step_autoreset(model, cfg, s, a, gen),
        ),
    )


# single-agent aliases (reference create_*_env unwrappers :143-161): the
# bundles are identical; learners only need spaces and shapes.
create_tracking_env = create_tracking_game
create_playground_env = create_playground_game
create_chase_tag_env = create_chase_tag_game

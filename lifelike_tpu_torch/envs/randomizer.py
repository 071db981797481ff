"""Domain randomization: push forces on the base.

Port of lifelike_tpu.envs.randomizer (reference
randomizer/push_randomizer.py): after `start_time`, a polar-sampled
horizontal + vertical force acts on the base for `duration_time` every
`interval_time` seconds. The state advances once per control step; the
applied force feeds PhysicsParams.ext_force. Draws come from a
torch.Generator (distributions as in the reference, numbers not).
"""
import math
from typing import NamedTuple

import torch


class PushConfig(NamedTuple):
    start_time: float = 0.5
    interval_time: float = 1.0
    duration_time: float = 0.2
    horizontal_force: tuple = (0.0, 50.0)  # reference epmc train config
    vertical_force: tuple = (0.0, 10.0)
    push_strength_ratio: float = 1.0


class PushState(NamedTuple):
    count: torch.Tensor  # (...,) int32 steps since the last resample (negative = warm-up)
    force: torch.Tensor  # (..., 3) current sampled force


def _sample_force(gen, cfg: PushConfig, batch, dtype):
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=gen, dtype=dtype, device=gen.device)

    theta = u(0.0, 2.0 * math.pi)
    h = u(*cfg.horizontal_force)
    v = u(*cfg.vertical_force)
    return torch.stack([h * torch.cos(theta), h * torch.sin(theta), v], dim=-1)


def push_reset(gen, cfg: PushConfig, dt, batch=(), dtype=torch.float32) -> PushState:
    batch = tuple(batch)
    count = torch.full(batch, -int(cfg.start_time / dt), dtype=torch.int32, device=gen.device)
    return PushState(count=count, force=_sample_force(gen, cfg, batch, dtype))


def push_step(gen, cfg: PushConfig, state: PushState, dt):
    """Advance one control step. Returns (state', applied force (..., 3))."""
    interval = max(int(cfg.interval_time / dt), 1)
    duration = int(cfg.duration_time / dt)
    count = state.count + 1
    resample = (count > 0) & (count % interval == 0)
    new_force = _sample_force(gen, cfg, tuple(state.count.shape), state.force.dtype)
    force = torch.where(resample[..., None], new_force, state.force)
    count = torch.where(resample, torch.zeros_like(count), count)
    active = ((count > 0) & (count < duration)) | resample
    applied = torch.where(active[..., None], force * cfg.push_strength_ratio,
                          torch.zeros_like(force))
    return PushState(count=count, force=force), applied

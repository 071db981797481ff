"""MPPI (model-predictive path integral) over joint-target sequences, the
batch-leading oracle.

Port of lifelike_tpu.solver.mppi: K perturbed control sequences (K, H, 12)
are rolled through the readable engine (solver.rollout.rollout_tracking on
physics.engine), scored with the tracking cost and combined with
exponentiated-cost weights. Smooth (AR(1)) exploration noise keeps the
500 Hz PD targets from chattering. The production solver is the tile-layout
solver.mppi_tl on the CUDA rollout kernel; this one is the reference it is
held to, and runs as plain PyTorch on whatever device its tensors are on.
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.solver import rollout


class MPPIConfig(NamedTuple):
    horizon: int = 50
    population: int = 4096
    iterations: int = 1
    sigma: float = 0.08  # rad, exploration std on joint-target deltas
    beta: float = 0.7  # AR(1) smoothing of noise along the horizon
    temperature: float = 0.05
    elite_frac: float = 0.0  # optional CEM-style truncation; 0 = pure MPPI


def _smooth_noise(generator, shape, beta, dtype, device, eps=None):
    """AR(1)-filtered Gaussian noise along the horizon axis (axis -2).

    eps: optional raw standard normals of `shape` (the draw is then
    skipped), so a caller can supply the noise another implementation drew."""
    if eps is None:
        eps = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    out = torch.empty_like(eps)
    carry = torch.zeros_like(eps[..., 0, :])
    k = math.sqrt(1.0 - beta**2)
    for t in range(eps.shape[-2]):
        carry = beta * carry + k * eps[..., t, :]
        out[..., t, :] = carry
    return out


def mppi_step(model, params, clips, cfg: MPPIConfig, generator, state: RobotState, clip_idx, t0,
              u_nominal, terrain_fn=None, eps=None):
    """One MPPI improvement of u_nominal (H, 12) for a single scenario state
    (unbatched RobotState) at clip time t0. eps: optional sequence of
    `cfg.iterations` raw normal tensors (K, H, 12) used instead of drawing
    from `generator`. Returns (u_improved (H, 12), diagnostics dict)."""
    K = cfg.population
    u = u_nominal
    state_k = RobotState(*(x.expand((K,) + tuple(x.shape)) for x in state))
    ci = torch.as_tensor(clip_idx, device=u.device).expand(K)
    # a host time interpolates the clip in the controls' dtype
    tk = (t0 if torch.is_tensor(t0) else torch.tensor(t0, dtype=u.dtype)).to(u.device).expand(K)
    c_min = c_mean = None
    for it in range(cfg.iterations):
        noise = cfg.sigma * _smooth_noise(generator, (K,) + tuple(u.shape), cfg.beta, u.dtype,
                                          u.device, eps=None if eps is None else eps[it])
        u_cand = u[None] + noise  # (K, H, 12)
        total_cost, _, _ = rollout.rollout_tracking(model, params, clips, state_k, ci, tk, u_cand,
                                                    terrain_fn)
        c_min = torch.min(total_cost)
        w = torch.softmax(-(total_cost - c_min) / cfg.temperature, dim=0)
        u = torch.einsum("k,khj->hj", w, u_cand)
        c_mean = torch.sum(w * total_cost)
    return u, {"best_cost": c_min, "weighted_cost": c_mean}


def shift_warm_start(u, filler=None):
    """Receding-horizon warm start: drop the executed first control, repeat the
    last (or `filler`)."""
    tail = u[..., -1:, :] if filler is None else filler
    return torch.cat([u[..., 1:, :], tail], dim=-2)


def make_mpc_controller(model, params, clips, cfg: MPPIConfig, terrain_fn=None, device="cuda"):
    """Receding-horizon controller over the batch-leading mppi_step.

    Returns f(generator, state, clip_idx, t, u_warm (H, 12), eps=None) ->
    (u_exec (12,), u_warm', diag); u_exec is a delta on the reference's
    joints at t (rollout.rollout_tracking's control convention)."""
    dev = _device.resolve_device(device)
    if clips.frames.device.type != dev.type:
        raise ValueError(f"clips on {clips.frames.device}, controller device {dev}")

    def controller(generator, state, clip_idx, t, u_warm, eps=None):
        u_opt, diag = mppi_step(model, params, clips, cfg, generator, state, clip_idx, t, u_warm,
                                terrain_fn, eps=eps)
        return u_opt[..., 0, :], shift_warm_start(u_opt), diag

    return controller

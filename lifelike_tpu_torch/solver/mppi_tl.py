"""Tile-layout MPPI: the population is the (Bs, L) candidate batch.

Port of lifelike_tpu.solver.mppi_tl: AR(1)-smoothed Gaussian exploration,
exponentiated-cost (softmax) weighting and receding-horizon warm starts.
`mppi_update` is the algorithm for any candidate scorer; `mppi_step` scores
PMC tracking candidates with ops.rollout_cuda.rollout_tracking_fused, and
the EPMC controllers (solver.mpc_tasks) score theirs with
ops.traversal_cuda.rollout_traversal_fused — each the hand-written CUDA
kernel whenever the tensors are on the card, its plain PyTorch version on
the CPU.
"""
import math

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.solver import rollout_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig


def _smooth_noise_tl(generator, shape, beta, dtype, device, eps=None):
    """AR(1) smoothing along the leading horizon axis; shape = (H, 4, 3, Bs, L).

    eps: optional raw standard normals of `shape` (the draw is then skipped),
    so a caller can supply the exact noise another implementation drew."""
    if eps is None:
        eps = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    out = torch.empty_like(eps)
    carry = torch.zeros_like(eps[0])
    k = math.sqrt(1.0 - beta**2)
    for t in range(eps.shape[0]):
        carry = beta * carry + k * eps[t]
        out[t] = carry
    return out


def _topk(u_cand, total_cost, k):
    """The k cheapest candidates (k, H, 4, 3) and their costs (k,). The
    first k of a stable ascending sort: ties go to the lower candidate
    index, as jax.lax.top_k breaks them (torch.topk promises no order)."""
    cost_sorted, idx = torch.sort(total_cost.reshape(-1), stable=True)
    idx = idx[:k]
    flat = u_cand.reshape(u_cand.shape[:3] + (-1,))  # (H, 4, 3, K)
    return torch.movedim(flat[..., idx], -1, 0), cost_sorted[:k]


def mppi_update(cfg: MPPIConfig, generator, u_nominal, score, eps=None, return_topk=0):
    """One MPPI improvement of u_nominal (H, 4, 3) for a single scenario.

    The population is laid out as (K / 128, 128) when 128 divides it, else
    (1, K); score(u_cand (H, 4, 3, Bs, L)) -> total cost (Bs, L). eps:
    optional sequence of `cfg.iterations` raw normal tensors (H, 4, 3, Bs, L)
    used instead of drawing from `generator`. return_topk: if > 0, the
    diagnostics gain 'u_topk' (k, H, 4, 3) and 'cost_topk' (k,), the last
    iteration's k cheapest raw candidates (the seeds of solver.hybrid's iLQR
    refinement).
    Returns (u_improved (H, 4, 3), diagnostics dict).
    """
    K, H = cfg.population, cfg.horizon
    lanes = 128 if K % 128 == 0 else K
    Bs = K // lanes
    dtype, dev = u_nominal.dtype, u_nominal.device

    u = u_nominal
    c_min = c_mean = None
    for it in range(cfg.iterations):
        noise = cfg.sigma * _smooth_noise_tl(
            generator, (H, 4, 3, Bs, lanes), cfg.beta, dtype, dev,
            eps=None if eps is None else eps[it],
        )
        u_cand = (u[..., None, None] + noise).contiguous()  # (H,4,3,Bs,L)
        total_cost = score(u_cand)
        c_min = torch.min(total_cost)
        w = torch.softmax((-(total_cost - c_min) / cfg.temperature).reshape(-1), dim=0)
        w = w.reshape(total_cost.shape)
        u = torch.sum(u_cand * w, dim=(-2, -1))
        c_mean = torch.sum(w * total_cost)
    diag = {"best_cost": c_min, "weighted_cost": c_mean}
    if return_topk:
        diag["u_topk"], diag["cost_topk"] = _topk(u_cand, total_cost, return_topk)
    return u, diag


def mppi_step(c: B.TLConstants, params, cfg: MPPIConfig, generator, state: B.TLState,
              u_nominal, ref: rollout_tl.RefTraj, eps=None, return_topk=0):
    """mppi_update of a PMC tracking plan: the candidates start from `state`
    (TLState with batch (1, 1)) and are scored by
    rollout_cuda.rollout_tracking_fused against the reference `ref`."""
    def score(u_cand):
        return rollout_cuda.rollout_tracking_fused(c, params, state, u_cand, ref)

    return mppi_update(cfg, generator, u_nominal, score, eps=eps, return_topk=return_topk)


def make_mpc_controller(model, c: B.TLConstants, params, clips, cfg: MPPIConfig,
                        device="cuda"):
    """Receding-horizon controller over the tile-layout path (mppi_step).

    Returns f(generator, robot_state (unbatched RobotState), clip_idx, t,
    u_warm (H, 4, 3), eps=None) -> (u_exec (12,), u_warm', diag)."""
    dev = _device.resolve_device(device)
    for name, t in (("constants", c.joint_offset), ("clips", clips.frames)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} on {t.device}, controller device {dev}")
    policy_dt = params.dt * params.substeps

    def controller(generator, robot_state, clip_idx, t, u_warm, eps=None):
        ref = rollout_tl.precompute_reference(
            model, clips, clip_idx, t, cfg.horizon, policy_dt
        )
        tl = B.tl_from_state(B.map_state(lambda x: x[None], robot_state))
        u_opt, diag = mppi_step(c, params, cfg, generator, tl, u_warm, ref, eps=eps)
        u_exec = (ref.target_joint[0, ..., 0, 0] + u_opt[0]).reshape(12)
        u_next = torch.cat([u_opt[1:], u_opt[-1:]], dim=0)
        return u_exec, u_next, diag

    return controller

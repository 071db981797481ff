"""Tile-layout MPPI: the population is the (Bs, L) candidate batch.

Port of lifelike_tpu.solver.mppi_tl: AR(1)-smoothed Gaussian exploration,
exponentiated-cost (softmax) weighting and receding-horizon warm starts.
`mppi_update` is the algorithm for any candidate scorer; `mppi_step` scores
PMC tracking candidates with ops.rollout_cuda.rollout_tracking_fused on the
plane (with a `terrain_fn`, with the eager tile rollout
solver.rollout_tl.rollout_tracking, as the reference does), and the EPMC
controllers (solver.mpc_tasks) score theirs with
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


def finite_costs(total_cost):
    """Candidate costs with every non-finite one (a rollout that blew up) set
    to +inf: its softmax weight is then 0, where the reference's NaN would
    spread over the whole update (solver.ilqr treats its line-search costs
    alike)."""
    return torch.where(torch.isfinite(total_cost), total_cost, torch.inf)


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
    used instead of drawing from `generator`. A candidate whose cost is not
    finite gets weight 0 (finite_costs). return_topk: if > 0, the
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
        total_cost = finite_costs(score(u_cand))
        c_min = torch.min(total_cost)
        w = torch.softmax((-(total_cost - c_min) / cfg.temperature).reshape(-1), dim=0)
        w = w.reshape(total_cost.shape)
        u = torch.sum(u_cand * w, dim=(-2, -1))
        c_mean = torch.sum(torch.where(w > 0, w * total_cost, 0.0))
    diag = {"best_cost": c_min, "weighted_cost": c_mean}
    if return_topk:
        diag["u_topk"], diag["cost_topk"] = _topk(u_cand, total_cost, return_topk)
    return u, diag


def tracking_scorer(c: B.TLConstants, params, state: B.TLState, ref: rollout_tl.RefTraj,
                    terrain_fn=None):
    """score(u_cand (H, 4, 3, Bs, L)) -> total tracking cost (Bs, L) of
    candidates rolled from `state` against `ref`. On the plane
    (terrain_fn None) that is rollout_cuda.rollout_tracking_fused: K1 on
    CUDA tensors. With a terrain it is the eager tile rollout
    rollout_tl.rollout_tracking, on any device: K1 takes the plane only,
    as the reference's fused kernel does. The choice follows the argument
    alone."""
    if terrain_fn is None:
        def score(u_cand):
            return rollout_cuda.rollout_tracking_fused(c, params, state, u_cand, ref)
    else:
        def score(u_cand):
            return rollout_tl.rollout_tracking(c, params, state, u_cand, ref, terrain_fn)[0]
    return score


def mppi_step(c: B.TLConstants, params, cfg: MPPIConfig, generator, state: B.TLState,
              u_nominal, ref: rollout_tl.RefTraj, terrain_fn=None, eps=None, return_topk=0):
    """mppi_update of a PMC tracking plan: the candidates start from `state`
    (TLState with batch (1, 1)) and are scored against the reference `ref`
    by tracking_scorer (K1 on the plane, the eager tile rollout on
    `terrain_fn`)."""
    score = tracking_scorer(c, params, state, ref, terrain_fn)
    return mppi_update(cfg, generator, u_nominal, score, eps=eps, return_topk=return_topk)


def make_mpc_controller(model, c: B.TLConstants, params, clips, cfg: MPPIConfig,
                        terrain_fn=None, device="cuda"):
    """Receding-horizon controller over the tile-layout path (mppi_step;
    `terrain_fn` as there).

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
        u_opt, diag = mppi_step(c, params, cfg, generator, tl, u_warm, ref, terrain_fn,
                                eps=eps)
        u_exec = (ref.target_joint[0, ..., 0, 0] + u_opt[0]).reshape(12)
        u_next = torch.cat([u_opt[1:], u_opt[-1:]], dim=0)
        return u_exec, u_next, diag

    return controller

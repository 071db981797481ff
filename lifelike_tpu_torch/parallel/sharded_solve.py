"""MPC solves with the MPPI population sharded over ranks.

Port of lifelike_tpu.parallel.sharded_solve. Each rank rolls its shard of
the population (K / W candidates) through the tracking rollout — K1
(ops/rollout_cuda.rollout_tracking_fused) on CUDA tensors, its plain
version on CPU tensors — and the only cross-rank traffic is the
exponentiated-cost weighting: per MPPI iteration one MIN of the candidate
costs and one SUM that packs the partial softmax denominator, the partial
weighted control sum and the partial weighted cost. Every rank then holds
the same improved plan (the SUM gives every rank the same bits).

The weighted mean is a sum of per-rank partial sums, divided once by the
summed denominator: the result agrees with the single-process solve
(solver/mppi_tl.py) to rounding, not bitwise.

A rank's candidates are laid out (K / W / 128, 128) when 128 divides K / W,
else (1, K / W) (the JAX package's `lanes`). Noise is drawn from the
caller's per-rank generator (distributed.rank_generator), or injected as
`eps`: one tensor (H, 4, 3, Bs, L) per iteration, this rank's normals.
"""
import torch

from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.parallel import distributed as D
from lifelike_tpu_torch.parallel.mesh import Mesh
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.solver import ilqr, mppi_tl, rollout_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig


def local_layout(mesh: Mesh, population: int):
    """(Bs, L) of this rank's K / W candidates (ValueError unless W divides K)."""
    if population % mesh.world:
        raise ValueError(f"population {population} does not divide over {mesh.world} ranks")
    k = population // mesh.world
    lanes = 128 if k % 128 == 0 else k
    return k // lanes, lanes


def _candidates(mesh, cfg: MPPIConfig, generator, u, it, eps):
    Bs, L = local_layout(mesh, cfg.population)
    noise = cfg.sigma * mppi_tl._smooth_noise_tl(
        generator, (cfg.horizon, 4, 3, Bs, L), cfg.beta, u.dtype, u.device,
        eps=None if eps is None else eps[it])
    return (u[..., None, None] + noise).contiguous()  # (H, 4, 3, Bs, L)


def weighted_update(mesh: Mesh, cfg: MPPIConfig, u_cand, cost):
    """The global softmax-weighted plan of the candidates of every rank:
    (u (H, 4, 3), c_min, weighted cost), the same on every rank. A
    candidate whose cost is not finite gets weight 0."""
    cost = mppi_tl.finite_costs(cost)
    c_min = D.all_min(torch.min(cost).reshape(1), mesh)[0]
    w = torch.exp(-(cost - c_min) / cfg.temperature)
    part = torch.cat([w.sum().reshape(1),
                      torch.sum(u_cand * w, dim=(-2, -1)).reshape(-1),
                      torch.where(w > 0, w * cost, 0.0).sum().reshape(1)])
    tot = D.all_sum(part, mesh)
    u = (tot[1:-1] / tot[0]).view(u_cand.shape[:3])
    return u, c_min, tot[-1] / tot[0]


def sharded_mppi_step(mesh: Mesh, c: B.TLConstants, params, cfg: MPPIConfig, generator,
                      state: B.TLState, u_nominal, ref: rollout_tl.RefTraj, eps=None):
    """One MPPI improvement with the population sharded over the ranks of
    `mesh`, each rank's candidates scored by K1 against `ref`. state:
    TLState with batch (1, 1); u_nominal (H, 4, 3), the same on every
    rank. eps: optional list of cfg.iterations raw normal tensors
    (H, 4, 3, Bs, L), this rank's.
    Returns (u_improved (H, 4, 3), {best_cost, weighted_cost}), identical on
    every rank."""
    u = u_nominal
    c_min = c_w = None
    for it in range(cfg.iterations):
        u_cand = _candidates(mesh, cfg, generator, u, it, eps)
        cost = rollout_cuda.rollout_tracking_fused(c, params, state, u_cand, ref)
        u, c_min, c_w = weighted_update(mesh, cfg, u_cand, cost)
    return u, {"best_cost": c_min, "weighted_cost": c_w}


def sharded_hybrid_step(mesh: Mesh, model, c: B.TLConstants, params, clips, cfg: MPPIConfig,
                        icfg: ilqr.ILQRConfig, generator, state: B.TLState, u_nominal, clip_idx,
                        t0, ref: rollout_tl.RefTraj, eps=None):
    """Sharded sampling, then a sharded second-order refinement.

    Stage 1 is sharded_mppi_step's, each rank also keeping its shard's
    cheapest raw candidate of the last iteration. Stage 2: every rank
    refines {the global weighted plan, its local best} through the batched
    iLQR of the tracking problem (solver/ilqr.py; its Riccati sweep is K6
    on CUDA tensors), so the refinement fans out with the ranks. The
    cheapest refined plan wins: the ranks' refined costs are gathered, and
    the winner's plan is broadcast from its rank.
    Returns (u_best (H, 4, 3), {best_cost, refined_cost, seed_cost: the
    cheapest seed's cost before refinement, over every rank}), identical on
    every rank."""
    H = cfg.horizon
    u = u_nominal
    c_min = u_loc = None
    for it in range(cfg.iterations):
        u_cand = _candidates(mesh, cfg, generator, u, it, eps)
        cost = rollout_cuda.rollout_tracking_fused(c, params, state, u_cand, ref)
        u, c_min, _ = weighted_update(mesh, cfg, u_cand, cost)
        i_loc = torch.argmin(mppi_tl.finite_costs(cost).reshape(-1))  # first of ties
        u_loc = u_cand.reshape(u_cand.shape[:3] + (-1,))[..., i_loc]

    step_fn, cost_fn = ilqr.make_problem(model, params, clips, clip_idx, t0)
    robot = B.state_from_tl(B.map_state(lambda x: x[..., :1, :1], state), batch_shape=())
    x0 = ilqr.flatten_state(robot).expand(2, ilqr.STATE_DIM)
    us = torch.stack([u.reshape(H, 12), u_loc.reshape(H, 12)])
    u_ref, info = ilqr.ilqr_solve_batch(step_fn, cost_fn, x0, us, icfg)
    j = torch.argmin(info["final_cost"])
    costs = D.all_gather(info["final_cost"][j].reshape(1), mesh)[:, 0]  # (W,)
    i_star = int(torch.argmin(costs))
    u_best = D.broadcast(u_ref[j].contiguous(), mesh, src=i_star)
    seed_cost = D.all_min(info["initial_cost"].min().reshape(1), mesh)[0]
    return u_best.reshape(H, 4, 3), {"best_cost": c_min, "refined_cost": costs[i_star],
                                     "seed_cost": seed_cost}


def make_sharded_solver(mesh: Mesh, model, c: B.TLConstants, params, clips, cfg: MPPIConfig):
    """The sharded receding-horizon solve: f(generator, tl_state, u_warm,
    clip_idx, t0, eps=None) -> (u_opt, diag). The reference of the solve
    is precomputed on every rank (rollout_tl.precompute_reference)."""
    policy_dt = params.dt * params.substeps

    def solve(generator, tl_state, u_warm, clip_idx, t0, eps=None):
        ref = rollout_tl.precompute_reference(model, clips, clip_idx, t0, cfg.horizon, policy_dt)
        return sharded_mppi_step(mesh, c, params, cfg, generator, tl_state, u_warm, ref,
                                 eps=eps)

    return solve

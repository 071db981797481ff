"""Hybrid trajectory optimizer: MPPI exploration + iLQR polish.

Port of lifelike_tpu.solver.hybrid. The sampling layer (solver.mppi_tl,
its candidates scored by a CUDA rollout kernel on the card) finds the
basin; the refinement layer (solver.ilqr.ilqr_solve_batch, its backward
sweep the CUDA Riccati kernel of solver.riccati_cuda on the card) polishes
the weighted solution AND the top raw candidates as one batched
second-order solve, then the cheapest refined sequence wins.

All refined candidates are compared under the SAME smooth cost (the
problem's cost + control regularization), and iLQR keeps a scenario's old
sequence whenever no line-search step improves it, so the hybrid can only
match or beat its MPPI seed under that cost.

Each controller keeps the reference's interface with a torch.Generator in
place of the key and an optional `eps` of injected raw normals (see
mppi_tl.mppi_update), as the port's MPPI controllers do.
"""
import torch

from lifelike_tpu_torch.ops import traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.solver import ilqr, mpc_tasks, mppi_tl, rollout_tl
from lifelike_tpu_torch.solver.ilqr import ILQRConfig
from lifelike_tpu_torch.solver.mppi import MPPIConfig


def refine_with_problem(step_fn, cost_fn, robot_state, us, icfg: ILQRConfig, use_pallas=True,
                        lin_step_fn=None):
    """Batched iLQR polish of S candidate sequences from one state, under
    any (step_fn, cost_fn) problem (tracking / traversal / chase).

    robot_state: unbatched RobotState; us: (S, H, 12) joint-target deltas.
    lin_step_fn: optional coarse surrogate plant for the A/B Jacobians
    (ILQRConfig.lin_substeps); use_pallas is ignored (ilqr_solve_batch).
    Returns (u_best (H, 12), cost_best, info with initial_cost / final_cost
    (S,))."""
    S = us.shape[0]
    x0 = ilqr.flatten_state(robot_state).expand(S, ilqr.STATE_DIM)
    u_ref, info = ilqr.ilqr_solve_batch(step_fn, cost_fn, x0, us, icfg, use_pallas=use_pallas,
                                        lin_step_fn=lin_step_fn)
    best = torch.argmin(info["final_cost"])
    return u_ref[best], info["final_cost"][best], info


def _lin_params(params, icfg: ILQRConfig):
    """Coarse-linearization plant when ILQRConfig asks for one."""
    if icfg.lin_substeps and icfg.lin_substeps < params.substeps:
        return ilqr.coarse_lin_params(params, icfg.lin_substeps)
    return None


def refine_candidates(model, params, clips, clip_idx, t0, robot_state, us, icfg: ILQRConfig,
                      use_pallas=True):
    """PMC tracking refinement (see refine_with_problem)."""
    step_fn, cost_fn = ilqr.make_problem(model, params, clips, clip_idx, t0)
    lp = _lin_params(params, icfg)
    lin_step_fn = ilqr.make_problem(model, lp, clips, clip_idx, t0)[0] if lp else None
    return refine_with_problem(step_fn, cost_fn, robot_state, us, icfg, use_pallas=use_pallas,
                               lin_step_fn=lin_step_fn)


def _seeds(u_opt, diag, n_refine, horizon):
    """{MPPI weighted u} + {the n_refine cheapest raw candidates} as
    (n_refine + 1, H, 12)."""
    return torch.cat([u_opt[None], diag.pop("u_topk")], dim=0).reshape(n_refine + 1, horizon, 12)


def _finish(diag, cost_best, info, u_best, horizon):
    diag["refined_cost"] = cost_best
    diag["refined_costs"] = info["final_cost"]
    diag["seed_costs"] = info["initial_cost"]
    u_best = u_best.reshape(horizon, 4, 3)
    return u_best, torch.cat([u_best[1:], u_best[-1:]], dim=0)


def make_hybrid_controller(model, c: B.TLConstants, params, clips, cfg: MPPIConfig,
                           icfg: ILQRConfig = ILQRConfig(iterations=2), n_refine=7,
                           use_pallas=True, device="cuda"):
    """Receding-horizon hybrid PMC controller, the interface of
    mppi_tl.make_mpc_controller: f(generator, robot_state, clip_idx, t,
    u_warm (H, 4, 3), eps=None) -> (u_exec (12,), u_warm', diag). The MPPI
    stage scores through the tracking rollout kernel (mppi_tl.mppi_step);
    {MPPI weighted u} + {top n_refine raw candidates} (S = n_refine + 1
    scenarios) are refined through batched iLQR."""
    dev = mpc_tasks._check_device(device, c)
    if clips.frames.device.type != dev.type:
        raise ValueError(f"clips on {clips.frames.device}, controller device {dev}")
    policy_dt = params.dt * params.substeps

    def controller(generator, robot_state, clip_idx, t, u_warm, eps=None):
        ref = rollout_tl.precompute_reference(model, clips, clip_idx, t, cfg.horizon, policy_dt)
        tl = mpc_tasks._tl_single(robot_state)
        u_opt, diag = mppi_tl.mppi_step(c, params, cfg, generator, tl, u_warm, ref, eps=eps,
                                        return_topk=n_refine)
        us = _seeds(u_opt, diag, n_refine, cfg.horizon)
        u_best, cost_best, info = refine_candidates(model, params, clips, clip_idx, t,
                                                    robot_state, us, icfg, use_pallas)
        u_best, u_next = _finish(diag, cost_best, info, u_best, cfg.horizon)
        u_exec = (ref.target_joint[0, ..., 0, 0] + u_best[0]).reshape(12)
        return u_exec, u_next, diag

    return controller


def make_hybrid_traversal_controller(model, c: B.TLConstants, params, cfg: MPPIConfig,
                                     icfg: ILQRConfig = ILQRConfig(iterations=2), n_refine=7,
                                     reward_type="joystick", contact_k=None, use_pallas=True,
                                     device="cuda"):
    """EPMC hybrid MPC: MPPI over the pruned hurdle / hole / cube scene
    (the corridor prune and constant reference of
    mpc_tasks.make_traversal_controller, candidates through the traversal
    rollout kernel), then batched iLQR under the smooth traversal cost
    (ilqr.make_traversal_problem) on the pruned scene.

    f(generator, robot_state, scene, target_pos, target_spd, u_warm
    (H, 4, 3), eps=None) -> (target_q_exec (12,), u_warm', diag with
    refined / seed costs)."""
    mpc_tasks._check_device(device, c)
    contact_k = contact_k or mpc_tasks.CONTACT_K

    def controller(generator, robot_state, scene, target_pos, target_spd, u_warm, eps=None):
        sub = mpc_tasks._corridor_scene(params, cfg, robot_state, scene, target_pos, target_spd,
                                        contact_k)
        table = traversal_cuda.pack_boxes(sub)
        tl = mpc_tasks._tl_single(robot_state)
        q0 = robot_state.joint_pos
        ref = traversal_cuda.constant_reference(q0, cfg.horizon)

        def score(u_cand):
            return traversal_cuda.rollout_traversal_fused(
                c, params, tl, u_cand, table, ref, target_pos, target_spd, reward_type,
                gait_weight=0.0)

        u_opt, diag = mppi_tl.mppi_update(cfg, generator, u_warm, score, eps=eps,
                                          return_topk=n_refine)
        us = _seeds(u_opt, diag, n_refine, cfg.horizon)
        step_fn, cost_fn = ilqr.make_traversal_problem(model, params, sub, target_pos,
                                                       target_spd, q0)
        lp = _lin_params(params, icfg)
        lin_step_fn = ilqr.make_traversal_problem(
            model, lp, sub, target_pos, target_spd, q0)[0] if lp else None
        u_best, cost_best, info = refine_with_problem(step_fn, cost_fn, robot_state, us, icfg,
                                                      use_pallas, lin_step_fn)
        u_best, u_next = _finish(diag, cost_best, info, u_best, cfg.horizon)
        u_exec = (q0.reshape(4, 3) + u_best[0]).reshape(12)
        return u_exec, u_next, diag

    return controller


def make_hybrid_chase_solver(model, c: B.TLConstants, params, cfg: MPPIConfig,
                             icfg: ILQRConfig = ILQRConfig(iterations=2), n_refine=3,
                             n_best_response=1, use_pallas=True, device="cuda"):
    """SEPMC hybrid: each robot's best-response MPPI solve (the opponent's
    plan rolled by the plan kernel, the candidates scored by the chase
    kernel, as mpc_tasks.make_chase_solver) is polished by batched iLQR
    under the smooth chase cost (ilqr.make_chase_problem) against the
    opponent's current plan's base path, on the full arena scene.

    f(generator, robots (RobotState, agent axis 2 leading), scene, flag_pos,
    with_flag (2,) bool, u_warm (2, H, 4, 3), eps=None) ->
    (target_q_exec (2, 12), u_warm' (2, H, 4, 3), diag). with_flag[i] True
    = robot i chases. eps: one sequence of cfg.iterations raw normal tensors
    per (round, robot) update in solve order."""
    mpc_tasks._check_device(device, c)

    def solve(generator, robots, scene, flag_pos, with_flag, u_warm, eps=None):
        table = traversal_cuda.pack_boxes(scene)
        states = mpc_tasks._robot_states(robots)
        rss = [B.map_state(lambda x, i=i: x[i], robots) for i in (0, 1)]
        refs = [traversal_cuda.constant_reference(robots.joint_pos[i], cfg.horizon)
                for i in (0, 1)]
        u = [u_warm[0], u_warm[1]]
        diag = {}
        for rnd in range(n_best_response):
            for i in (0, 1):
                j = 1 - i
                opp = traversal_cuda.rollout_plan_fused(c, params, states[j], u[j], table,
                                                        refs[j])

                def score(u_cand, i=i, opp=opp):
                    return traversal_cuda.rollout_chase_fused(
                        c, params, states[i], u_cand, table, refs[i], opp, flag_pos,
                        with_flag[i], gait_weight=0.0)

                u_opt, d = mppi_tl.mppi_update(
                    cfg, generator, u[i], score, return_topk=n_refine,
                    eps=None if eps is None else eps[2 * rnd + i])
                us = _seeds(u_opt, d, n_refine, cfg.horizon)
                opp_path = opp[:, :, 0, 0]
                q0 = rss[i].joint_pos
                step_fn, cost_fn = ilqr.make_chase_problem(model, params, scene, opp_path,
                                                           flag_pos, with_flag[i], q0)
                lp = _lin_params(params, icfg)
                lin_step_fn = ilqr.make_chase_problem(
                    model, lp, scene, opp_path, flag_pos, with_flag[i], q0)[0] if lp else None
                u_best, cost_best, info = refine_with_problem(step_fn, cost_fn, rss[i], us, icfg,
                                                              use_pallas, lin_step_fn)
                u[i] = u_best.reshape(cfg.horizon, 4, 3)
                diag.update({f"{k}_{i}": v for k, v in d.items()})
                diag[f"refined_cost_{i}"] = cost_best
                diag[f"seed_cost_{i}"] = info["initial_cost"][0]
        q0 = robots.joint_pos.reshape(2, 4, 3)
        u_exec = torch.stack([(q0[i] + u[i][0]).reshape(12) for i in (0, 1)])
        return u_exec, mpc_tasks._shift(u), diag

    return solve

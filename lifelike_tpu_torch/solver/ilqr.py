"""iLQR refinement: gradient-based polish of MPPI solutions.

Port of lifelike_tpu.solver.ilqr, the second stage of the hybrid trajectory
optimizer (solver.hybrid): after the sampling layer finds a good basin,
iterative LQR refines the control sequence with dynamics linearizations
(torch.func.jacfwd through the port's physics.engine.control_step) and a
Riccati backward sweep (solver.riccati_cuda: the hand-written CUDA kernel
on the card, its plain PyTorch version on the CPU).

State is flattened to 37 dims [pos 3, quat 4, lin vel 3, ang vel 3, q 12,
qd 12]; the quaternion stays on its chart (normalized inside the step), and
Levenberg-Marquardt regularization absorbs the unit-norm null direction.
The forward pass always rolls the TRUE nonlinear dynamics with a line
search, so the result is feasible by construction.

A problem is a pair step_fn(x, u, t) -> x', cost_fn(x, u, t) -> cost on
flattened states. Unlike the reference's per-point functions, both take
any leading batch shape (x (..., 37), u (..., 12), t a scalar or (...)),
so the rollouts call them on a whole batch of sequences at once, and
`linearize` vmaps them per point as the reference does.
"""
import math
from typing import NamedTuple

import torch
from torch.func import grad, jacfwd, vmap

from lifelike_tpu_torch.costs import chase as chase_costs
from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.costs import traversal as trav
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import dynamics, engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.solver import riccati_cuda
from lifelike_tpu_torch.solver.rollout import ref_foot_positions

STATE_DIM = 37
ACT_DIM = 12


class ILQRConfig(NamedTuple):
    iterations: int = 3
    reg: float = 1e-3  # initial Levenberg-Marquardt regularization
    u_reg: float = 1e-3  # control effort weight
    line_search: tuple = (1.0, 0.5, 0.25, 0.1)
    # adaptive LM schedule (batched path): per-scenario reg shrinks on an
    # accepted step and grows on rejection
    reg_down: float = 0.5
    reg_up: float = 10.0
    reg_min: float = 1e-4
    reg_max: float = 1e2
    # Linearization plant coarseness: 0 (default) = exact plant. Nonzero
    # builds the A/B Jacobians through a surrogate control step integrating
    # the same 20 ms in `lin_substeps` coarse substeps (the reference found
    # it useless for this plant's stiff contact; the true-dynamics line
    # search keeps any value safe).
    lin_substeps: int = 0


def flatten_state(s: RobotState):
    return torch.cat([s.base_pos, s.base_orn, s.base_lin_vel, s.base_ang_vel,
                      s.joint_pos, s.joint_vel], dim=-1)


def unflatten_state(x):
    return RobotState(
        base_pos=x[..., 0:3],
        base_orn=quat.normalize(x[..., 3:7]),
        base_lin_vel=x[..., 7:10],
        base_ang_vel=x[..., 10:13],
        joint_pos=x[..., 13:25],
        joint_vel=x[..., 25:37],
    )


def coarse_lin_params(params: engine.PhysicsParams, lin_substeps: int):
    """Surrogate plant for Jacobians: the same policy-step duration
    integrated in `lin_substeps` coarse substeps (ILQRConfig.lin_substeps).
    Never used to roll dynamics forward."""
    total = params.dt * params.substeps
    return params._replace(dt=total / lin_substeps, substeps=lin_substeps)


def _soft_fall(s: RobotState):
    """C^2 surrogate of the rollouts' hard fall penalty: sigmoid on the body
    up-vector crossing cos(60 deg) (reference legged_robot.py:158-179)."""
    up_z = quat.to_matrix(s.base_orn)[..., 2, 2]
    return torch.sigmoid((math.cos(math.pi / 3.0) - up_z) * 20.0)


def _u_cost(u, u_reg):
    return u_reg * torch.sum(u**2, dim=-1)


def make_problem(model, params: engine.PhysicsParams, clips, clip_idx, t0,
                 weights=tracking.TrackingWeights(), u_reg=1e-3):
    """PMC tracking problem: (step_fn(x, u, t) -> x', cost_fn(x, u, t) ->
    cost) on flattened states; u are deltas on the reference joint targets
    of the clip at t0 + t * policy_dt."""
    policy_dt = params.dt * params.substeps

    def step_fn(x, u, t):
        s = unflatten_state(x)
        ref = motion_lib.sample_frame(clips, clip_idx, t0 + t * policy_dt)
        s2 = engine.control_step(model, params, s, ref.joint_pos + u)
        return flatten_state(s2)

    def cost_fn(x, u, t):
        s = unflatten_state(x)
        ref = motion_lib.sample_frame(clips, clip_idx, t0 + (t + 1.0) * policy_dt)
        kin = dynamics.forward_kinematics(model, s)
        c = tracking.tracking_cost(s, kin.p_foot, ref, ref_foot_positions(model, ref), weights)
        # smooth surrogate of the MPPI rollout's hard fall penalty: keeps the
        # refinement from polishing toward tipped poses the sampling layer
        # would have rejected
        return c + _u_cost(u, u_reg) + 5.0 * _soft_fall(s)

    return step_fn, cost_fn


def make_traversal_problem(model, params: engine.PhysicsParams, scene, target_pos, target_spd,
                           q0, weights=None, u_reg=1e-3):
    """EPMC smooth problem: terrain traversal through box-scene contact
    (reference playground_env.py:479-539 joystick objective).

    scene: pruned scene.boxes.BoxScene (fixed for the solve); u are deltas
    on the initial joint pose q0, as in rollout_tasks.rollout_traversal, so
    MPPI candidates seed directly."""
    weights = weights or trav.TraversalWeights()

    def step_fn(x, u, t):
        s = unflatten_state(x)
        return flatten_state(engine.control_step(model, params, s, q0 + u, scene=scene))

    def cost_fn(x, u, t):
        s = unflatten_state(x)
        c = trav.joystick_cost(s, target_pos, target_spd, weights)
        c = c + weights.clearance * trav.clearance_cost(scene, s)
        return c + _u_cost(u, u_reg) + 5.0 * _soft_fall(s)

    return step_fn, cost_fn


def make_chase_problem(model, params: engine.PhysicsParams, scene, opp_traj, flag_pos,
                       is_chaser, q0, weights=None, u_reg=1e-3):
    """SEPMC smooth problem: one robot vs a fixed opponent plan (reference
    chase_tag_game_env.py:640-697 objectives). opp_traj: (H, 3) opponent
    base path; is_chaser: bool or bool tensor, the masked role switch of
    rollout_chase."""
    weights = weights or chase_costs.ChaseWeights()

    def step_fn(x, u, t):
        s = unflatten_state(x)
        return flatten_state(engine.control_step(model, params, s, q0 + u, scene=scene))

    def cost_fn(x, u, t):
        s = unflatten_state(x)
        ti = torch.as_tensor(t, device=x.device).to(torch.int64).clamp(0, opp_traj.shape[0] - 1)
        opp_t = opp_traj.index_select(0, ti.reshape(-1)).reshape(ti.shape + (3,))  # vmap-safe
        role = torch.as_tensor(is_chaser, device=x.device).to(x.dtype)
        c_ch = chase_costs.chaser_cost(s, opp_t, weights)
        c_es = chase_costs.escapee_cost(s, opp_t, flag_pos, 1.0, weights)
        c = role * c_ch + (1.0 - role) * c_es
        c = c + trav.posture_cost(s, weights)
        c = c + 0.5 * trav.clearance_cost(scene, s)
        return c + _u_cost(u, u_reg) + 5.0 * _soft_fall(s)

    return step_fn, cost_fn


def _rollout(step_fn, cost_fn, x0, us):
    """Roll the sequences us (..., H, m) from x0 (..., n). Returns (pre-step
    states (..., H, n), final state, total cost (...))."""
    x, xs, total = x0, [], 0.0
    ts = torch.arange(us.shape[-2], dtype=x0.dtype, device=x0.device)
    for i, t in enumerate(ts):
        xs.append(x)
        total = total + cost_fn(x, us[..., i, :], t)
        x = step_fn(x, us[..., i, :], t)
    return torch.stack(xs, dim=-2), x, total


def _feedback_rollout(step_fn, cost_fn, x0, us, xs, ks, Ks, alphas):
    """The line search: for every alpha, the feedback rollout
    u_t = us_t + alpha k_t + K_t (x_t - xs_t) from x0, all alphas and
    scenarios in one batch (n_alpha, S). It records the controls, the
    pre-step states and the true cost on the way, so one pass serves
    candidate generation, evaluation and the next linearization's states.
    x0 (S, n), us (S, H, m), xs (S, H, n), ks (S, H, m), Ks (S, H, m, n),
    alphas (n_alpha,). Returns (us (n_alpha, S, H, m), xs (n_alpha, S, H,
    n), costs (n_alpha, S))."""
    a = alphas[:, None, None]
    x = x0.expand((alphas.shape[0],) + tuple(x0.shape))
    u_out, x_out, total = [], [], 0.0
    ts = torch.arange(us.shape[-2], dtype=x0.dtype, device=x0.device)
    for i, t in enumerate(ts):
        u = us[:, i] + a * ks[:, i] + torch.einsum("smn,asn->asm", Ks[:, i], x - xs[:, i])
        u_out.append(u)
        x_out.append(x)
        total = total + cost_fn(x, u, t)
        x = step_fn(x, u, t)
    return torch.stack(u_out, dim=-2), torch.stack(x_out, dim=-2), total


def linearize(step_fn, cost_fn, xs, us, lin_step_fn=None):
    """Jacobians and cost quadratics along batched trajectories.

    xs: (S, H, n) pre-step states, us: (S, H, m). Returns (A (S,H,n,n),
    B (S,H,n,m), cx, cu, Cxx, Cuu): forward-mode Jacobians of the step and
    the gradient and Hessian blocks of the stage cost (forward over
    reverse), vmapped over every (scenario, step) point.

    lin_step_fn: optional cheaper surrogate plant for the A/B Jacobians
    (ILQRConfig.lin_substeps); the cost quadratics always come from the
    exact cost_fn."""
    S, H, n = xs.shape
    m = us.shape[-1]
    ts = torch.arange(H, dtype=xs.dtype, device=xs.device).repeat(S)
    jac_step = lin_step_fn or step_fn

    def at_point(x, u, t):
        # the problem on a batch of one: under torch.func.jvp a 0-d float32
        # tensor plus a Python float gets a float64 tangent, so no
        # intermediate may be 0-d (the engine's per-point scalars are (1,))
        def step1(x_, u_):
            return jac_step(x_[None], u_[None], t)[0]

        def cost1(x_, u_):
            return cost_fn(x_[None], u_[None], t)[0]

        A, Bm = jacfwd(step1, argnums=(0, 1))(x, u)

        def grads(x_, u_):
            g = grad(cost1, argnums=(0, 1))(x_, u_)
            return g, g

        hess, (cx, cu) = jacfwd(grads, argnums=(0, 1), has_aux=True)(x, u)
        return A, Bm, cx, cu, hess[0][0], hess[1][1]

    out = vmap(at_point)(xs.reshape(S * H, n), us.reshape(S * H, m), ts)
    return tuple(o.reshape((S, H) + tuple(o.shape[1:])) for o in out)


def ilqr_solve(step_fn, cost_fn, x0, u_init, cfg: ILQRConfig = ILQRConfig()):
    """Refine one sequence u_init (H, 12) from x0 (37,). Returns (u_opt,
    info dict with initial_cost, final_cost, cost_history).

    Each iteration: linearize along the trajectory, Riccati backward sweep
    (reg inside Quu = Cuu + B'VB + reg I) for the feedforward k and feedback
    K gains, then a line-searched nonlinear forward rollout; the candidate
    is kept only when the true cost improves."""
    u_init = u_init.to(x0.dtype)
    dt, dev = x0.dtype, x0.device
    alphas = torch.tensor(cfg.line_search, dtype=dt, device=dev)
    xs, _, cost0 = _rollout(step_fn, cost_fn, x0[None], u_init[None])
    us, best_cost, reg = u_init[None], cost0, cfg.reg
    hist = []
    for _ in range(cfg.iterations):
        A, Bm, cx, cu, Cxx, Cuu = linearize(step_fn, cost_fn, xs, us)
        ks, Ks = riccati_cuda.riccati_sweep(A, Bm, cx, cu, Cxx, Cuu, reg=reg)
        us_a, xs_a, costs = _feedback_rollout(step_fn, cost_fn, x0[None], us, xs, ks, Ks, alphas)
        costs = torch.where(torch.isfinite(costs), costs, math.inf)[:, 0]  # NaN-safe
        best = torch.argmin(costs)
        improved = costs[best] < best_cost
        us = torch.where(improved, us_a[best], us)
        xs = torch.where(improved, xs_a[best], xs)
        best_cost = torch.where(improved, costs[best], best_cost)
        # adaptive Levenberg-Marquardt; reg is a host float, the sweep's
        # scalar argument (one read of `improved` per iteration)
        reg = min(max(reg * (cfg.reg_down if bool(improved) else cfg.reg_up), cfg.reg_min),
                  cfg.reg_max)
        hist.append(best_cost[0])
    return us[0], {"initial_cost": cost0[0], "final_cost": best_cost[0],
                   "cost_history": torch.stack(hist) if hist else cost0[:0]}


def ilqr_solve_batch(step_fn, cost_fn, x0, u_init, cfg: ILQRConfig = ILQRConfig(),
                     use_pallas=True, lin_step_fn=None):
    """Refine S control sequences together. x0: (S, n), u_init: (S, H, m).

    Per iteration: batched linearization, one Riccati sweep over all
    scenarios, then a line-searched nonlinear forward rollout of every
    (alpha, scenario) pair in one batch — each scenario keeps its own best
    alpha, and keeps its old sequence if nothing improves. The per-scenario
    Levenberg-Marquardt damping is folded into Cuu.

    use_pallas: kept so that configurations carried over from the
    reference still work, and ignored: riccati_cuda.riccati_sweep runs the
    CUDA kernel on a CUDA tensor and the plain sweep on a CPU tensor.
    Returns (u_opt (S, H, m), {initial_cost, final_cost} each (S,))."""
    del use_pallas
    u_init = u_init.to(x0.dtype)
    S, H, m = u_init.shape
    dt, dev = x0.dtype, x0.device
    alphas = torch.tensor(cfg.line_search, dtype=dt, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev)
    xs, _, cost0 = _rollout(step_fn, cost_fn, x0, u_init)
    us, best_cost = u_init, cost0
    reg_s = torch.full((S,), cfg.reg, dtype=dt, device=dev)
    for _ in range(cfg.iterations):
        A, Bm, cx, cu, Cxx, Cuu = linearize(step_fn, cost_fn, xs, us, lin_step_fn)
        # reg only ever enters the recursion through Quu = Cuu + B'VB + reg I
        Cuu = Cuu + reg_s[:, None, None, None] * eye
        ks, Ks = riccati_cuda.riccati_sweep(A, Bm, cx, cu, Cxx, Cuu, reg=0.0)
        us_a, xs_a, costs = _feedback_rollout(step_fn, cost_fn, x0, us, xs, ks, Ks, alphas)
        costs = torch.where(torch.isfinite(costs), costs, math.inf)  # (n_alpha, S)
        best = torch.argmin(costs, dim=0)  # (S,)
        pick = torch.arange(S, device=dev)
        cost_b = costs[best, pick]
        improved = cost_b < best_cost
        us = torch.where(improved[:, None, None], us_a[best, pick], us)
        xs = torch.where(improved[:, None, None], xs_a[best, pick], xs)
        best_cost = torch.where(improved, cost_b, best_cost)
        reg_s = torch.clamp(torch.where(improved, reg_s * cfg.reg_down, reg_s * cfg.reg_up),
                            cfg.reg_min, cfg.reg_max)
    return us, {"initial_cost": cost0, "final_cost": best_cost}

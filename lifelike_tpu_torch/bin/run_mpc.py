"""MPC evaluation CLI: closed-loop PMC tracking, EPMC traversal and SEPMC
Chase-Tag solves.

Port of lifelike_tpu.bin.run_mpc --task=pmc / epmc / sepmc. A
receding-horizon MPPI controller solves the task online and the CLI reports
per-episode statistics:

  * pmc: track a mocap clip on the envs.primitive plant (solver.mppi_tl;
    candidates scored by the CUDA tracking rollout kernel on the card);
  * epmc: traverse a randomized playground course (--element_id 0
    joystick, 1 hurdles, 2 holes, 3 cubes) on the envs.playground plant
    with box contact (solver.mpc_tasks; candidates scored by the CUDA
    traversal rollout kernel on the card);
  * sepmc: play Chase Tag in the V4 arena, both robots solved by
    alternating best response (--best_response rounds per control step) on
    the envs.chase_tag plant (solver.mpc_tasks.make_chase_solver; on the
    card the opponent's plan is rolled by the CUDA plan kernel and each
    robot's candidates are scored by the CUDA chase kernel); reports per
    game the rewards, the roles, the length and the catch / fall.

--hybrid polishes every task's MPPI solve with batched iLQR
(solver.hybrid: the MPPI weighted plan and its --n_refine cheapest raw
candidates, --ilqr_iterations iterations, the Riccati backward sweep on the
CUDA kernel on the card); each step then also reports the refined cost and
the seeds' costs.

  python -m lifelike_tpu_torch.bin.run_mpc --task=pmc --steps=50
  python -m lifelike_tpu_torch.bin.run_mpc --clip=clip.txt --population=4096 --horizon=50
  python -m lifelike_tpu_torch.bin.run_mpc --task=epmc --element_id=1
  python -m lifelike_tpu_torch.bin.run_mpc --task=sepmc --population=2048 --horizon=50
  python -m lifelike_tpu_torch.bin.run_mpc --hybrid --population=1024 --horizon=50 --steps=3
  python -m lifelike_tpu_torch.bin.run_mpc --device=cpu --population=128 --horizon=3

--clip takes a reference-format JSON clip file (or directory); the default
"synthetic" uses motion_lib.make_synthetic_clip, which needs no data.
"""
import argparse
import sys
import time

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.costs import tracking
from lifelike_tpu_torch.envs import chase_tag, playground, primitive
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import playground_gen
from lifelike_tpu_torch.solver import hybrid, ilqr, mpc_tasks, mppi, mppi_tl


def arg_parser(description=__doc__.split("\n")[0]):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--task", default="pmc", choices=["pmc", "epmc", "sepmc"],
                   help="which level's MPC problem to solve")
    p.add_argument("--clip", default="synthetic",
                   help="mocap clip file or directory, or 'synthetic' (pmc)")
    p.add_argument("--element_id", type=int, default=1,
                   help="playground element (epmc): 0 joystick, 1 hurdles, 2 holes, 3 cubes")
    p.add_argument("--steps", type=int, default=50, help="control steps to run")
    p.add_argument("--population", type=int, default=512, help="MPPI population")
    p.add_argument("--horizon", type=int, default=10, help="MPC horizon (control steps)")
    p.add_argument("--iterations", type=int, default=1, help="MPPI iterations per solve")
    p.add_argument("--best_response", type=int, default=1,
                   help="alternating best-response rounds per control step (sepmc)")
    p.add_argument("--hybrid", action="store_true",
                   help="MPPI->iLQR hybrid solver (all three tasks)")
    p.add_argument("--ilqr_iterations", type=int, default=2,
                   help="iLQR polish iterations (--hybrid)")
    p.add_argument("--n_refine", type=int, default=7,
                   help="top raw candidates refined (--hybrid)")
    p.add_argument("--seed", type=int, default=0, help="generator seed")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def parse_args(argv=None):
    return arg_parser().parse_args(argv)


def _report(name, ep_rewards, ep_lens, t_solve):
    """Per-episode summary line (lifelike_tpu run_mpc._report)."""
    return (
        "%s MPC eval: %d episodes | mean reward/step %.4f | mean ep len %.1f"
        " | solve p50 %.1f ms" % (
            name, len(ep_rewards),
            float(np.sum(ep_rewards) / max(np.sum(ep_lens), 1)),
            float(np.mean(ep_lens)) if ep_lens else 0.0,
            1e3 * float(np.percentile(t_solve[1:], 50)) if len(t_solve) > 1 else -1,
        )
    )


def _clips(path, horizon, device):
    if path == "synthetic":
        # long enough that the horizon never runs past the clip end in a run
        frames = motion_lib.make_synthetic_clip(int(120 * (horizon / 50.0 + 30)))
        return motion_lib.pack_clips([frames], frame_step=1.0 / 120.0, device=device)
    return motion_lib.load_clips(path, device=device)


def _icfg(args):
    return ilqr.ILQRConfig(iterations=args.ilqr_iterations)


def _refined(diags, diag):
    """Append a hybrid solve's refined cost and its seeds' costs: PMC / EPMC
    the winner and all n_refine + 1 seeds, SEPMC per robot the refined cost
    and its MPPI plan's seed cost. A plain MPPI solve has neither."""
    if "refined_cost" in diag:
        diags["refined_cost"].append(float(diag["refined_cost"]))
        diags["seed_costs"].append(diag["seed_costs"].double().cpu().tolist())
    elif "refined_cost_0" in diag:
        diags["refined_cost"].append([float(diag[f"refined_cost_{i}"]) for i in (0, 1)])
        diags["seed_costs"].append([float(diag[f"seed_cost_{i}"]) for i in (0, 1)])


def setup_pmc(args):
    """(device, model, clips, env config, controller, generator, first env
    state, zero warm start) of the PMC closed loop, float32."""
    dev = _device.resolve_device(args.device)
    dtype = torch.float32
    model = build_max_model()
    clips = _clips(args.clip, args.horizon, dev)
    cfg = primitive.PrimitiveEnvConfig()
    mcfg = mppi.MPPIConfig(horizon=args.horizon, population=args.population,
                           iterations=args.iterations)
    c = B.tl_constants(model, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    env, _ = primitive.reset(model, clips, cfg, gen)
    if args.hybrid:
        ctrl = hybrid.make_hybrid_controller(model, c, cfg.params, clips, mcfg, _icfg(args),
                                             n_refine=args.n_refine, device=dev)
    else:
        ctrl = mppi_tl.make_mpc_controller(model, c, cfg.params, clips, mcfg, device=dev)
    u = torch.zeros((mcfg.horizon, 4, 3), dtype=dtype, device=dev)
    return dev, model, clips, cfg, ctrl, gen, env, u


def _timed(dev, fn):
    """(fn(), seconds): CUDA-event time on the card, host clock on the CPU."""
    if dev.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        ev1.synchronize()
        return out, ev0.elapsed_time(ev1) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_pmc(args, log=print):
    """Closed loop; returns a dict of per-step rewards, episode ends and
    solve times (seconds; CUDA-event times on the card)."""
    dev, model, clips, cfg, ctrl, gen, env, u = setup_pmc(args)
    rewards, ep_rewards, ep_lens, t_solve = [], [], [], []
    step_rewards, episode_ends = [], []
    diags = {"refined_cost": [], "seed_costs": []}
    for i in range(args.steps):
        (tgt, u, diag), dt = _timed(dev, lambda: ctrl(gen, env.robot, env.clip_idx, env.t, u))
        t_solve.append(dt)
        _refined(diags, diag)
        env, _, r, done, info = primitive.step(model, clips, cfg, env,
                                               tgt - env.robot.joint_pos)
        rewards.append(float(r))
        step_rewards.append(float(r))
        if bool(done):
            ep_rewards.append(sum(rewards))
            ep_lens.append(len(rewards))
            episode_ends.append(i)
            log("episode end at step %d: reward_sum=%.2f len=%d (%s)" % (
                i, ep_rewards[-1], ep_lens[-1],
                {k: bool(v) for k, v in info.items() if v.dtype == torch.bool}))
            rewards = []
            env, _ = primitive.reset(model, clips, cfg, gen)
            u = torch.zeros_like(u)
    if rewards:
        ep_rewards.append(sum(rewards))
        ep_lens.append(len(rewards))
    log(_report("PMC", ep_rewards, ep_lens, t_solve))
    return {"step_rewards": step_rewards, "episode_ends": episode_ends,
            "ep_rewards": ep_rewards, "ep_lens": ep_lens, "t_solve": t_solve,
            "device": str(dev), **diags}


def setup_epmc(args, env_cfg=None):
    """(device, model, env config, controller, generator, first env state,
    zero warm start) of the EPMC closed loop, float32: the playground
    element --element_id, MPPI at sigma 0.15, the plant `env_cfg` (a
    playground.PlaygroundConfig; default: the default plant on that
    element), e.g. with hard_contact=True the impulse (PGS) plant."""
    dev = _device.resolve_device(args.device)
    dtype = torch.float32
    model = build_max_model()
    cfg = env_cfg if env_cfg is not None else playground.PlaygroundConfig(
        scene=playground_gen.PlaygroundConfig(element_id=args.element_id))
    mcfg = mppi.MPPIConfig(horizon=args.horizon, population=args.population,
                           iterations=args.iterations, sigma=0.15)
    c = B.tl_constants(model, dtype=dtype, device=dev)
    if args.hybrid:
        ctrl = hybrid.make_hybrid_traversal_controller(
            model, c, cfg.params, mcfg, _icfg(args), n_refine=args.n_refine,
            reward_type=cfg.reward_type, device=dev)
    else:
        ctrl = mpc_tasks.make_traversal_controller(model, c, cfg.params, mcfg,
                                                   reward_type=cfg.reward_type,
                                                   max_steps=cfg.max_steps, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    s, _ = playground.reset(model, cfg, gen, dtype=dtype)
    u = torch.zeros((mcfg.horizon, 4, 3), dtype=dtype, device=dev)
    return dev, model, cfg, ctrl, gen, s, u


def run_epmc(args, log=print, env_cfg=None):
    """Closed loop on the playground (plant `env_cfg`, see setup_epmc);
    returns a dict of per-step rewards, fall / reached flags, episode ends,
    solve times and plant step times (seconds; CUDA-event times on the
    card)."""
    dev, model, cfg, ctrl, gen, s, u = setup_epmc(args, env_cfg)
    rewards, ep_rewards, ep_lens, t_solve, t_plant = [], [], [], [], []
    step_rewards, falls, reached, episode_ends = [], [], [], []
    diags = {"refined_cost": [], "seed_costs": []}
    for i in range(args.steps):
        (tgt, u, diag), dt = _timed(
            dev, lambda: ctrl(gen, s.robot, s.scene, s.target_pos, s.target_spd, u))
        t_solve.append(dt)
        _refined(diags, diag)
        (s, _, r, done, info), dt = _timed(
            dev, lambda: playground.step(model, cfg, s, tgt - s.robot.joint_pos, gen))
        t_plant.append(dt)
        rewards.append(float(r))
        step_rewards.append(float(r))
        falls.append(bool(info["fall"]))
        reached.append(bool(info["reached"]))
        if bool(done):
            ep_rewards.append(sum(rewards))
            ep_lens.append(len(rewards))
            episode_ends.append(i)
            log("episode end at step %d: reward_sum=%.4f len=%d fall=%s reached=%s "
                "ave_spd=%.2f" % (i, ep_rewards[-1], ep_lens[-1], falls[-1], reached[-1],
                                  float(info["ave_spd"])))
            rewards = []
            s, _ = playground.reset(model, cfg, gen, dtype=s.robot.base_pos.dtype)
            u = torch.zeros_like(u)
    if rewards:
        ep_rewards.append(sum(rewards))
        ep_lens.append(len(rewards))
    log(_report("EPMC", ep_rewards, ep_lens, t_solve))
    return {"step_rewards": step_rewards, "falls": falls, "reached": reached,
            "episode_ends": episode_ends, "ep_rewards": ep_rewards, "ep_lens": ep_lens,
            "t_solve": t_solve, "t_plant": t_plant, "device": str(dev), **diags}


def setup_sepmc(args):
    """(device, model, env config, solver, generator, first game state,
    zero warm starts (2, H, 4, 3)) of the SEPMC closed loop, float32: the
    default V4 arena and ChaseTagConfig plant (kd 1, max_tau 16, substeps
    20), MPPI at sigma 0.15, --best_response rounds per solve."""
    dev = _device.resolve_device(args.device)
    dtype = torch.float32
    model = build_max_model()
    cfg = chase_tag.ChaseTagConfig()
    mcfg = mppi.MPPIConfig(horizon=args.horizon, population=args.population,
                           iterations=args.iterations, sigma=0.15)
    c = B.tl_constants(model, dtype=dtype, device=dev)
    if args.hybrid:
        solver = hybrid.make_hybrid_chase_solver(
            model, c, cfg.params, mcfg, _icfg(args), n_refine=args.n_refine,
            n_best_response=args.best_response, device=dev)
    else:
        solver = mpc_tasks.make_chase_solver(model, c, cfg.params, mcfg,
                                             n_best_response=args.best_response, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    s, _ = chase_tag.reset(model, cfg, gen, dtype=dtype)
    u = torch.zeros((2, mcfg.horizon, 4, 3), dtype=dtype, device=dev)
    return dev, model, cfg, solver, gen, s, u


def run_sepmc(args, log=print):
    """Chase Tag closed loop; returns a dict of per-step rewards (both
    robots), the games that ended (rewards, roles at the end, length, catch,
    fall of robot 0, timeout), episode ends and solve times (seconds;
    CUDA-event times on the card)."""
    dev, model, cfg, solver, gen, s, u = setup_sepmc(args)
    step_rewards, episode_ends, games, t_solve = [], [], [], []
    rew_sum = np.zeros(2)
    start = 0
    diags = {"refined_cost": [], "seed_costs": []}
    for i in range(args.steps):
        (tgt, u, diag), dt = _timed(
            dev, lambda: solver(gen, s.robots, s.scene, s.flag_pos, s.with_flag, u))
        t_solve.append(dt)
        _refined(diags, diag)
        s, _, r, done, info = chase_tag.step(model, cfg, s, tgt - s.robots.joint_pos, gen)
        r = r.double().cpu().numpy()
        rew_sum += r
        step_rewards.append(r.tolist())
        if bool(done):
            robot0 = RobotState(*(x[0] for x in s.robots))
            games.append(dict(
                rewards=rew_sum.tolist(), with_flag=s.with_flag.cpu().tolist(), len=i + 1 - start,
                caught=bool(info["caught"]), fall=bool(tracking.fall_terminated(robot0)),
                timeout=bool(s.counter >= cfg.max_steps)))
            episode_ends.append(i)
            log("game end at step %d: %s" % (i, games[-1]))
            rew_sum, start = np.zeros(2), i + 1
            s, _ = chase_tag.reset(model, cfg, gen, dtype=s.robots.base_pos.dtype)
            u = torch.zeros_like(u)
    dist = float(torch.linalg.vector_norm(s.robots.base_pos[0, :2] - s.robots.base_pos[1, :2]))
    log("SEPMC MPC eval: %d games | final dist %.2f m | solve p50 %.1f ms" % (
        len(games), dist,
        1e3 * float(np.percentile(t_solve[1:], 50)) if len(t_solve) > 1 else -1))
    return {"step_rewards": step_rewards, "games": games, "episode_ends": episode_ends,
            "final_dist": dist, "t_solve": t_solve, "device": str(dev), **diags}


def main(argv=None):
    args = parse_args(argv)
    return {"pmc": run_pmc, "epmc": run_epmc, "sepmc": run_sepmc}[args.task](args)


if __name__ == "__main__":
    main(sys.argv[1:])

"""EPMC solve latency over a grid of contact_k and population on the card.

Port of tools/epmc_sweep.py (which runs bench.py's bench_epmc(fused=True)).
The solve is bench_epmc's, built here: the robot standing on a
playground_gen hurdle course (element 1, generator seed 3) pruned to the
contact_k boxes nearest it (scene.boxes.nearest_boxes), one MPPI iteration
(sigma 0.15) of the joystick traversal cost toward the course's target at
speed 1.5 over raw joint deltas (a constant reference at the standing
joints, gait_weight 0), plant kd 1, max_tau 16, mass_freeze = substeps;
the candidates on K2 (ops.traversal_cuda.rollout_traversal_fused). For
each contact_k it times the solve at each --pops population at --horizon,
and at make_eval's widths (--eval_pop 1,024, --eval_horizon 12; 0 skips
it), as the slope over chained solves (utils.profiling.chained_latency:
CUDA events on the card, the host clock on the CPU, where K2's plain
version runs), and K2 alone on the solve's candidates (median of --reps
calls after a warm-up). One JSON line per configuration, in the
reference's keys (metric, contact_k, value, unit) plus the population,
horizon, K2's ms, the device and the card's name and power limit.

    python -m lifelike_tpu_torch.tools.epmc_sweep [--ks 16,8] [--pops 4096] [--device cpu]

The reference's --tiles is the Pallas kernel's batch tile; K2's lane group
is a build constant (csrc/rollout_traversal.cu kGroup), so there is none.
"""
import argparse
import json
import statistics

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.ops import traversal_cuda as tc
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import boxes, playground_gen
from lifelike_tpu_torch.solver import mppi_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools.bench_common import standing_state, time_ms
from lifelike_tpu_torch.utils import profiling as P

M_LO = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", default="16,8")
    ap.add_argument("--pops", default="4096")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--eval_pop", type=int, default=1024, help="make_eval's width (0: skip)")
    ap.add_argument("--eval_horizon", type=int, default=12)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--m_hi", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (no fallback)")
    return ap.parse_args(argv)


def configs(args):
    """[(contact_k, population, horizon)] of a run, in order."""
    shapes = [(int(p), args.horizon) for p in args.pops.split(",")]
    if args.eval_pop:
        shapes.append((args.eval_pop, args.eval_horizon))
    return [(int(k), pop, h) for k in args.ks.split(",") for pop, h in shapes]


def expected_launches(argv=None):
    """K1-K4 launches of a run on the card with `argv`: per configuration
    the chained solves (one K2 launch each) and 1 + reps K2 calls alone."""
    args = parse_args(argv)
    per = P.chained_calls(M_LO, args.m_hi, args.reps) + 1 + args.reps
    return {"K1": 0, "K2": per * len(configs(args)), "K3": 0, "K4": 0}


def make_solve(dev, pop, horizon, substeps, contact_k, seed=0):
    """(solve: u (H, 4, 3) -> u', K2 on one set of the solve's candidates:
    () -> costs) of bench_epmc's fused solve on `dev`."""
    model = build_max_model()
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps, mass_freeze=substeps)
    cfg = MPPIConfig(horizon=horizon, population=pop, iterations=1, sigma=0.15)
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    state = standing_state(torch.float32, dev)
    scene = playground_gen.generate(torch.Generator(device=dev).manual_seed(3),
                                    playground_gen.PlaygroundConfig(element_id=1))
    table = tc.pack_boxes(boxes.nearest_boxes(scene, state.base_pos, contact_k))
    tl = B.tl_from_state(B.map_state(lambda x: x[None], state))
    ref = tc.constant_reference(state.joint_pos, horizon)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def score(u_cand):
        return tc.rollout_traversal_fused(c, params, tl, u_cand, table, ref, scene.target_pos,
                                          1.5, "joystick", gait_weight=0.0)

    def solve(u):
        return mppi_tl.mppi_update(cfg, gen, u, score)[0]

    lanes = 128 if pop % 128 == 0 else pop
    noise = mppi_tl._smooth_noise_tl(gen, (horizon, 4, 3, pop // lanes, lanes), cfg.beta,
                                     torch.float32, dev)
    u_cand = (cfg.sigma * noise).contiguous()
    return solve, lambda _: score(u_cand)


def main(argv=None, log=print):
    args = parse_args(argv)
    dev = _device.resolve_device(args.device)
    card = P.card_label(dev)
    rows = []
    for k, pop, horizon in configs(args):
        solve, k2 = make_solve(dev, pop, horizon, args.substeps, k)
        u0 = torch.zeros((horizon, 4, 3), dtype=torch.float32, device=dev)
        dt = P.chained_latency(solve, u0, m_lo=M_LO, m_hi=args.m_hi, reps=args.reps)
        k2_ms, _ = time_ms(k2, None, [None] * args.reps, dev)
        row = {"metric": f"epmc_solve_latency_pop{pop}_H{horizon}_k{k}", "contact_k": k,
               "population": pop, "horizon": horizon, "value": dt * 1e3, "unit": "ms",
               "k2_ms": statistics.median(k2_ms), "device": str(dev), "card": card}
        rows.append(row)
        log(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()

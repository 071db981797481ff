"""Probe: where does a scenario-sweep round spend its time?

Port of tools/probe_sweep.py. At the sweep's shapes (S 16 arenas with
random cubes from seed 11, population 1024 per robot per scenario, H 50,
substeps 10, kd 1, max_tau 16, mass_freeze 1 — the reference's `True` —
sigma 0.15) it times

  (a) one K3 call (ops.traversal_cuda.rollout_plan_fused) over the S plans,
      and over the first scenario's plan alone (S 1);
  (b) one K4 call (rollout_chase_fused) over the S scenario blocks of
      candidate rows;
  (c) one whole parallel.scenario_sweep.sweep_scenarios_tiled round (2 K3 +
      2 K4 launches and the MPPI glue),

each after a warm-up call, `--reps` times with its input perturbed (CUDA
events on the card; the host clock on the CPU, where the kernels' plain
versions run), printing each output's mean and the min / median ms.

    python -m lifelike_tpu_torch.tools.probe_sweep [--device cpu] [--scenarios 16]
        [--population 1024] [--horizon 50] [--substeps 10]

Ends with one JSON line of the rows, the card's name and power limit beside
them.
"""
import argparse
import json
import statistics

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.ops import traversal_cuda as tc
from lifelike_tpu_torch.parallel import scenario_sweep
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_gen
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools.bench_common import time_ms
from lifelike_tpu_torch.utils import profiling


def expected_launches(argv=None):
    """K1-K4 launches of a run on the card with `argv`: (a) K3 at S plans
    and at S 1, (b) K4 and (c) 2 K3 + 2 K4 per round, each 1 + reps
    calls."""
    calls = 1 + parse_args(argv).reps
    return {"K1": 0, "K2": 0, "K3": 2 * calls + 2 * calls, "K4": calls + 2 * calls}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu (no fallback)")
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--population", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--mass_freeze", type=int, default=1)
    ap.add_argument("--sigma", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--reps", type=int, default=6)
    return ap.parse_args(argv)


def main(argv=None, log=print):
    args = parse_args(argv)
    dev = _device.resolve_device(args.device)
    S, H = args.scenarios, args.horizon
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=args.substeps,
                                  mass_freeze=args.mass_freeze)
    cfg = MPPIConfig(horizon=H, population=args.population, iterations=1, sigma=args.sigma)
    c = B.tl_constants(build_max_model(), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    scen = scenario_sweep.generate_scenarios(gen, S, arena_gen.ArenaConfig(rand_cube=True),
                                             torch.float32, device=dev)
    boxes, refs, flag, roles = scenario_sweep._scenario_tables(scen, H)
    st = B.tl_from_state(RobotState(*(x[:, 0] for x in scen.robots)))  # robot 0, batch (S, 1)
    st1 = type(st)(*(x[..., :1, :] for x in st))
    Bs, L = scenario_sweep._layout(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    u_plan = torch.zeros((S, H, 4, 3), device=dev) + 0.01
    u_cand = 0.1 * torch.randn((H, 4, 3, S * Bs, L), generator=g, device=dev)
    opp = torch.zeros((S, H, 2), device=dev)
    card = profiling.card_label(dev)
    rows = {}

    def timeit(name, fn, arg, perturb):
        ms, out = time_ms(fn, arg, [perturb(arg, r) for r in range(args.reps)], dev)
        mean = float(out.float().mean())
        log(f"  {name} out-mean {mean:.4f}")
        rows[name] = {"min_ms": min(ms), "med_ms": statistics.median(ms), "out_mean": mean,
                      "ms": ms}
        log(f"{name}: min {min(ms):.3f} ms  med {statistics.median(ms):.3f} ms [{card}]")

    def scaled(x, r):
        return x * (1.0 + 1e-6 * (r + 1))

    timeit(f"plan_fused S={S}", lambda u: tc.rollout_plan_fused(c, params, st, u, boxes, refs[0]),
           u_plan, scaled)
    timeit("plan_fused S=1", lambda u: tc.rollout_plan_fused(c, params, st1, u, boxes[0],
                                                               refs[0][0]),
           u_plan[0].contiguous(), scaled)
    timeit(f"chase_fused {S * Bs}x{L} rows",
           lambda u: tc.rollout_chase_fused(c, params, st, u, boxes, refs[0], opp, flag, roles[0],
                                            gait_weight=0.0), u_cand, scaled)

    def round_(seed):
        g_round = torch.Generator(device=dev).manual_seed(seed)
        return scenario_sweep.sweep_scenarios_tiled(c, params, cfg, g_round, scen, device=dev)[1]

    timeit("full fused round", round_, 0, lambda seed, r: seed + r + 1)
    log(json.dumps({"scenarios": S, "population": args.population, "horizon": H,
                    "substeps": args.substeps, "mass_freeze": args.mass_freeze,
                    "device": str(dev), "card": card,
                    "rows": {k: {kk: v[kk] for kk in ("min_ms", "med_ms", "out_mean")}
                             for k, v in rows.items()}}))
    return rows


if __name__ == "__main__":
    main()

"""Weak scaling of the sharded MPC solve and scenario sweep over ranks.

Port of tools/scaling_bench.py. The reference proxies a pod with a virtual
8-device mesh in one process; the port has one device per process, so a
size n is n ranks of a gloo process group (parallel/distributed.py; gloo
lets ranks share a card), each on --device (rank r on cuda:{r % cards}),
started by tools/launch_multihost.py. Size 1 runs in this process, a world
of one without a group. At each size it times

  * the sharded solve (parallel.sharded_solve.make_sharded_solver: MPPI
    with the population sharded over the ranks, K1 on each rank's share) at
    population n x pop_per_dev: `weak_scaling_n{n}_pop{P}_H{H}`,
    vs_baseline t(1) / t(n); at size 1 also at the largest size's
    population: `weak_scaling_fixedwork_n1_pop{P}_H{H}`, vs_baseline
    t(fixed work) / t(largest size);
  * the sharded scenario sweep (parallel.scenario_sweep.
    sharded_scenario_sweep: K3 / K4 over each rank's scenario blocks) at n x
    scen_per_dev scenarios of sweep_pop: `sweep_weak_scaling_n{n}_s{S}_pop{P}`,
    vs_baseline t(1) / t(n);

then the process rows of tools/multihost_worker.py --bench on 1 and 2 ranks
at the same total population (pop_per_dev): `multiproc_scaling_p{p}_...`,
the 2-rank row's vs_baseline t(1 rank) / t(2 ranks).

A value is the least of `reps` timed calls after a warm-up, rank 0's (CUDA
events on the card, the host clock on the CPU; the process rows the host
clock after a synchronize). Each row also names its device, the card's name
and power limit and its ranks per card, and the size rows rank 0's K1 / K3
/ K4 launches; ranks that share a card time-slice it, and such a row says
that it is no scaling. Each size's first solve draws its candidates'
normals from one generator of seed 0 over the whole population, each rank
taking its share, so its plan (returned as `plan`, not printed) equals the
size-1 plan at that population up to the order of the sums.

    python -m lifelike_tpu_torch.tools.scaling_bench [--device cpu]

Sizes through the environment, as the reference's: SCALE_POP_PER_DEV (512),
SCALE_HORIZON (10), SCALE_SUBSTEPS (10), SCALE_REPS (3), SCALE_SCEN_PER_DEV
(2), SCALE_SWEEP_POP (64), and SCALE_SIZES (1,2,4,8); each also a flag.
"""
import argparse
import json
import math
import os
import sys
import tempfile

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.ops import traversal_cuda as tc
from lifelike_tpu_torch.parallel import distributed, scenario_sweep, sharded_solve
from lifelike_tpu_torch.parallel import mesh as meshlib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_gen
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools import launch_multihost
from lifelike_tpu_torch.tools.bench_common import standing_tl, time_ms
from lifelike_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 900  # every launch of ranks is killed after this long


def parse_args(argv=None):
    env = lambda name, default: os.environ.get(name, default)  # noqa: E731
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu (no fallback)")
    ap.add_argument("--pop_per_dev", type=int, default=int(env("SCALE_POP_PER_DEV", 512)))
    ap.add_argument("--horizon", type=int, default=int(env("SCALE_HORIZON", 10)))
    ap.add_argument("--substeps", type=int, default=int(env("SCALE_SUBSTEPS", 10)))
    ap.add_argument("--reps", type=int, default=int(env("SCALE_REPS", 3)))
    ap.add_argument("--scen_per_dev", type=int, default=int(env("SCALE_SCEN_PER_DEV", 2)))
    ap.add_argument("--sweep_pop", type=int, default=int(env("SCALE_SWEEP_POP", 64)))
    ap.add_argument("--sizes", default=env("SCALE_SIZES", "1,2,4,8"))
    ap.add_argument("--rank", default="", help=argparse.SUPPRESS)  # a rank's result file
    return ap.parse_args(argv)


def expected_launches(argv=None):
    """K1-K4 launches in this process (size 1) of a run on the card: the two
    solves' first, warm-up and timed calls (one K1 each), and the sweep's
    warm-up and timed calls (2 K3 + 2 K4 each); the other sizes' launches
    are their ranks', in their rows."""
    reps = parse_args(argv).reps
    return {"K1": 2 * (2 + reps), "K2": 0, "K3": 2 * (1 + reps), "K4": 2 * (1 + reps)}


def row_launches(metric, reps):
    """Rank 0's K1 / K3 / K4 launches behind the row `metric`."""
    if metric.startswith("sweep_"):
        return {"K1": 0, "K3": 2 * (1 + reps), "K4": 2 * (1 + reps)}
    return {"K1": 2 + reps, "K3": 0, "K4": 0}


def _launches():
    return {"K1": rollout_cuda.rollout_tracking_fused.launches,
            "K3": tc.rollout_plan_fused.launches, "K4": tc.rollout_chase_fused.launches}


def _since(before):
    return {k: n - before[k] for k, n in _launches().items()}


def _first_normals(mesh, cfg):
    """This rank's share of one draw of (H, 4, 3, population) normals of seed
    0, in its local (Bs, L) candidate layout."""
    g = torch.Generator(device=mesh.device).manual_seed(0)
    full = torch.randn((cfg.horizon, 4, 3, cfg.population), generator=g, device=mesh.device)
    rows = meshlib.shard_rows(mesh, cfg.population)
    return [full[..., rows].reshape(full.shape[:3] + sharded_solve.local_layout(
        mesh, cfg.population)).contiguous()]


def time_solve(mesh, args, pop):
    """(ms of the sharded solve at population `pop`, its first plan, rank
    0's launches)."""
    dev = mesh.device
    model = build_max_model()
    clips = motion_lib.pack_clips([motion_lib.make_synthetic_clip(240)], frame_step=1.0 / 120.0,
                                  device=dev)
    params = engine.PhysicsParams(substeps=args.substeps, mass_freeze=args.substeps)
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    cfg = MPPIConfig(horizon=args.horizon, population=pop, iterations=1)
    solve = sharded_solve.make_sharded_solver(mesh, model, c, params, clips, cfg)
    tl = standing_tl(torch.float32, dev)
    u0 = torch.zeros((args.horizon, 4, 3), dtype=torch.float32, device=dev)
    t0 = torch.tensor(0.5, dtype=torch.float32, device=dev)
    before = _launches()
    plan, _ = solve(None, tl, u0, 0, t0, eps=_first_normals(mesh, cfg))
    gen = distributed.rank_generator(0, mesh)
    ms, _ = time_ms(lambda _: solve(gen, tl, u0, 0, t0), None, [None] * args.reps, dev)
    return min(ms), plan.cpu().reshape(-1).tolist(), _since(before)


def time_sweep(mesh, args, n_scen):
    """(ms of one sharded sweep round over n_scen scenarios, rank 0's
    launches)."""
    dev = mesh.device
    c = B.tl_constants(build_max_model(), dtype=torch.float32, device=dev)
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=args.substeps,
                                  mass_freeze=args.substeps)
    cfg = MPPIConfig(horizon=args.horizon, population=args.sweep_pop, iterations=1, sigma=0.15)
    scen = scenario_sweep.generate_scenarios(torch.Generator(device=dev).manual_seed(5), n_scen,
                                             arena_gen.ArenaConfig(rand_cube=True),
                                             torch.float32, device=dev)
    before = _launches()
    ms, _ = time_ms(lambda seed: scenario_sweep.sharded_scenario_sweep(
        mesh, c, params, cfg, seed, scen, device=dev), 0, list(range(1, args.reps + 1)), dev)
    return min(ms), _since(before)


def _placement(dev, n):
    """The device type, ranks per card (None on the CPU) and a note of n
    ranks on `dev`."""
    if dev.type != "cuda":
        return {"device": "cpu", "ranks_per_card": None, "placement": "cpu ranks"}
    per = math.ceil(n / torch.cuda.device_count())
    return {"device": "cuda", "ranks_per_card": per,
            "placement": ("the card is time-sliced between the ranks: not a scaling" if per > 1
                          else "one rank per card")}


def run_size(mesh, args, fixed_pop=0):
    """This rank's rows of one size (mesh.world ranks), with their plans."""
    n = mesh.world
    where = _placement(mesh.device, n)
    rows = []
    pops = [("weak_scaling", n * args.pop_per_dev)]
    if fixed_pop:
        pops.append(("weak_scaling_fixedwork", fixed_pop))
    for name, pop in pops:
        ms, plan, launches = time_solve(mesh, args, pop)
        rows.append({"metric": f"{name}_n{n}_pop{pop}_H{args.horizon}", "value": ms,
                     "unit": "ms", **where, "launches": launches, "plan": plan})
    n_scen = n * args.scen_per_dev
    ms, launches = time_sweep(mesh, args, n_scen)
    rows.append({"metric": f"sweep_weak_scaling_n{n}_s{n_scen}_pop{args.sweep_pop}", "value": ms,
                 "unit": "ms", **where, "launches": launches})
    return rows


def rank_main(args):
    """One rank of a size: join the group, time, rank 0 writes the rows."""
    distributed.initialize(backend="gloo", device=args.device, timeout_s=TIMEOUT_S)
    try:
        mesh = distributed.global_mesh(args.device)
        rows = run_size(mesh, args)
        if mesh.rank == 0:
            with open(args.rank, "w") as f:
                json.dump(rows, f)
    finally:
        distributed.destroy()
    return 0


def _launch(name, cmd, n, dev, log_dir):
    """Run `cmd` as n gloo ranks; raises with the ranks' log tails unless
    every rank exits 0. Returns rank 0's log."""
    logs = os.path.join(log_dir, name)
    rcs = launch_multihost.launch(cmd, n, backend="gloo", cpu=dev.type == "cpu", log_dir=logs,
                                  timeout=TIMEOUT_S, cwd=ROOT)
    text = [open(os.path.join(logs, f"rank{r}.log")).read() for r in range(n)]
    if any(rcs):
        tails = "\n".join(f"--- rank {r} ---\n{t[-3000:]}" for r, t in enumerate(text))
        raise SystemExit(f"scaling_bench {name}: rank exit codes {rcs}\n{tails}")
    return text[0]


def _printed(row):
    return json.dumps({k: v for k, v in row.items() if k != "plan"})


def main(argv=None, log=print):
    args = parse_args(argv)
    if args.rank:
        return rank_main(args)
    dev = _device.resolve_device(args.device)
    sizes = [int(n) for n in args.sizes.split(",")]
    flags = ["--device", dev.type] + [f"--{k}={getattr(args, k)}" for k in (
        "pop_per_dev", "horizon", "substeps", "reps", "scen_per_dev", "sweep_pop")]
    rows, base, card = [], {}, profiling.card_label(dev)
    with tempfile.TemporaryDirectory() as d:
        for n in sizes:
            if n == 1:
                got = run_size(meshlib.make_mesh(dev), args,
                               fixed_pop=max(sizes) * args.pop_per_dev)
            else:
                out = os.path.join(d, f"rows_n{n}.json")
                _launch(f"n{n}", [sys.executable, "-m", "lifelike_tpu_torch.tools.scaling_bench",
                                  f"--rank={out}"] + flags, n, dev, d)
                with open(out) as f:
                    got = json.load(f)
            for row in got:
                kind = row["metric"].split("_n")[0]
                base.setdefault(kind, row["value"])
                rows.append(row)
        largest = {r["metric"].split("_n")[0]: r["value"] for r in rows}
        for row in rows:
            kind = row["metric"].split("_n")[0]
            if kind == "weak_scaling_fixedwork":
                row["vs_baseline"] = row["value"] / largest["weak_scaling"]
            else:
                row["vs_baseline"] = base[kind] / row["value"]
            row["card"] = card
            log(_printed(row))

        # the process rows: multihost_worker --bench on 1 and 2 ranks, the
        # same total population
        for p in (1, 2):
            cmd = [sys.executable, "-m", "lifelike_tpu_torch.tools.multihost_worker", "--bench",
                   "--device", dev.type, f"--pop_per_rank={args.pop_per_dev // p}",
                   f"--horizon={args.horizon}", f"--substeps={args.substeps}",
                   f"--reps={args.reps}"]
            text = _launch(f"p{p}", cmd, p, dev, d)
            got = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
            if len(got) != 1:
                raise SystemExit(f"scaling_bench p{p}: {len(got)} rows in rank 0's log")
            row = dict(got[0], **_placement(dev, p), card=card)
            row["vs_baseline"] = base.setdefault("multiproc", row["value"]) / row["value"]
            rows.append(row)
            log(_printed(row))
    return rows


if __name__ == "__main__":
    main()

"""One rank of a multi-process run: the sharded MPPI solve and one
data-parallel PMC PPO step (collection and update) over every rank.

Port of tools/multihost_worker.py. Started by
lifelike_tpu_torch/tools/launch_multihost.py (and entry.dryrun_multichip):

    python -m lifelike_tpu_torch.tools.launch_multihost -n 2 --cpu -- \\
        python -m lifelike_tpu_torch.tools.multihost_worker --device=cpu

It joins the process group (parallel/distributed.py), solves once with the
population sharded over the ranks (parallel/sharded_solve.py: K1 on the
card, its plain version on the CPU), then runs one learner_step of a
PMCNet on the tracking env with 2 environments per rank, data-parallel
(learning/learner.py), and prints the JAX worker's `... ok` lines and
`MULTIHOST_OK`. The loss and the solve's best cost are read with
distributed.fetch, which raises if the ranks disagree. --bench prints
instead a JSON latency row of the sharded solve on rank 0 (best of --reps
solves; CUDA events on the card).
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from lifelike_tpu_torch.envs import factory
from lifelike_tpu_torch.learning import learner
from lifelike_tpu_torch.models import pmc
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.parallel import distributed, sharded_solve
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics.engine import PhysicsParams
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools.bench_common import standing_tl


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu (no fallback)")
    ap.add_argument("--backend", default="", help="nccl or gloo (default: the environment's)")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--pop_per_rank", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=3)
    ap.add_argument("--substeps", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    multi = distributed.initialize(backend=args.backend or None, device=args.device)
    try:
        mesh = distributed.global_mesh(args.device)
        run(args, mesh, multi)
    finally:
        distributed.destroy()
    return 0


def run(args, mesh, multi):
    rank, dev = mesh.rank, mesh.device
    print(f"proc {rank}: joined, {mesh.world} ranks, device {dev}, backend {mesh.backend}, "
          f"multi={multi}", flush=True)
    bundle = factory.create_tracking_game(device=dev, data_path="synthetic")
    params = PhysicsParams(substeps=args.substeps)
    c = B.tl_constants(bundle.model, dtype=torch.float32, device=dev)
    tl = standing_tl(torch.float32, dev)

    # --- the sharded MPPI solve ------------------------------------------
    cfg = MPPIConfig(horizon=args.horizon, population=mesh.world * args.pop_per_rank,
                     iterations=1)
    solve = sharded_solve.make_sharded_solver(mesh, bundle.model, c, params, bundle.clips, cfg)
    gen = distributed.rank_generator(args.seed, mesh)
    u0 = torch.zeros((cfg.horizon, 4, 3), dtype=torch.float32, device=dev)
    launches = rollout_cuda.rollout_tracking_fused.launches
    u, diag = solve(gen, tl, u0, 0, 0.0)
    best = float(distributed.fetch(diag["best_cost"], mesh))
    distributed.fetch(u, mesh)
    if not np.isfinite(best):
        raise SystemExit(f"proc {rank}: best cost {best}")
    k1 = rollout_cuda.rollout_tracking_fused.launches - launches
    print(f"proc {rank}: sharded MPC solve ok; best_cost={best:.4f}; K1 launches {k1}",
          flush=True)

    if args.bench:
        ts = []
        for _ in range(args.reps):
            _sync(dev)
            t0 = time.perf_counter()
            solve(gen, tl, u0, 0, 0.0)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        if rank == 0:
            print(json.dumps({"metric": f"multiproc_scaling_p{mesh.world}_pop{cfg.population}"
                                        f"_H{cfg.horizon}",
                              "value": 1e3 * min(ts), "unit": "ms", "vs_baseline": 0.0}),
                  flush=True)
        return

    # --- one data-parallel PMC PPO step (collection + update) -------------
    lcfg = learner.PPOConfig(unroll_length=3)
    net = pmc.PMCNet(generator=torch.Generator().manual_seed(args.seed)).to(dev)
    optimizer = learner.make_optimizer(lcfg, net)
    env_state, _ = bundle.reset(gen, batch=(2,))
    _, metrics = learner.learner_step(net, bundle.model, bundle.clips, bundle.cfg, lcfg,
                                      optimizer, env_state, gen,
                                      group=mesh if mesh.group is not None else None)
    loss = float(distributed.fetch(metrics["loss"], mesh))
    if not np.isfinite(loss):
        raise SystemExit(f"proc {rank}: loss {loss}")
    print(f"proc {rank}: sharded train step ok; loss={loss!r}", flush=True)
    print(f"proc {rank}: MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    sys.exit(main())

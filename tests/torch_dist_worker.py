"""One rank of the port's multi-process parity tests
(tests/test_torch_distributed.py, tests/test_torch_dp_learner.py).

    python -m tests.torch_dist_worker CASE DIR

started by lifelike_tpu_torch/tools/launch_multihost.py (gloo on the CPU):
reads DIR/inputs.pt (written by the test), joins the process group, runs
CASE on this rank's share of the inputs and writes DIR/out{rank}.pt for
the test to hold against the JAX reference. Imports torch, numpy and the
port only.
"""
import os
import sys

import torch

from lifelike_tpu_torch.learning import learner, recurrent
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import epmc, pmc
from lifelike_tpu_torch.parallel import distributed as D
from lifelike_tpu_torch.parallel import mesh as meshlib
from lifelike_tpu_torch.parallel import scenario_sweep, sharded_solve
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model

from tests.torch_port_util import CPU, F64


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def helpers(mesh):
    """Slicing, broadcast, gather, reductions and fetch's replication guard."""
    r = mesh.rank
    x = torch.arange(8.0).reshape(4, 2)
    rows = meshlib.shard_batch(mesh, {"a": x, "b": (x.T,)})
    assert torch.equal(rows["a"], x[2 * r:2 * r + 2])
    assert torch.equal(rows["b"][0], x.T[r:r + 1])
    assert torch.equal(D.host_local_axis(mesh, {"w": x.T, "n": torch.tensor(3)}, 1)["w"],
                       x.T[:, 2 * r:2 * r + 2])
    _raises(lambda: meshlib.shard_rows(mesh, 3))
    mine = torch.tensor([r + 1.0, -r])
    assert torch.equal(D.replicate(mesh, {"v": mine})["v"], torch.tensor([1.0, 0.0]))
    assert torch.equal(D.all_gather(mine, mesh), torch.tensor([[1.0, 0.0], [2.0, -1.0]]))
    assert torch.equal(D.all_sum(mine, mesh), torch.tensor([3.0, -1.0]))
    assert torch.equal(D.all_min(mine, mesh), torch.tensor([1.0, -1.0]))
    assert torch.equal(D.all_mean(mine, mesh), torch.tensor([1.5, -0.5]))
    assert torch.equal(D.all_sum(torch.tensor([r == 0]), mesh), torch.tensor([True]))
    assert (D.fetch(torch.tensor([2.0, float("nan")]), mesh)[0] == 2.0)
    return {"fetch_refused": _raises(lambda: D.fetch(mine, mesh))}


def solve(mesh, inp):
    out = helpers(mesh)
    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    eps = inp["eps"][mesh.rank]
    u, diag = sharded_solve.sharded_mppi_step(mesh, c, inp["params"], inp["cfg"], None,
                                              inp["state"], inp["u0"], inp["ref"], eps=eps)
    out.update(u=u, best_cost=diag["best_cost"], weighted_cost=diag["weighted_cost"])
    hcfg = inp["cfg"]._replace(iterations=1)  # the hybrid's MPPI stage: one iteration
    u_h, hdiag = sharded_solve.sharded_hybrid_step(
        mesh, build_max_model(), c, inp["params"], inp["clips"], hcfg, inp["icfg"], None,
        inp["state"], inp["u0"], 0, inp["t0"], inp["ref"], eps=eps[:1])
    out.update(hybrid_u=u_h, hybrid_best=hdiag["best_cost"], refined=hdiag["refined_cost"])
    return out


def sweep(mesh, inp):
    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    args = (mesh, c, inp["params"], inp["cfg"], inp["seed"])
    u, cost, summary = scenario_sweep.sharded_scenario_sweep(*args, inp["scen"], device=CPU)
    odd = rp.tree_map(lambda x: x[:3], inp["scen"])  # 3 scenarios: do not divide over 2
    refused = _raises(lambda: scenario_sweep.sharded_scenario_sweep(*args, odd, device=CPU))
    return dict(u=u, cost=cost, summary=summary, refused=refused)


def _train_out(net, opt, metrics):
    return dict(params={k: v.detach().clone() for k, v in net.state_dict().items()},
                metrics={k: v.detach().clone() for k, v in metrics.items()},
                exp_avg=opt.exp_avg.clone(), exp_avg_sq=opt.exp_avg_sq.clone(),
                step=opt.step_count)


def train(mesh, inp):
    group = mesh
    out = {}
    # PMC train_step on this rank's columns of the global (T, B) rollout
    net = pmc.PMCNet(pmc.PMCConfig(**inp["pmc_cfg"])).to(F64)
    net.load_state_dict(inp["pmc_state"])
    cfg = learner.PPOConfig(*inp["lcfg"])
    opt = learner.make_optimizer(cfg, net)
    roll = meshlib.shard_batch(mesh, learner.Rollout(**inp["pmc_roll"]), axis=1)
    out["pmc"] = _train_out(net, opt, learner.train_step(net, opt, cfg, roll, group))
    # EPMC recurrent train step (burn-in) likewise
    enet = epmc.EPMCNet(epmc.EPMCConfig(**inp["epmc_cfg"])).to(F64)
    enet.load_state_dict(inp["epmc_state"])
    eopt = learner.make_optimizer(cfg, enet)
    eroll = meshlib.shard_batch(mesh, recurrent.RecurrentRollout(**inp["epmc_roll"]), axis=1)
    m = recurrent.epmc_train_step(enet, eopt, cfg, eroll, burn_in=inp["burn_in"], group=group)
    out["epmc"] = _train_out(enet, eopt, m)
    # learner_step: the clip statistics and code counts summed over the ranks
    from lifelike_tpu_torch.envs import factory

    bundle = factory.create_tracking_game(device=CPU, data_path="synthetic")
    local = []
    collect = learner.collect_rollout

    def recording(*a, **k):
        res = collect(*a, **k)
        local.append(res[2])
        return res

    learner.collect_rollout = recording
    gen = D.rank_generator(0, mesh)
    snet = pmc.PMCNet(pmc.PMCConfig(**inp["pmc_cfg"]), generator=torch.Generator().manual_seed(0))
    sopt = learner.make_optimizer(cfg, snet)
    env_state, _ = bundle.reset(gen, batch=(2,))
    _, metrics = learner.learner_step(snet, bundle.model, bundle.clips, bundle.cfg,
                                      cfg._replace(unroll_length=2), sopt, env_state, gen,
                                      group=group)
    out["stats"] = dict(local=local[0], summed=tuple(metrics[k] for k in (
        "clip_reward_sum", "clip_ep_count", "code_counts")))
    return out


CASES = {"solve": solve, "sweep": sweep, "train": train}


def main(case, directory):
    D.initialize(device=CPU, timeout_s=120)
    try:
        mesh = D.global_mesh(CPU)
        inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        out = CASES[case](mesh, inp)
        torch.save(out, os.path.join(directory, f"out{mesh.rank}.pt"))
    finally:
        D.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:3])

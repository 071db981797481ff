"""Learner entry point: PPO training for any of the three stages, on one
GPU or data-parallel over several processes.

Port of lifelike_tpu.bin.run_learner: the same flags (env / policy /
learner configs as Python-dict string literals), the same loop — stage
init, --init_model / --init_model_subtree / --freeze_init_subtree hand-off,
--pmc_replay, the burn-in fit, the prioritized clip sampler, the VQ code
usage EMA with restart_dead_codes every 100 updates, model publication to
the pool and the league, PFSP opponent rotation every
--update_opponent_freq updates, --train_checkpoint / --save_interval resume
and the league checkpoint:

  * pmc: models.pmc.PMCNet on the envs.primitive tracking plant, PPO
    (learning/learner.py; --pmc_replay: the device replay with
    num_updates steps per unroll); the clip defaults to "synthetic"
    (motion_lib.make_synthetic_clip), as run_eval's;
  * epmc: models.epmc.EPMCNet on envs.playground, recurrent PPO with
    burn-in through the replay (learning/recurrent.py); --init_model seeds
    and freezes the PMC stage's LLC;
  * sepmc: models.sepmc.SEPMCNet self-play on envs.chase_tag against PFSP
    opponents from the pool.

  python -m lifelike_tpu_torch.bin.run_learner --task=pmc --num_envs=256 --total_updates=1000
  python -m lifelike_tpu_torch.bin.run_learner --task=epmc \\
    --init_model=lifelike_tpu_torch/data/pmc_r5/model_0009660.model \\
    --init_model_subtree=params/llc,params/prop_rms --model_pool_dir=pool_epmc
  python -m lifelike_tpu_torch.bin.run_learner --task=sepmc \\
    --init_model=pool_epmc/model_0000000.model \\
    --init_model_subtree=params/llc,params/prop_rms,params/mlc_fc=params/pi_fc,...

Multi-process (the JAX entry point's --coordinator / --num_processes /
--process_id, defaulting to the LIFELIKE_* environment that
lifelike_tpu_torch/tools/launch_multihost.py sets, plus --backend): one
rank per device (parallel/distributed.py), each stepping num_envs / W
environments reset from its own generator (distributed.rank_seed), the
parameters replicated (every rank initializes them from --seed) and each
update data-parallel over the ranks (learning/learner.py: global batch
statistics, gradients averaged before the clip). The host bookkeeping runs
in lockstep: the clip statistics, code counts and game outcomes are summed
over the ranks before the host reads them, and the league's generator is
seeded alike on every rank, so every rank makes the same decisions. Rank 0
alone writes the pool, the league checkpoint and the summary line; each
rank logs its own `update N:` lines. The train checkpoint is then a
learning/registry.ShardedTrainCheckpoint (a file per rank and a marker; a
resume needs the same world size), as it is for one process where the
marker exists, so that a run of another world size than the saving run's
starts from nothing and says so. --pmc_replay stays single-process, as
the JAX entry point asserts.

Differences from the JAX entry point: --device (default cuda; no CPU
fallback) replaces --cpu; there is no --matmul_precision (training always
runs at full float32 precision, TF32 off through the backward); --backend
(nccl or gloo) is the port's; a --init_model_subtree entry may read
"dst=src" to load a donor subtree named otherwise; the train checkpoint is
the port's own format (learning/registry.TrainCheckpoint) and also holds
the generators, the clip sampler, the code usage and the league, so a
resume continues the same run exactly.

Each update is timed by three marks — its start, the end of collection and
the end of the optimisation (CUDA events on the card, the host clock on the
CPU) — and the metrics are fetched to the host once per --log_interval:
env steps/s and ms per update split into collection and optimisation are
logged beside them. The clip statistics, code counts and game outcomes that
the host-side bookkeeping reads are fetched every update, as the JAX loop
fetches them.
"""
import argparse
import ast
import copy
import os
import sys
import time

import numpy as np
import torch

from lifelike_tpu_torch.envs import factory
from lifelike_tpu_torch.learning import freeze as freeze_lib
from lifelike_tpu_torch.learning import learner, recurrent, registry
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.learning.learner import PPOConfig
from lifelike_tpu_torch.models import epmc, pmc, sepmc
from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.parallel import distributed

# the trees of a train checkpoint that every rank holds alike: in rank 0's
# file only (learning/registry.ShardedTrainCheckpoint)
REPLICATED = ("net", "optimizer", "sampler", "code_usage", "restart_rng", "league", "pool",
              "opp_key", "pfsp_rng")


def _str2bool(s):
    if isinstance(s, bool):
        return s
    if s.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if s.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def _bool_flag(p, name, default, help):
    """absl's boolean flag forms: --name, --name=true|false, --noname."""
    p.add_argument(f"--{name}", nargs="?", const=True, default=default, type=_str2bool, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false", help=argparse.SUPPRESS)


def arg_parser(description=__doc__.split("\n")[0]):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--task", default="pmc", choices=["pmc", "epmc", "sepmc"])
    p.add_argument("--update_opponent_freq", type=int, default=20,
                   help="(sepmc) re-sample the PFSP opponent every N updates")
    p.add_argument("--env_config", default="{}", help="env config as a python dict literal")
    p.add_argument("--policy_config", default="{}", help="net config overrides (dict literal)")
    p.add_argument("--learner_config", default="{}", help="PPOConfig overrides (dict literal)")
    p.add_argument("--num_envs", type=int, default=64, help="parallel environments")
    p.add_argument("--total_updates", type=int, default=100, help="learner iterations")
    p.add_argument("--pub_interval", type=int, default=5, help="publish model every N updates")
    p.add_argument("--log_interval", type=int, default=4, help="log metrics every N updates")
    p.add_argument("--model_pool_dir", default="", help="model pool persistence dir")
    p.add_argument("--checkpoint_dir", default="", help="league checkpoint dir")
    p.add_argument("--init_model", default="", help="seed model file (stage hand-off)")
    p.add_argument("--init_model_subtree", default="params/llc",
                   help="comma-separated /-paths to load from init_model; an entry dst=src "
                        "loads the donor's src subtree at dst")
    _bool_flag(p, "freeze_init_subtree", True, "freeze loaded subtrees")
    p.add_argument("--seed", type=int, default=0, help="generator seed")
    _bool_flag(p, "pmc_replay", False,
               "PMC: stage unrolls through the device replay and run num_updates optimizer "
               "steps per unroll (the reference rm_size/rollout_len/batch pipeline) instead of "
               "one step per unroll; an unroll yields (unroll_length//rollout_length)*num_envs "
               "window slots, so replay_size should hold >= 1-2 unrolls")
    p.add_argument("--train_checkpoint", default="",
                   help="file for full learner-state checkpoints (resume-able)")
    p.add_argument("--save_interval", type=int, default=50,
                   help="save the train checkpoint every N updates")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--coordinator", default="", help="host:port of rank 0 (multi-process)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="ranks of a multi-process run (0: LIFELIKE_NUM_PROCESSES or 1)")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank (-1: LIFELIKE_PROCESS_ID or 0)")
    p.add_argument("--backend", default="",
                   help="nccl or gloo (default: LIFELIKE_BACKEND, else nccl on the card and "
                        "gloo on the CPU; gloo lets ranks share one card)")
    return p


def parse_args(argv=None):
    return arg_parser().parse_args(argv)


def _cfgd(s):
    return ast.literal_eval(s) if s else {}


def _fit_burn_in(cfg, log):
    """Shrink burn_in when the unroll is too short for a full burn-in window
    (smoke runs with tiny unrolls); full-scale runs keep the reference 12."""
    if cfg.unroll_length < cfg.rollout_length:
        log("rollout_length %d > unroll_length %d; shrinking"
            % (cfg.rollout_length, cfg.unroll_length))
        cfg = cfg._replace(rollout_length=cfg.unroll_length)
    window = cfg.burn_in + cfg.rollout_length
    if cfg.unroll_length < window:
        fit = max(0, cfg.unroll_length - cfg.rollout_length)
        log("unroll_length %d < burn_in %d + rollout_length %d; shrinking burn_in to %d"
            % (cfg.unroll_length, cfg.burn_in, cfg.rollout_length, fit))
        cfg = cfg._replace(burn_in=fit)
    return cfg


def subtree_paths(spec):
    """"params/llc,params/mlc_fc=params/pi_fc" -> [("params", "llc"),
    (("params", "mlc_fc"), ("params", "pi_fc"))]."""
    out = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        if "=" in entry:
            dst, src = entry.split("=")
            out.append((tuple(dst.split("/")), tuple(src.split("/"))))
        else:
            out.append(tuple(entry.split("/")))
    return out


class UpdateTimer:
    """Marks of one update (start, end of collection, end of the
    optimisation): CUDA events on the card, read only when split() is
    called; the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def start(self):
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def split(self):
        """(collection ms, optimisation ms) of the current update."""
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return m[0].elapsed_time(m[1]), m[1].elapsed_time(m[2])
        return 1e3 * (m[1] - m[0]), 1e3 * (m[2] - m[1])


class Run:
    """What every stage shares: the device, generator, pool, league, timer,
    train checkpoint and the log of metrics."""

    def __init__(self, args, log):
        self.args, self.log = args, log
        self.mesh = distributed.global_mesh(args.device)
        # the data-parallel group of the step functions (None: one process)
        self.group = self.mesh if self.mesh.group is not None else None
        self.main = self.mesh.rank == 0
        self.dev = self.mesh.device
        self.gen = distributed.rank_generator(args.seed, self.mesh)
        self.pool = registry.ModelPool(root=args.model_pool_dir or None)
        self.league = registry.LeagueManager(self.pool, checkpoint_dir=args.checkpoint_dir or None)
        if args.checkpoint_dir:
            self.league.restore()
        self.timer = UpdateTimer(self.dev)
        self.ckpt = None
        path = args.train_checkpoint
        # per-rank files and a marker above one rank, and for one process
        # where a marker exists: its world-size rule then decides, and says
        # why the run does not resume
        self.sharded = bool(path) and (self.mesh.world > 1 or os.path.exists(path + ".step"))
        if self.sharded:
            self.ckpt = registry.ShardedTrainCheckpoint(path, self.mesh, log)
        elif path:
            self.ckpt = registry.TrainCheckpoint(path)
        self.history = []
        lrn = {k: v for k, v in _cfgd(args.learner_config).items() if k in PPOConfig._fields}
        self.cfg = PPOConfig(**lrn)
        if args.num_envs % self.mesh.world:
            raise ValueError(f"--num_envs={args.num_envs} does not divide over "
                             f"{self.mesh.world} ranks")
        self.B = args.num_envs // self.mesh.world  # this rank's environments

    def seeded(self):
        """The generator that initializes the net (CPU, from --seed)."""
        return torch.Generator().manual_seed(self.args.seed)

    def init_model(self, net):
        """--init_model: load the subtrees into `net`; returns the frozen
        prefixes (none without --freeze_init_subtree)."""
        a = self.args
        if not a.init_model:
            return ()
        donor = self.pool.load_file("init", a.init_model)
        paths = subtree_paths(a.init_model_subtree)
        freeze_lib.load_subtree(net, donor, paths)
        self.log("loaded subtrees %s from %s" % (a.init_model_subtree, a.init_model))
        return freeze_lib.dst_paths(paths) if a.freeze_init_subtree else ()

    def resume(self, net, optimizer):
        """Restore the net, optimizer and generator from the train
        checkpoint; returns (first update, the other saved trees on the
        device) — (0, None) without a checkpoint."""
        st = None if self.ckpt is None else self.ckpt.load()
        if st is None:
            return 0, None
        t = st["trees"]
        net.load_state_dict(t.pop("net"))
        optimizer.load_state_dict(t.pop("optimizer"))
        self.gen.set_state(t.pop("generator"))
        self.log("resumed %s at update %d" % (self.ckpt.path, st["step"] + 1))
        return st["step"] + 1, rp.tree_map(
            lambda x: x.to(self.dev) if torch.is_tensor(x) else x, t)

    def maybe_save(self, i, net, optimizer, **trees):
        if self.ckpt and (i + 1) % self.args.save_interval == 0:
            shards = {"replicated": REPLICATED} if self.sharded else {}
            self.ckpt.save(i, net=net.state_dict(), optimizer=optimizer.state_dict(),
                           generator=self.gen.get_state(), **shards, **trees)

    def log_publish(self, i, metrics, net):
        a, cfg = self.args, self.cfg
        if i % a.log_interval == 0:
            # sorted, as the reference's jitted step returns its metrics
            m = {k: float(metrics[k]) for k in sorted(metrics)}
            collect_ms, optimize_ms = self.timer.split()
            sps = cfg.unroll_length * a.num_envs / ((collect_ms + optimize_ms) / 1e3)
            self.history.append(dict(update=i, metrics=m, collect_ms=collect_ms,
                                     optimize_ms=optimize_ms, env_steps_per_s=sps))
            self.log("update %d: %s | env steps/s %.0f | ms per update: collection %.1f, "
                     "optimisation %.1f" % (i, m, sps, collect_ms, optimize_ms))
        if i % a.pub_interval == 0:
            key = f"model_{i:07d}"
            self.pool.push(key, P.flax_tree(net), meta={"update": i},
                           persist=bool(a.model_pool_dir) and self.main)
            self.league.add_to_population(key)


def train_pmc(run: Run):
    a, cfg, dev, gen, log = run.args, run.cfg, run.dev, run.gen, run.log
    env_config = _cfgd(a.env_config)
    pol = _cfgd(a.policy_config)
    env_config.setdefault("data_path", "synthetic")
    bundle = factory.create_tracking_game(device=dev, **env_config)
    net = pmc.PMCNet(pmc.PMCConfig(**{k: v for k, v in pol.items()
                                      if k in pmc.PMCConfig._fields}),
                     generator=run.seeded()).to(dev)
    env_state, _ = bundle.reset(gen, batch=(run.B,))
    optimizer = learner.make_optimizer(cfg, net)
    # prioritized clip resampling p ~ (1 - avg_reward)^factor (reference
    # primitive_level_env.py:236-240), updated host-side from the per-clip
    # episode stats of each unroll
    sampler = motion_lib.PrioritizedClipSampler(bundle.clips.num_clips, device=dev)
    if a.pmc_replay and run.group is not None:
        raise ValueError("--pmc_replay is single-process (as the JAX run_learner asserts)")
    replay = (learner.replay_init(net, bundle.model, bundle.clips, bundle.cfg, cfg, env_state)
              if a.pmc_replay else None)
    # VQ codebook health: EMA of per-code usage + periodic dead-code restarts
    code_usage = np.zeros(net.cfg.num_embeddings)
    restart_rng = np.random.default_rng(a.seed + 7777)
    start, saved = run.resume(net, optimizer)
    if saved is not None:
        env_state, replay = saved["env_state"], saved["replay"]
        sampler.avg_reward, sampler._p = saved["sampler"]
        code_usage = saved["code_usage"]
        restart_rng.bit_generator.state = saved["restart_rng"]
    for i in range(start, a.total_updates):
        run.timer.start()
        if replay is not None:
            env_state, replay, metrics = learner.learner_step_replayed(
                net, bundle.model, bundle.clips, bundle.cfg, cfg, optimizer, env_state, replay,
                gen, clip_probs=sampler.probabilities, timer=run.timer)
        else:
            env_state, metrics = learner.learner_step(
                net, bundle.model, bundle.clips, bundle.cfg, cfg, optimizer, env_state, gen,
                clip_probs=sampler.probabilities, timer=run.timer, group=run.group)
        run.timer.mark()
        sampler.update_sums(metrics.pop("clip_reward_sum").cpu().numpy(),
                            metrics.pop("clip_ep_count").cpu().numpy())
        code_usage = 0.98 * code_usage + metrics.pop("code_counts").cpu().numpy()
        if (i + 1) % 100 == 0:
            n_restart = pmc.restart_dead_codes(net, code_usage, restart_rng)
            if n_restart:
                log("restarted %d dead VQ codes" % n_restart)
        run.log_publish(i, metrics, net)
        run.maybe_save(i, net, optimizer, env_state=env_state, replay=replay,
                       sampler=(sampler.avg_reward.copy(), sampler._p.copy()),
                       code_usage=code_usage, restart_rng=restart_rng.bit_generator.state)
    return net, optimizer


def _recurrent_start(run: Run, net, obs, agents=()):
    """Hidden state, frozen hand-off, optimizer, burn-in fit and replay of a
    recurrent stage."""
    hs = net.initial_state((run.B,) + agents)
    frozen = run.init_model(net)
    optimizer = learner.make_optimizer(run.cfg, net, frozen=frozen)
    run.cfg = _fit_burn_in(run.cfg, run.log)
    ex_obs, ex_hs = (recurrent._agent_obs(obs, 0), hs[:, 0]) if agents else (obs, hs)
    replay = recurrent.recurrent_replay_init(
        run.cfg, recurrent.rollout_example(run.cfg, recurrent._cast(ex_obs, ex_hs.dtype), ex_hs))
    prev_done = torch.zeros(run.B, dtype=torch.bool, device=run.dev)
    return hs, optimizer, replay, prev_done


def train_epmc(run: Run):
    a, dev, gen = run.args, run.dev, run.gen
    pol = _cfgd(a.policy_config)
    bundle = factory.create_playground_game(device=dev, **_cfgd(a.env_config))
    net = epmc.EPMCNet(epmc.EPMCConfig(**{k: v for k, v in pol.items()
                                          if k in epmc.EPMCConfig._fields}),
                       generator=run.seeded()).to(dev)
    env_state, obs = bundle.reset(gen, batch=(run.B,))
    hs, optimizer, replay, prev_done = _recurrent_start(run, net, obs)
    start, saved = run.resume(net, optimizer)
    if saved is not None:
        env_state, obs, hs, prev_done, replay = (saved[k] for k in (
            "env_state", "obs", "hs", "prev_done", "replay"))
    for i in range(start, a.total_updates):
        run.timer.start()
        env_state, obs, hs, prev_done, replay, metrics = recurrent.epmc_learner_step_replayed(
            net, bundle, run.cfg, optimizer, env_state, obs, hs, prev_done, replay, gen,
            timer=run.timer, group=run.group)
        run.timer.mark()
        run.log_publish(i, metrics, net)
        run.maybe_save(i, net, optimizer, env_state=env_state, obs=obs, hs=hs,
                       prev_done=prev_done, replay=replay)
    return net, optimizer


def train_sepmc(run: Run):
    """Self-play Chase Tag (reference example_sepmc_train.sh: PFSPGameMgr
    over frozen historical models, init from the EPMC stage's model)."""
    a, dev, gen, pool, league = run.args, run.dev, run.gen, run.pool, run.league
    pol = _cfgd(a.policy_config)
    bundle = factory.create_chase_tag_game(device=dev, **_cfgd(a.env_config))
    net = sepmc.SEPMCNet(sepmc.SEPMCConfig(**{k: v for k, v in pol.items()
                                              if k in sepmc.SEPMCConfig._fields}),
                         generator=run.seeded()).to(dev)
    league.game_mgr_type = "pfsp"
    env_state, obs = bundle.reset(gen, batch=(run.B,))
    hs, optimizer, replay, prev_done = _recurrent_start(run, net, obs, agents=(2,))
    pool.push("model_0000000", P.flax_tree(net), meta={"update": 0},
              persist=bool(a.model_pool_dir) and run.main)
    league.add_to_population("model_0000000")
    rng = np.random.default_rng(a.seed)
    opp_key = league.sample_opponent(rng)
    opponent = copy.deepcopy(net).requires_grad_(False)
    start, saved = run.resume(net, optimizer)
    if saved is not None:
        env_state, obs, hs, prev_done, replay = (saved[k] for k in (
            "env_state", "obs", "hs", "prev_done", "replay"))
        league.load_state(saved["league"])
        for k, (model, meta) in saved["pool"].items():
            pool._models[k], pool._meta[k] = model, meta
        opp_key = saved["opp_key"]
        rng.bit_generator.state = saved["pfsp_rng"]
    sepmc.load_params(opponent, pool.pull(opp_key))
    for i in range(start, a.total_updates):
        run.timer.start()
        env_state, obs, hs, prev_done, replay, metrics = recurrent.sepmc_learner_step_replayed(
            net, bundle, run.cfg, optimizer, opponent, env_state, obs, hs, prev_done, replay,
            gen, timer=run.timer, group=run.group)
        run.timer.mark()
        # per-EPISODE game outcomes for PFSP (the reference counts actual
        # match results, chase_tag_game_env.py:412-419)
        league.report_games(opp_key, int(metrics["wins"]), int(metrics["games"]))
        run.log_publish(i, metrics, net)
        if (i + 1) % a.update_opponent_freq == 0:
            opp_key = league.sample_opponent(rng)
            sepmc.load_params(opponent, pool.pull(opp_key))
            run.log("PFSP opponent -> %s (win rate %.2f)" % (opp_key, league.win_rate(opp_key)))
        # a pool without a directory keeps its snapshots only in memory:
        # the checkpoint carries them
        kept = {} if pool.root else {k: (pool._models[k], pool._meta[k])
                                     for k in league.population}
        run.maybe_save(i, net, optimizer, env_state=env_state, obs=obs, hs=hs,
                       prev_done=prev_done, replay=replay, league=league.state(), pool=kept,
                       opp_key=opp_key, pfsp_rng=rng.bit_generator.state)
    return net, optimizer


def main(argv=None, log=print):
    """Train; returns a dict with the logged updates (metrics, ms per update
    split into collection and optimisation, env steps/s), the trained net
    and its optimizer, the pool and the league. A multi-process run joins
    its process group first and leaves it at the end."""
    args = parse_args(argv)
    distributed.initialize(coordinator=args.coordinator or None,
                           num_processes=args.num_processes or None,
                           process_id=args.process_id if args.process_id >= 0 else None,
                           backend=args.backend or None, device=args.device)
    try:
        return _train(args, log)
    finally:
        distributed.destroy()


def _train(args, log):
    run = Run(args, log)
    if run.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.dev)
    train = {"pmc": train_pmc, "epmc": train_epmc, "sepmc": train_sepmc}[args.task]
    net, optimizer = train(run)
    if args.checkpoint_dir and run.main:
        run.league.checkpoint()
    if run.main:
        log("done: %d updates" % args.total_updates)
    return dict(updates=run.history, net=net, optimizer=optimizer, pool=run.pool,
                league=run.league, cfg=run.cfg,
                max_memory_allocated=(torch.cuda.max_memory_allocated(run.dev)
                                      if run.dev.type == "cuda" else None))


if __name__ == "__main__":
    main(sys.argv[1:])

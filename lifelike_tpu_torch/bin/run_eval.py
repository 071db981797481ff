"""Policy evaluation CLI for the three levels (test_scripts parity).

Port of lifelike_tpu.bin.run_eval: load a model from a pool file or a
reference TLeague checkpoint, run episodes with the policy's mean action,
and print per-episode reward sum / length / running averages. Without a
model it runs the randomly initialized policy (smoke mode).

  * pmc: models.pmc.PMCNet on the envs.primitive tracking plant; --clip
    takes a reference-format clip file or directory, or "synthetic"
    (motion_lib.make_synthetic_clip, no data needed; the default);
  * epmc: models.epmc.EPMCNet on the envs.playground plant; the z index is
    sampled from the policy's logits; --env_config "{'hard_contact': True}"
    steps the impulse (PGS) plant, whose sweep runs on the CUDA kernel on
    the card;
  * sepmc: models.sepmc.SEPMCNet for both robots of envs.chase_tag.

  python -m lifelike_tpu_torch.bin.run_eval --task=pmc --model_path=runs/pmc_r5/pool/model_0009660.model
  python -m lifelike_tpu_torch.bin.run_eval --task=epmc --env_config="{'hard_contact': True}"
  python -m lifelike_tpu_torch.bin.run_eval --task=sepmc --max_steps=50
  python -m lifelike_tpu_torch.bin.run_eval --device=cpu --episodes=1 --max_steps=3

Each control step's policy forward and plant step are timed (CUDA events
on the card, the host clock on the CPU); --dump=PATH writes the robot
states and rewards to a .npz (utils.trajectory).
"""
import argparse
import ast
import sys
import time

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.bin.run_mpc import _save
from lifelike_tpu_torch.compat import tleague_import
from lifelike_tpu_torch.envs import factory
from lifelike_tpu_torch.learning import registry
from lifelike_tpu_torch.models import epmc, params, pmc, sepmc
from lifelike_tpu_torch.utils.trajectory import TrajectoryDump


def arg_parser(description=__doc__.split("\n")[0]):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--task", default="pmc", choices=["pmc", "epmc", "sepmc"],
                   help="which level's policy to evaluate")
    p.add_argument("--env_config", default="{}", help="env config dict literal")
    p.add_argument("--model_path", default="", help="pickled model file (empty = random init)")
    p.add_argument("--clip", default="synthetic",
                   help="mocap clip file or directory, or 'synthetic' (pmc; env_config's "
                        "data_path wins)")
    p.add_argument("--episodes", type=int, default=2, help="episodes to run")
    p.add_argument("--max_steps", type=int, default=200, help="step cap per episode")
    p.add_argument("--seed", type=int, default=0, help="generator seed")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--dump", default="", help="write eval trajectories to this .npz")
    return p


def parse_args(argv=None):
    return arg_parser().parse_args(argv)


def _load_params(path, template, tleague_importer, log):
    """Checkpoint dispatch: a ``.model`` suffix suggests a reference TLeague
    pickle, but a native ModelPool file may carry the same name — so when the
    TLeague import rejects the payload (wrong variable count / shapes /
    blocked globals), the file is read as a native ModelPool file."""
    if path.endswith(".model"):
        try:
            tree = tleague_importer(path, template)
            log("imported reference checkpoint %s" % path)
            return tree
        except Exception as e:  # not a TLeague checkpoint after all
            log("TLeague import of %s failed (%s); reading it as a ModelPool file" % (path, e))
    return registry.ModelPool().load_file("eval", path)


def _net(args, cls, load, importer, dev, log):
    """The policy of `cls` on `dev`: random init from --seed, then the
    --model_path weights when given."""
    net = cls(generator=torch.Generator().manual_seed(args.seed))
    if args.model_path:
        load(net, _load_params(args.model_path, params.flax_tree(net), importer, log))
    return net.to(dev).eval()


class StepTimer:
    """ms of each control step's policy forward and plant step: CUDA events
    on the card (read after the run), the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def split(self):
        """(forward ms, plant ms) per step, from the marks taken before the
        forward, between, and after the plant step."""
        if self.cuda:
            torch.cuda.synchronize()
            ms = lambda a, b: a.elapsed_time(b)
        else:
            ms = lambda a, b: 1e3 * (b - a)
        m = self.marks
        return ([ms(m[i], m[i + 1]) for i in range(0, len(m), 3)],
                [ms(m[i + 1], m[i + 2]) for i in range(0, len(m), 3)])


def _cast(obs, dtype):
    """The observation's fields in the policy's dtype: the tracking plant's
    future goals come out of the clip lookup in float64 (its float64 time
    offsets, as JAX's under x64) beside float32 proprioception."""
    return type(obs)(*(x.to(dtype) for x in obs))


def _setup(args):
    dev = _device.resolve_device(args.device)
    env_config = ast.literal_eval(args.env_config) if args.env_config else {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dump = TrajectoryDump(args.dump) if args.dump else None
    return dev, env_config, gen, dump, StepTimer(dev)


def _result(timer, **kw):
    fwd, plant = timer.split()
    return dict(kw, fwd_ms=fwd, step_ms=plant)


def run_pmc(args, log=print):
    dev, env_config, gen, dump, timer = _setup(args)
    env_config.setdefault("data_path", args.clip)
    bundle = factory.create_tracking_game(device=dev, **env_config)
    net = _net(args, pmc.PMCNet, pmc.load_params, tleague_import.import_pmc, dev, log)
    dtype = net.llc.embedding.dtype
    ep_rets, ep_lens, rewards, actions = [], [], [], []
    for ep in range(args.episodes):
        state, obs = bundle.reset(gen)
        ret, t = 0.0, 0
        for t in range(args.max_steps):
            timer.mark()
            with torch.no_grad():
                out = net(*_cast(obs, dtype))
            timer.mark()
            state, obs, r, done, info = bundle.step(state, out.mean)
            timer.mark()
            rewards.append(float(r))
            actions.append(float(out.mean.abs().max()))
            ret += rewards[-1]
            if dump:
                dump.add(state.robot, reward=r, episode=ep)
            if bool(done):
                break
        ep_rets.append(ret)
        ep_lens.append(t + 1)
        log("episode %d: reward_sum %.3f len %d | running avg %.3f"
            % (ep, ret, t + 1, float(np.mean(ep_rets))))
    return _result(timer, episode_rewards=ep_rets, episode_lengths=ep_lens,
                   step_rewards=rewards, max_abs_action=actions, dump=_save(dump, log))


def run_epmc(args, log=print):
    dev, env_config, gen, dump, timer = _setup(args)
    bundle = factory.create_playground_game(device=dev, **env_config)
    net = _net(args, epmc.EPMCNet, epmc.load_params, tleague_import.import_epmc, dev, log)
    mask = torch.zeros((), device=dev)
    ep_rets, ep_lens, rewards, actions, infos = [], [], [], [], []
    for ep in range(args.episodes):
        state, obs = bundle.reset(gen)
        hs = net.initial_state(())
        ret, t = 0.0, 0
        for t in range(args.max_steps):
            timer.mark()
            with torch.no_grad():
                out = net(obs, hs, mask, generator=gen)
            hs = out.hs
            timer.mark()
            state, obs, r, done, info = bundle.step(
                state, {"A_Z": out.z_idx, "A_LLC": out.mean}, gen)
            timer.mark()
            rewards.append(float(r))
            actions.append(float(out.mean.abs().max()))
            ret += rewards[-1]
            if dump:
                dump.add(state.robot, reward=r, episode=ep)
            if bool(done):
                break
        ep_rets.append(ret)
        ep_lens.append(t + 1)
        infos.append({k: float(v) for k, v in info.items()})
        log("episode %d: reward_sum %.4f len %d info %s" % (ep, ret, t + 1, infos[-1]))
    return _result(timer, episode_rewards=ep_rets, episode_lengths=ep_lens,
                   step_rewards=rewards, max_abs_action=actions, info=infos,
                   dump=_save(dump, log))


def run_sepmc(args, log=print):
    dev, env_config, gen, dump, timer = _setup(args)
    bundle = factory.create_chase_tag_game(device=dev, **env_config)
    net = _net(args, sepmc.SEPMCNet, sepmc.load_params, tleague_import.import_sepmc, dev, log)
    mask = torch.zeros(2, device=dev)
    ep_rets, ep_lens, rewards, actions, infos = [], [], [], [], []
    for ep in range(args.episodes):
        state, obs = bundle.reset(gen)
        hs = net.initial_state((2,))
        rets, t = np.zeros(2), 0
        for t in range(args.max_steps):
            timer.mark()
            with torch.no_grad():
                out = net(obs, hs, mask, generator=gen)
            hs = out.hs
            timer.mark()
            state, obs, r, done, info = bundle.step(state, {"A_LLC": out.mean}, gen)
            timer.mark()
            rewards.append(r.double().cpu().tolist())
            actions.append(float(out.mean.abs().max()))
            rets += np.asarray(rewards[-1])
            if dump:
                dump.add(state.robots, reward=r, episode=ep)
            if bool(done):
                break
        ep_rets.append(rets.tolist())
        ep_lens.append(t + 1)
        infos.append({k: v.double().cpu().tolist() for k, v in info.items()})
        log("episode %d: rewards %s len %d info %s" % (ep, rets.tolist(), t + 1, infos[-1]))
    return _result(timer, episode_rewards=ep_rets, episode_lengths=ep_lens,
                   step_rewards=rewards, max_abs_action=actions, info=infos,
                   dump=_save(dump, log))


def main(argv=None, log=print):
    args = parse_args(argv)
    run = {"pmc": run_pmc, "epmc": run_epmc, "sepmc": run_sepmc}[args.task]
    return run(args, log=log)


if __name__ == "__main__":
    main(sys.argv[1:])

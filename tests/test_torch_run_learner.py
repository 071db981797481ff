"""bin/run_learner.py of lifelike_tpu_torch and its training checkpoints, on
the CPU.

The first item trains each stage for 2 updates at 4 envs and unroll 4 —
PMC with and without --pmc_replay, EPMC on hurdles from the repo's PMC
pool checkpoint with its LLC and prop_rms frozen, SEPMC from the model the EPMC run pushed
to its pool (the stage hand-off, the MLC read from EPMC's policy tower) —
and checks that every logged loss is finite, the frozen parameters are
bitwise the donor's while every trainable one moved (or has an all-zero
gradient: a ReLU dead on the whole unroll), each pool file is
read by the JAX package's ModelPool.load_file, and run_learner raises
without --device=cpu where no card is present; and one update of
epmc_learner_step / sepmc_learner_step (collection + one update, no
replay) at 2 envs.

The second item checks that a TrainCheckpoint resume after update 1
equals the straight run exactly (PMC with the replay; SEPMC with the
league, the PFSP generator and the opponent), and reads the JAX package's
runs/pmc_r5/train.ckpt through compat.from_jax in a subprocess that
imports no JAX (its parameters equal the pickle's, array for array); one
train_step from that checkpoint's parameters and Adam state on a batch of
its own replay matches JAX's learner.train_step from the same state in
float32 (parameters and moments within 1e-6 x max(1, |x|)).
"""
import copy
import math
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lifelike_tpu.learning import learner as jlearner
from lifelike_tpu.learning import registry as jregistry
from lifelike_tpu.models import pmc as jpmc
from lifelike_tpu_torch.bin import run_learner
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import factory
from lifelike_tpu_torch.learning import learner, recurrent, registry
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import epmc, params as P, sepmc

from tests.test_torch_ppo import tree_at
from tests.torch_port_util import CPU, np_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_POOL_MODEL = "lifelike_tpu_torch/data/pmc_r5/model_0009660.model"
JAX_TRAIN_CKPT = "runs/pmc_r5/train.ckpt"
SMALL = ["--device=cpu", "--num_envs=4", "--total_updates=2", "--log_interval=1",
         "--pub_interval=1"]
UNROLL4 = "'unroll_length': 4"
REPLAY = "--learner_config={%s, 'rollout_length': 2, 'batch_windows': 4, 'num_updates': 2}" % \
    UNROLL4
EPMC_HANDOFF = "params/llc,params/prop_rms"
SEPMC_HANDOFF = ",".join(["params/llc", "params/prop_rms"] + [
    f"params/mlc_{k}=params/pi_{k}" for k in ("prop_embed", "cmd", "fc", "lstm")] +
    ["params/z_out=params/z_out"])


def learn(task, *flags, lines=None):
    log = (lambda m: None) if lines is None else lines.append
    out = run_learner.main([f"--task={task}", *SMALL, *flags], log=log)
    assert [u["update"] for u in out["updates"]] == [0, 1]
    for u in out["updates"]:
        assert all(math.isfinite(v) for v in u["metrics"].values()), u
        assert u["collect_ms"] > 0 and u["optimize_ms"] > 0 and u["env_steps_per_s"] > 0
    return out


def _check_frozen(out, donor, handoff, init):
    """Frozen parameters equal the donor's subtrees bit for bit; every
    trainable parameter moved from its initial value, unless its gradient
    is exactly zero (a ReLU dead on every input of the unroll)."""
    net, trainable = out["net"], set(out["optimizer"].names)
    pairs = run_learner.subtree_paths(handoff)
    frozen = moved = 0
    for k, p in net.named_parameters():
        path = P.flax_path(k, p)
        if k in trainable:
            if torch.equal(p, init[k]):
                assert p.grad is None or not bool(p.grad.any()), f"{k} did not move"
            else:
                moved += 1
            continue
        dst, src = next((d, s) for d, s in (
            (e, e) if isinstance(e[0], str) else e for e in pairs) if path[:len(d)] == d)
        want = P.to_torch_layout(path, tree_at(donor, src + path[len(dst):]))
        assert torch.equal(p, want.to(p.dtype)), k
        frozen += 1
    assert frozen and moved > 0.8 * len(trainable)


def _check_pool_files(pool_dir):
    port = registry.ModelPool(pool_dir)
    files = sorted(os.listdir(pool_dir))
    assert files
    for f in files:
        want = port.load(f[:-len(".model")])
        got = jregistry.ModelPool().load_file("k", os.path.join(pool_dir, f))
        for path, leaf in P._flatten(want):
            np.testing.assert_array_equal(tree_at(got, path), leaf)


def _check_single_update_steps():
    """The one-update-per-unroll recurrent steps (no replay, no burn-in),
    which run_learner does not call: finite metrics, the unroll's games."""
    cfg = learner.PPOConfig(unroll_length=2)
    gen = torch.Generator().manual_seed(0)
    bundle = factory.create_playground_game(device=CPU)
    net = epmc.EPMCNet(generator=torch.Generator().manual_seed(1))
    state, obs = bundle.reset(gen, batch=(2,))
    *_, m = recurrent.epmc_learner_step(net, bundle, cfg, learner.make_optimizer(cfg, net),
                                        state, obs, net.initial_state((2,)),
                                        torch.zeros(2, dtype=torch.bool), gen)
    assert all(math.isfinite(float(v)) for v in m.values()), m
    bundle = factory.create_chase_tag_game(device=CPU)
    net = sepmc.SEPMCNet(generator=torch.Generator().manual_seed(2))
    state, obs = bundle.reset(gen, batch=(2,))
    *_, m = recurrent.sepmc_learner_step(net, bundle, cfg, learner.make_optimizer(cfg, net),
                                         copy.deepcopy(net), state, obs,
                                         net.initial_state((2, 2)),
                                         torch.zeros(2, dtype=torch.bool), gen)
    assert all(math.isfinite(float(v)) for v in m.values()) and {"games", "wins"} <= set(m)


def _check_update_lines_parse(lines, tmp_path):
    """The port's `update N:` lines list their metrics sorted, as the
    reference's jitted step returns them, so both packages' pmc_curve
    parsers read them."""
    from lifelike_tpu_torch.tools import pmc_curve
    from tests.test_torch_tools import reference_pmc_curve

    log = tmp_path / "train.log"
    log.write_text("\n".join(lines) + "\n")
    rows = pmc_curve.parse_log(str(log))
    assert [r[0] for r in rows] == [0, 1], lines
    assert reference_pmc_curve().parse_log(str(log)) == rows
    for ln in lines:
        if ln.startswith("update "):
            keys = ln.split("{", 1)[1].split("}", 1)[0].split(", ")
            names = [k.split(":")[0] for k in keys]
            assert names == sorted(names), ln


def test_run_learner_cpu_stages(tmp_path):
    _check_single_update_steps()
    lines = []
    learn("pmc", f"--learner_config={{{UNROLL4}}}", lines=lines)
    _check_update_lines_parse(lines, tmp_path)
    learn("pmc", "--pmc_replay", REPLAY)
    seeded = lambda cls: {k: p.detach().clone() for k, p in cls(
        generator=torch.Generator().manual_seed(0)).named_parameters()}
    epmc_pool = str(tmp_path / "pool_epmc")
    # on hurdles: the flat arena's height maps are all zeros, which leaves
    # the first height-map convolutions without a gradient
    out = learn("epmc", f"--learner_config={{{UNROLL4}}}", f"--init_model={PORT_POOL_MODEL}",
                "--env_config={'env_randomize_config': {'element_id': 1}}",
                f"--init_model_subtree={EPMC_HANDOFF}", f"--model_pool_dir={epmc_pool}")
    donor = registry.ModelPool().load_file("d", PORT_POOL_MODEL)
    _check_frozen(out, donor, EPMC_HANDOFF, seeded(epmc.EPMCNet))
    _check_pool_files(epmc_pool)

    handoff = os.path.join(epmc_pool, "model_0000001.model")  # what the EPMC run pushed last
    sepmc_pool = str(tmp_path / "pool_sepmc")
    out = learn("sepmc", f"--learner_config={{{UNROLL4}}}", f"--init_model={handoff}",
                f"--init_model_subtree={SEPMC_HANDOFF}", f"--model_pool_dir={sepmc_pool}",
                "--update_opponent_freq=1", f"--checkpoint_dir={tmp_path / 'league'}")
    _check_frozen(out, registry.ModelPool().load_file("d", handoff), SEPMC_HANDOFF,
                  seeded(sepmc.SEPMCNet))
    _check_pool_files(sepmc_pool)
    assert out["league"].population == ["model_0000000", "model_0000001"]
    back = jregistry.LeagueManager(jregistry.ModelPool(), checkpoint_dir=str(tmp_path / "league"))
    assert back.restore() and back.population == out["league"].population

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_learner.main(["--task=pmc", "--total_updates=1"], log=lambda m: None)


def _check_resume(tmp_path, task, *flags):
    straight = learn(task, f"--train_checkpoint={tmp_path / (task + '_a.ckpt')}",
                     "--save_interval=1", *flags)
    ckpt = f"--train_checkpoint={tmp_path / (task + '_b.ckpt')}"
    first = run_learner.main([f"--task={task}", *SMALL, "--total_updates=1", ckpt,
                              "--save_interval=1", *flags], log=lambda m: None)
    assert [u["update"] for u in first["updates"]] == [0]
    resumed = run_learner.main([f"--task={task}", *SMALL, ckpt, "--save_interval=1", *flags],
                               log=lambda m: None)
    assert [u["update"] for u in resumed["updates"]] == [1]
    assert resumed["updates"][0]["metrics"] == straight["updates"][1]["metrics"], task
    for (k, a), (_, b) in zip(straight["net"].named_parameters(),
                              resumed["net"].named_parameters()):
        assert torch.equal(a, b), (task, k)
    sa, sb = straight["optimizer"].state_dict(), resumed["optimizer"].state_dict()
    assert sa["step"] == sb["step"] > 1
    assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"],
                                                                      sb["exp_avg_sq"])
    return straight, resumed


CHILD = r"""
import sys
import numpy as np
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.models import params as P
ck = from_jax.read_train_checkpoint(sys.argv[1])
net = from_jax.pmc_params(ck["trees"]["params"], device="cpu")
np.savez(sys.argv[2], step=ck["step"], **{"/".join(k): v for k, v in P._flatten(P.flax_tree(net))})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "lifelike_tpu"))
assert not bad, bad
"""


def _check_jax_checkpoint(tmp_path):
    """The JAX package's TrainCheckpoint read without JAX, then one float32
    train step from its state against JAX's. Every JAX NamedTuple the
    reader maps onto a port class has that class's fields, in order."""
    import importlib

    for (module, name), cls in from_jax._CHECKPOINT_CLASSES.items():
        if module.startswith("lifelike_tpu."):
            assert getattr(importlib.import_module(module), name)._fields == cls._fields, name
    out = tmp_path / "params.npz"
    proc = subprocess.run([sys.executable, "-c", CHILD, JAX_TRAIN_CKPT, str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(REPO, JAX_TRAIN_CKPT), "rb") as f:
        ck = pickle.load(f)  # the JAX package's own classes
    trees = ck["trees"]
    got = np.load(out)
    assert int(got["step"]) == ck["step"]
    leaves = list(P._flatten(trees["params"]))
    assert len(got.files) == len(leaves) + 1
    for path, leaf in leaves:
        a = got["/".join(path)]
        assert a.dtype == leaf.dtype and np.array_equal(a, leaf), path

    # one train step on 4 windows of the checkpoint's own replay
    idx = np.arange(4)
    jbatch = jax.tree.map(lambda x: np.swapaxes(np.asarray(x)[idx], 0, 1), trees["replay"].data)
    jnet = jpmc.PMCNet(jpmc.PMCConfig())
    lcfg = jlearner.PPOConfig()
    tx = jlearner.make_optimizer(lcfg)
    jparams, jstate, _ = jax.jit(lambda p, s, b: jlearner.train_step(jnet, tx, lcfg, p, s, b))(
        trees["params"], trees["opt_state"], jlearner.Rollout(*jbatch))
    # the subprocess read the file without JAX; the same arrays are used here
    net = from_jax.pmc_params(trees["params"], device=CPU, dtype=torch.float32)
    opt = from_jax.adam_state(trees["opt_state"], learner.make_optimizer(learner.PPOConfig(), net))
    assert opt.step_count == int(trees["opt_state"][1][0].count)
    replay = from_jax.replay_buffer(trees["replay"], device=CPU)
    batch = rp.as_time_major(rp.replay_sample(replay, None, 4, idx=torch.as_tensor(idx)))
    learner.train_step(net, opt, learner.PPOConfig(), batch)

    def within(got, want, label):
        got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= 1e-6, (label, float(err.max()))

    adam = from_jax._find_adam(jstate)
    for k, p, m, v in zip(opt.names, opt.params, opt.views(opt.exp_avg),
                          opt.views(opt.exp_avg_sq)):
        path = P.flax_path(k, p)
        within(p, P.to_torch_layout(path, tree_at(jparams, path)), k)
        within(m, P.to_torch_layout(path, tree_at(adam.mu, path)), "mu " + k)
        within(v, P.to_torch_layout(path, tree_at(adam.nu, path)), "nu " + k)
    assert opt.step_count == int(adam.count)


def test_train_checkpoint_resume_and_jax_checkpoint(tmp_path):
    _check_resume(tmp_path, "pmc", "--pmc_replay", REPLAY)
    _, resumed = _check_resume(tmp_path, "sepmc", f"--learner_config={{{UNROLL4}}}",
                               "--update_opponent_freq=1")
    assert resumed["league"].population == ["model_0000000", "model_0000001"]
    _check_jax_checkpoint(tmp_path)

"""bin/run_eval.py of lifelike_tpu_torch, the port's ModelPool files and
entry(), on the CPU.

The first item runs run_eval --device=cpu for the three levels at 3 steps:
PMC with the repo's trained pool checkpoint on the synthetic clip, EPMC on
the hard-contact plant, SEPMC from a random init; every action and reward
is finite, and the --dump file holds each step's robot state and reward.

The second item holds the pool file format to the JAX package's (a file
the port writes is read by lifelike_tpu.learning.registry.ModelPool and
the other way round), checks that run_eval raises without a card unless
--device=cpu is given, and runs entry() on the CPU.
"""
import numpy as np
import pytest
import torch

from lifelike_tpu.learning import registry as jregistry
from lifelike_tpu_torch import entry
from lifelike_tpu_torch.bin import run_eval
from lifelike_tpu_torch.learning import registry
from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models import pmc
from lifelike_tpu_torch.utils import trajectory

from tests.torch_port_util import CPU

PORT_POOL_MODEL = "lifelike_tpu_torch/data/pmc_r5/model_0009660.model"
STEPS = 3


def _run(task, tmp_path, *flags):
    dump = tmp_path / f"{task}.npz"
    out = run_eval.main([f"--task={task}", "--device=cpu", "--episodes=1",
                         f"--max_steps={STEPS}", f"--dump={dump}", *flags], log=lambda m: None)
    n = sum(out["episode_lengths"])
    assert 1 <= n <= STEPS and len(out["step_rewards"]) == n
    assert np.isfinite(out["step_rewards"]).all() and np.isfinite(out["max_abs_action"]).all()
    assert len(out["fwd_ms"]) == len(out["step_ms"]) == n
    d = trajectory.load(out["dump"])
    assert d["base_pos"].shape[0] == n
    np.testing.assert_array_equal(d["reward"], np.asarray(out["step_rewards"], np.float32))
    return out


def test_run_eval_cpu_levels(tmp_path):
    out = _run("pmc", tmp_path, f"--model_path={PORT_POOL_MODEL}")
    # the trained policy tracks the synthetic clip: no fall in 3 steps
    assert sum(out["episode_lengths"]) == STEPS and min(out["step_rewards"]) > 0.0
    _run("epmc", tmp_path, "--env_config={'hard_contact': True}")
    out = _run("sepmc", tmp_path)
    assert np.asarray(out["step_rewards"]).shape[1:] == (2,)


def test_pool_files_entry_and_device(tmp_path):
    # the port writes, JAX reads
    net = pmc.PMCNet(generator=torch.Generator().manual_seed(3))
    pool = registry.ModelPool(str(tmp_path / "port"))
    tree = P.flax_tree(net)
    pool.push("m", tree, meta={"update": 1}, persist=True)
    got = jregistry.ModelPool(str(tmp_path / "port")).load("m")
    for k, v in P._flatten(tree):
        node = got
        for part in k:
            node = node[part]
        np.testing.assert_array_equal(node, v)
    # JAX writes, the port reads (a snapshot of the trained checkpoint)
    jpool = jregistry.ModelPool(str(tmp_path / "jax"))
    jpool.push("j", jregistry.ModelPool().load_file("src", PORT_POOL_MODEL), meta={"update": 2},
               persist=True)
    back = registry.ModelPool(str(tmp_path / "jax"))
    loaded = pmc.load_params(pmc.PMCNet(), back.pull("j"))
    assert back._meta["j"]["update"] == 2
    np.testing.assert_array_equal(P.flax_tree(loaded)["params"]["llc"]["embedding"],
                                  jpool.pull("j")["params"]["llc"]["embedding"])

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_eval.main(["--task=pmc", "--max_steps=1", "--episodes=1"], log=lambda m: None)
        with pytest.raises(RuntimeError, match="cuda"):
            entry.entry()
    fn, args = entry.entry(device=CPU)
    mean, value = fn(*args)
    assert mean.shape == (8, 12) and value.shape == (8, 1)
    assert torch.isfinite(mean).all() and torch.isfinite(value).all()

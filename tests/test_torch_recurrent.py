"""Recurrent PPO of lifelike_tpu_torch (learning/recurrent.py) vs the JAX
reference, on the CPU, in float64 at 1e-9.

The first item replays a seeded EPMC unroll (T 4, B 3, small widths, the
canonical 25 x 13 height maps) with burn_in 1, a mask reset on env 0 at
step 2 and the sampled codebook indices injected: epmc_loss_fn's loss and
metrics, then two epmc_train_step updates (gradients, metrics, parameters
and Adam moments), against JAX's (one traced train step, scanned twice).

The second item does the same for sepmc_loss_fn / one update with the
frozen LLC and MLC subtrees of train_scripts/sepmc_train.sh (optax
multi_transform in JAX, left out of the port's optimizer: bitwise
unchanged), holds _stage_windows / windows_overlapping and _game_outcomes
to JAX's exactly, and checks the port's _agent_obs slices the agent axis of
every Chase Tag leaf (the height maps included).
"""
from collections import namedtuple

import jax
import numpy as np
import optax
import torch

from lifelike_tpu.learning import freeze as jfreeze
from lifelike_tpu.learning import learner as jlearner
from lifelike_tpu.learning import recurrent as jrec
from lifelike_tpu.models import epmc as jepmc
from lifelike_tpu.models import sepmc as jsepmc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs.chase_tag import ChaseTagObs
from lifelike_tpu_torch.learning import learner, recurrent
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import epmc, layers, sepmc

from tests.test_torch_models import chase_obs, layout, playground_obs, seeded_tree
from tests.test_torch_ppo import (assert_grads_close, assert_metrics_close,
                                  assert_moments_close, assert_params_close, tree_at)
from tests.torch_port_util import CPU, F64, np_of

SMALL = dict(z_len=16, z_len_llc=8, nlstm=8, hs_slice=16, embed_dim=16,
             bot_neck_prop_embed_size=8, bot_neck_z_embed_size=8)
T, B, BURN_IN = 4, 3, 1
LCFG = jlearner.PPOConfig(learning_rate=3e-3, max_grad_norm=0.5)
SEPMC_FROZEN = [("params", k) for k in ("llc", "mlc_prop_embed", "mlc_cmd", "mlc_fc", "mlc_lstm")]


def stack_obs(make, rng):
    steps = [make(rng, B) for _ in range(T)]
    return {k: np.stack([s[k] for s in steps]) for k in steps[0]}


def seeded_roll(rng, obs, hs_len, hlc):
    mask = np.zeros((T, B))
    mask[2, 0] = 1.0  # env 0's episode restarts at step 2
    done = np.zeros((T, B), bool)
    done[1, 0] = done[3, 2] = True
    return dict(obs=obs, a_z=rng.integers(0, SMALL["z_len"], (T, B)),
                a_llc=rng.standard_normal((T, B, 12)),
                a_hlc=rng.uniform(-3.0, 3.0, (T, B, 1)) if hlc else np.zeros((T, B, 1)),
                neglogp=np.zeros((T, B)), reward=rng.uniform(-1, 1, (T, B)),
                discount=0.95 * (1.0 - done), mask=mask,
                hs=0.5 * rng.standard_normal((T, B, hs_len)))


def port_roll(roll):
    return recurrent.RecurrentRollout(**rp.tree_map(torch.as_tensor, roll))


def behaviour_neglogp(net, roll, rng, sepmc_heads):
    """The current policy's neglogp of the injected actions (the port's
    forward, held to JAX's by tests/test_torch_models.py) plus noise: the
    behaviour policy of the unroll, so the ratios sit around the clip."""
    r = port_roll(roll)
    hs, out = r.hs[0], []
    with torch.no_grad():
        for t in range(T):
            obs = {k: v[t] for k, v in r.obs.items()}
            if sepmc_heads:
                o = net(obs, hs, r.mask[t], a_hlc=r.a_hlc[t], a_z=r.a_z[t])
                nlp = layers.gaussian_neglogp(o.hlc_mean, o.hlc_logstd, r.a_hlc[t])
            else:
                o = net(obs, hs, r.mask[t], z_idx=r.a_z[t])
                nlp = 0.0
            nlp = nlp + (layers.categorical_neglogp(o.z_logits, r.a_z[t])
                         + layers.gaussian_neglogp(o.mean, o.logstd, r.a_llc[t]))
            out.append(np_of(nlp))
            hs = o.hs
    return np.stack(out) + 0.1 * rng.standard_normal((T, B))


def test_epmc_loss_and_train_step():
    rng = np.random.default_rng(0)
    jcfg = jepmc.EPMCConfig(**SMALL)
    jnet = jepmc.EPMCNet(jcfg)
    obs = stack_obs(playground_obs, rng)
    roll = seeded_roll(rng, obs, jcfg.hs_len, hlc=False)
    params = seeded_tree(layout(jnet, {k: v[0] for k, v in obs.items()}, roll["hs"][0],
                                roll["mask"][0], roll["a_z"][0]), rng, np.float64)
    net = from_jax.epmc_params(params, epmc.EPMCConfig(**SMALL), device=CPU, dtype=F64)
    roll["neglogp"] = behaviour_neglogp(net, roll, rng, sepmc_heads=False)
    # no clip here (PMC's and SEPMC's checks clip): step 1's first moment is
    # then (1 - b1) x the gradient, so one traced train step pins the gradients
    lcfg = LCFG._replace(max_grad_norm=1e9)
    tx = jlearner.make_optimizer(lcfg)
    jroll = jrec.RecurrentRollout(**roll)

    @jax.jit
    def ref(p):
        def train(c, _):  # one compiled body for both steps
            p, st = c
            p, st, m = jrec.epmc_train_step(jnet, tx, lcfg, p, st, jroll, burn_in=BURN_IN)
            return (p, st), (p, st, m)

        return jax.lax.scan(train, (p, tx.init(p)), None, length=2)[1]

    stacked = jax.tree.map(np.asarray, ref(params))
    jsteps = [jax.tree.map(lambda x: x[n], stacked) for n in range(2)]
    cfg = learner.PPOConfig(*lcfg)
    troll = port_roll(roll)
    loss, metrics = recurrent.epmc_loss_fn(net, cfg, troll, burn_in=BURN_IN)
    assert_metrics_close(dict(metrics, loss=loss), jsteps[0][2], 1e-9, 1e-9, "epmc_loss_fn")
    opt = learner.make_optimizer(cfg, net)
    for n, (jp, jst, jm) in enumerate(jsteps):
        m = recurrent.epmc_train_step(net, opt, cfg, troll, burn_in=BURN_IN)
        label = f"epmc_train_step {n}"
        if n == 0:
            mu = from_jax._find_adam(jst).mu
            assert_grads_close(opt, jax.tree.map(lambda x: x / 0.1, mu), 1e-9, 1e-9, label)
        assert_metrics_close(m, jm, 1e-9, 1e-9, label)
        assert_params_close(net, jp, 1e-9, 1e-9, label)
        assert_moments_close(opt, jst, 1e-9, 1e-9, label)


def _check_sepmc(rng):
    jcfg = jsepmc.SEPMCConfig(epmc=jepmc.EPMCConfig(**SMALL))
    jnet = jsepmc.SEPMCNet(jcfg)
    obs = stack_obs(chase_obs, rng)
    roll = seeded_roll(rng, obs, jcfg.hs_len, hlc=True)
    params = seeded_tree(layout(jnet, {k: v[0] for k, v in obs.items()}, roll["hs"][0],
                                roll["mask"][0], roll["a_hlc"][0], roll["a_z"][0]), rng,
                         np.float64)
    cfg_port = sepmc.SEPMCConfig(epmc=epmc.EPMCConfig(**SMALL))
    net = from_jax.sepmc_params(params, cfg_port, device=CPU, dtype=F64)
    roll["neglogp"] = behaviour_neglogp(net, roll, rng, sepmc_heads=True)
    tx = jfreeze.frozen_optimizer(jlearner.make_optimizer(LCFG), params, SEPMC_FROZEN)
    jobs = namedtuple("ChaseObs", sorted(obs))(**obs)  # JAX's loss reads the fields by name
    jroll = jrec.RecurrentRollout(**dict(roll, obs=jobs))

    @jax.jit
    def ref(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jrec.sepmc_loss_fn(jnet, LCFG, q, jroll, burn_in=BURN_IN), has_aux=True)(p)
        st = tx.init(p)
        u, st = tx.update(grads, st, p)
        return loss, metrics, grads, optax.apply_updates(p, u), st

    jloss, jmetrics, jgrads, jp, jst = jax.tree.map(np.asarray, ref(params))
    cfg = learner.PPOConfig(*LCFG)
    opt = learner.make_optimizer(cfg, net, frozen=SEPMC_FROZEN)
    m = recurrent.sepmc_train_step(net, opt, cfg, port_roll(roll), burn_in=BURN_IN)
    label = "sepmc_train_step, LLC + MLC frozen"
    assert_metrics_close(m, dict(jmetrics, loss=jloss), 1e-9, 1e-9, label)
    assert_grads_close(opt, jgrads, 1e-9, 1e-9, label)
    assert_params_close(net, jp, 1e-9, 1e-9, label)
    assert_moments_close(opt, jst, 1e-9, 1e-9, label)
    trainable = set(opt.names)
    frozen = [k for k, _ in net.named_parameters() if k not in trainable]
    assert frozen and all(k.split(".")[0] in {k for _, k in SEPMC_FROZEN} for k in frozen)
    for k, p in net.named_parameters():
        if k not in trainable:
            path = from_jax.P.flax_path(k, p)
            want = from_jax.P.to_torch_layout(path, tree_at(params, path))
            assert not p.requires_grad and np.array_equal(np_of(p), np_of(want)), k
    return roll


def _check_windows_and_outcomes(rng, roll):
    cfg = LCFG._replace(unroll_length=T, burn_in=2, rollout_length=1)
    def same(got, want):
        for f in recurrent.RecurrentRollout._fields:
            g, w = getattr(got, f), getattr(want, f)
            for k in (sorted(w) if f == "obs" else [None]):
                np.testing.assert_array_equal(np_of(g if k is None else g[k]),
                                              np.asarray(w if k is None else w[k]), err_msg=f)

    same(recurrent._stage_windows(learner.PPOConfig(*cfg), port_roll(roll)),
         jrec._stage_windows(cfg, jrec.RecurrentRollout(**roll)))
    for window, stride in ((2, 2), (3, 1)):
        same(rp.windows_overlapping(port_roll(roll), window, stride),
             jrec.rp.windows_overlapping(jrec.RecurrentRollout(**roll), window, stride))
    # game outcomes: ends with a win, a loss and a draw
    ends = dict(roll, discount=np.where(rng.uniform(size=(T, B)) < 0.5, 0.0, 0.95),
                reward=rng.choice([-1.0, 0.0, 1.0], (T, B)))
    got = recurrent._game_outcomes(port_roll(ends))
    want = jrec._game_outcomes(jrec.RecurrentRollout(**ends))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    # _agent_obs: agent i of every leaf, the (..., 2, 25, 13) height maps included
    shapes = dict(prop=(99,), prop_a=(36,), percept_2d=(25, 13), percept_1d=(128,),
                  percept_front=(25, 13), percept_vec=(5,), oppo_info=(15,),
                  oppo_info_cheat=(15,), flag_info=(7,), flag_info_cheat=(7,), with_flag=(2,),
                  control_spd=(1,))
    full = {k: rng.standard_normal((B, 2) + s) for k, s in shapes.items()}
    for i in (0, 1):
        one = recurrent._agent_obs(ChaseTagObs(**rp.tree_map(torch.as_tensor, full)), i)
        for k, s in shapes.items():
            np.testing.assert_array_equal(np_of(getattr(one, k)), full[k][:, i])


def test_sepmc_frozen_windows_outcomes():
    rng = np.random.default_rng(1)
    roll = _check_sepmc(rng)
    _check_windows_and_outcomes(rng, roll)

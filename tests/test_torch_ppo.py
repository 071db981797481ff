"""The PPO learner stack of lifelike_tpu_torch (learning/{ppo,replay,learner,
freeze,registry}.py, models/pmc.restart_dead_codes) vs the JAX reference,
on the CPU.

The first item holds the losses and lambda_return (values and the
gradients of the loss terms) to JAX's in float64 at 1e-12; the replay
(windows, circular writes, sampling with JAX's indices injected) exactly;
LeagueManager's PFSP sequence from the same numpy Generator identically,
with a checkpoint / restore round trip read by either package; and the
optimizer (ClipAdam: optax's clip_by_global_norm + adam, written out)
against optax at 1e-12 over steps whose gradient norm is above and below
max_norm, with and without a frozen subtree (optax multi_transform).

The second item runs the PMC train_step twice from JAX-initialised
parameters (jax.jit of PMCNet.init, carried over by compat.from_jax) on a
seeded rollout and holds the loss, metrics, gradients, parameters and Adam
moments to JAX's learner.train_step in float64 at 1e-9; and
restart_dead_codes to JAX's for the same generator, exactly.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lifelike_tpu.learning import freeze as jfreeze
from lifelike_tpu.learning import learner as jlearner
from lifelike_tpu.learning import ppo as jppo
from lifelike_tpu.learning import registry as jregistry
from lifelike_tpu.learning import replay as jrp
from lifelike_tpu.models import pmc as jpmc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.learning import learner, ppo, registry
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models import pmc

from tests.torch_port_util import CPU, F64, np_of

SMALL_PMC = dict(z_len=8, num_embeddings=16, embed_dim=32, bot_neck_prop_embed_size=8,
                 bot_neck_z_embed_size=8)


def tree_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_params_close(net, tree, rtol, atol, label, names=None):
    """Each parameter of `net` (or of `names`) against the Flax-layout
    `tree` leaf at its path."""
    for k, p in net.named_parameters():
        if names is not None and k not in names:
            continue
        path = P.flax_path(k, p)
        want = P.to_torch_layout(path, tree_at(tree, path))
        np.testing.assert_allclose(np_of(p), np_of(want), rtol=rtol, atol=atol,
                                   err_msg=f"{label}: {k}")


def assert_grads_close(optimizer, grads, rtol, atol, label):
    for k, p in zip(optimizer.names, optimizer.params):
        path = P.flax_path(k, p)
        want = P.to_torch_layout(path, tree_at(grads, path))
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                                   err_msg=f"{label}: grad {k}")


def assert_moments_close(optimizer, opt_state, rtol, atol, label):
    adam = from_jax._find_adam(opt_state)
    assert optimizer.step_count == int(adam.count), label
    for flat, tree, name in ((optimizer.exp_avg, adam.mu, "mu"),
                             (optimizer.exp_avg_sq, adam.nu, "nu")):
        for k, p, got in zip(optimizer.names, optimizer.params, optimizer.views(flat)):
            path = P.flax_path(k, p)
            want = P.to_torch_layout(path, tree_at(tree, path))
            np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                                       err_msg=f"{label}: {name} {k}")


def assert_metrics_close(got, want, rtol, atol, label):
    for k, v in want.items():
        np.testing.assert_allclose(float(torch.as_tensor(got[k]).detach()), float(v), rtol=rtol,
                                   atol=atol, err_msg=f"{label}: {k}")


def _check_losses(rng):
    T, B = 7, 5
    a = {k: rng.standard_normal((T, B)) for k in ("neglogp", "old", "vpred", "reward")}
    a["old"] = a["neglogp"] + 0.2 * rng.standard_normal((T, B))  # ratios both sides of the clip
    a["discount"] = 0.95 * (rng.uniform(size=(T, B)) > 0.2)
    a["mask"] = (rng.uniform(size=(T, B)) > 0.3).astype(np.float64)
    R, V = rng.standard_normal((T, B, 2)), rng.standard_normal((T, B, 2))
    vp2 = rng.standard_normal((T, B, 2))
    t = {k: torch.tensor(v, requires_grad=k in ("neglogp", "vpred")) for k, v in a.items()}

    def jterms(neglogp, vpred):
        pg, vl, ret = jppo.ppo2_loss(neglogp, a["old"], vpred, a["reward"], a["discount"],
                                     lam=0.9, clip_range=0.2, clip_range_lower=0.1,
                                     mask=a["mask"])
        pg1, vl1 = jppo.ppo_loss(neglogp, a["old"], vp2, R, V, 0.2, 0.1)
        return pg + vl + pg1 + vl1, (pg, vl, ret, pg1, vl1)

    @jax.jit
    def ref(neglogp, vpred):
        (_, terms), grads = jax.value_and_grad(jterms, argnums=(0, 1), has_aux=True)(neglogp,
                                                                                     vpred)
        G = jppo.lambda_return(a["reward"], a["discount"], vpred, 0.9)
        return terms, grads, G, jppo._normalize_adv(vpred)

    jt, jg, jG, jadv = ref(a["neglogp"], a["vpred"])
    pg, vl, ret = ppo.ppo2_loss(t["neglogp"], t["old"], t["vpred"], t["reward"], t["discount"],
                                lam=0.9, clip_range=0.2, clip_range_lower=0.1, mask=t["mask"])
    pg1, vl1 = ppo.ppo_loss(t["neglogp"], t["old"], torch.tensor(vp2), torch.tensor(R),
                            torch.tensor(V), 0.2, 0.1)
    (pg + vl + pg1 + vl1).backward()
    for got, want, name in zip((pg, vl, ret, pg1, vl1), jt, ("pg", "value", "return", "ppo pg",
                                                            "ppo value")):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    for got, want, name in ((t["neglogp"].grad, jg[0], "d/dneglogp"),
                            (t["vpred"].grad, jg[1], "d/dvpred"),
                            (ppo.lambda_return(t["reward"], t["discount"], t["vpred"], 0.9), jG,
                             "lambda_return"),
                            (ppo._normalize_adv(t["vpred"]), jadv, "_normalize_adv")):
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def _check_replay(rng):
    T, B = 8, 3
    unrolls = [{"x": rng.standard_normal((T, B, 4)), "r": rng.standard_normal((T, B)),
                "i": rng.integers(0, 9, (T, B))} for _ in range(2)]
    jrep = jrp.replay_init({"x": jnp.zeros((4, 4)), "r": jnp.zeros(4),
                            "i": jnp.zeros(4, jnp.int64)}, size=8)
    rep = rp.replay_init({"x": torch.zeros(4, 4, dtype=F64), "r": torch.zeros(4, dtype=F64),
                          "i": torch.zeros(4, dtype=torch.int64)}, size=8)
    for n, u in enumerate(unrolls):  # the second write wraps around the ring
        jw = jrp.windows_from_unroll(u, 4)
        w = rp.windows_from_unroll(rp.tree_map(torch.as_tensor, u), 4)
        for k in u:
            np.testing.assert_array_equal(np_of(w[k]), np.asarray(jw[k]))
        jrep, rep = jrp.replay_add(jrep, jw), rp.replay_add(rep, w)
        assert (rep.cursor, rep.filled) == (int(jrep.cursor), int(jrep.filled)), n
        for k in u:
            np.testing.assert_array_equal(np_of(rep.data[k]), np.asarray(jrep.data[k]))
        key = jax.random.PRNGKey(n)
        jb = jrp.as_time_major(jrp.replay_sample(jrep, key, 5))
        idx = jax.random.randint(key, (5,), 0, jnp.maximum(jrep.filled, 1))  # replay_sample's
        b = rp.as_time_major(rp.replay_sample(rep, None, 5, idx=torch.as_tensor(np.array(idx))))
        for k in u:
            np.testing.assert_array_equal(np_of(b[k]), np.asarray(jb[k]))
    ov = rp.windows_overlapping(rp.tree_map(torch.as_tensor, unrolls[0]), 5, 3)
    jov = jrp.windows_overlapping(unrolls[0], 5, 3)
    for k in ov:
        np.testing.assert_array_equal(np_of(ov[k]), np.asarray(jov[k]))


def _check_league(tmp_path):
    leagues = []
    for pkg, d in ((registry, "port"), (jregistry, "jax")):
        pool = pkg.ModelPool(root=str(tmp_path / d))
        lm = pkg.LeagueManager(pool, game_mgr_type="pfsp", pfsp_power=2.0,
                               checkpoint_dir=str(tmp_path / d))
        for k in ("g0", "g1", "g2", "g3"):
            pool.push(k, {"w": np.full(2, float(len(k)))})
            lm.add_to_population(k)
        lm.report_games("g0", 9, 10)
        lm.report_games("g2", 1, 8)
        lm.report_outcome("g3", True)
        lm.report_outcome("g3", False)
        rng = np.random.default_rng(5)
        leagues.append((lm, [lm.sample_opponent(rng) for _ in range(200)]))
        lm.checkpoint()
    (port, seq), (jax_lm, jseq) = leagues
    assert seq == jseq and seq.count("g2") > seq.count("g0")
    assert [port.win_rate(k) for k in port.population] == \
        [jax_lm.win_rate(k) for k in jax_lm.population]
    # a league file of either package restores in the other
    for pkg, d in ((registry, "jax"), (jregistry, "port")):
        back = pkg.LeagueManager(pkg.ModelPool(), checkpoint_dir=str(tmp_path / d))
        assert back.restore()
        assert (back.population, back.wins, back.games) == (port.population, port.wins,
                                                            port.games)
    self_play = registry.LeagueManager(registry.ModelPool())
    self_play.add_to_population("a")
    self_play.add_to_population("b")
    assert self_play.sample_opponent(np.random.default_rng(0)) == "b"


def _check_optimizer(rng, tmp_path):
    """ClipAdam vs optax.chain(clip_by_global_norm, adam): 4 steps whose
    gradient norms are about 3, 0.1, 2 and 0.3 x max_norm, all parameters
    trainable and with the LLC frozen; then optax's final state pickled as
    a JAX TrainCheckpoint holds it, read back without optax
    (from_jax.read_train_checkpoint + adam_state), equals the port's."""
    cfg = learner.PPOConfig(learning_rate=1e-2, max_grad_norm=0.5)
    net = pmc.PMCNet(pmc.PMCConfig(**SMALL_PMC), generator=torch.Generator().manual_seed(1))
    net = net.double()
    tree = P.flax_tree(net)
    raw = [jax.tree.map(lambda x: rng.standard_normal(x.shape), tree) for _ in range(4)]
    frozen = [("params", "llc")]
    for prefixes in ((), frozen):
        tx = jlearner.make_optimizer(jlearner.PPOConfig(*cfg))
        if prefixes:
            tx = jfreeze.frozen_optimizer(tx, tree, prefixes)
        trainable = lambda path: not any(tuple(path[:len(p)]) == p for p in prefixes)

        def scaled(g, target):
            flat = jax.tree_util.tree_flatten_with_path(g)[0]
            sq = sum(float(np.sum(x ** 2)) for path, x in flat
                     if trainable(tuple(p.key for p in path)))
            return jax.tree.map(lambda x: x * (target / np.sqrt(sq)), g)

        grads = [scaled(g, s * cfg.max_grad_norm) for g, s in zip(raw, (3.0, 0.1, 2.0, 0.3))]

        @jax.jit
        def ref(params, grads):
            st = tx.init(params)
            out = []
            for g in grads:
                u, st = tx.update(g, st, params)
                params = optax.apply_updates(params, u)
                out.append((params, st))
            return out

        want = ref(tree, grads)
        port = pmc.load_params(pmc.PMCNet(pmc.PMCConfig(**SMALL_PMC)).double(), tree)
        opt = learner.make_optimizer(cfg, port, frozen=prefixes)
        names = set(opt.names)
        n_leaves = len(list(P._flatten(tree)))
        assert (len(names) < n_leaves) if prefixes else (len(names) == n_leaves)
        for n, (g, (jparams, jst)) in enumerate(zip(grads, want)):
            for k, p in zip(opt.names, opt.params):
                path = P.flax_path(k, p)
                p.grad = P.to_torch_layout(path, tree_at(g, path))
            opt.step()
            label = f"ClipAdam step {n} frozen {prefixes}"
            assert_params_close(port, jparams, 1e-12, 1e-12, label)
            assert_moments_close(opt, jst, 1e-12, 1e-12, label)
        path = tmp_path / f"opt_{len(prefixes)}.ckpt"
        with open(path, "wb") as f:
            pickle.dump({"step": 3, "trees": {"opt_state": jax.tree.map(np.asarray, jst)}}, f)
        read = from_jax.read_train_checkpoint(str(path))["trees"]["opt_state"]
        back = from_jax.adam_state(read, learner.make_optimizer(cfg, pmc.load_params(
            pmc.PMCNet(pmc.PMCConfig(**SMALL_PMC)).double(), tree), frozen=prefixes))
        assert back.names == opt.names
        assert_moments_close(back, jst, 0.0, 0.0, f"read back, frozen {prefixes}")  # exact
        for k, p in port.named_parameters():
            if k not in names:  # frozen: bitwise unchanged, no gradient
                assert not p.requires_grad
                assert np.array_equal(np_of(p), P.to_torch_layout(
                    P.flax_path(k, p), tree_at(tree, P.flax_path(k, p))).numpy()), k


def test_losses_replay_league_optimizer(tmp_path):
    rng = np.random.default_rng(0)
    _check_losses(rng)
    _check_replay(rng)
    _check_league(tmp_path)
    _check_optimizer(rng, tmp_path)


def pmc_rollout(rng, T, B):
    """A seeded (T, B) PMC rollout: observations, actions, behaviour
    neglogps off the current policy's, rewards and discounts with episode
    ends."""
    done = rng.uniform(size=(T, B)) < 0.15
    return dict(prop=rng.standard_normal((T, B, 99)), prop_a=rng.standard_normal((T, B, 36)),
                future=rng.standard_normal((T, B, 72)), action=rng.standard_normal((T, B, 12)),
                neglogp=rng.normal(-8.0, 1.0, (T, B)), reward=rng.uniform(0, 1, (T, B)),
                discount=0.95 * (1.0 - done))


def test_pmc_train_step_and_dead_codes():
    rng = np.random.default_rng(1)
    jcfg = jpmc.PMCConfig(**SMALL_PMC)
    jnet = jpmc.PMCNet(jcfg)
    roll = pmc_rollout(rng, 5, 6)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), roll["prop"][0], roll["prop_a"][0],
                                roll["future"][0])
    params = jax.tree.map(lambda x: x.astype(jnp.float64), params)  # Flax keeps f32 kernels
    lcfg = jlearner.PPOConfig(learning_rate=3e-3, max_grad_norm=0.5)
    tx = jlearner.make_optimizer(lcfg)
    jroll = jlearner.Rollout(**roll)

    @jax.jit
    def ref(params):
        st = tx.init(params)
        out = []
        for _ in range(2):
            grads = jax.grad(lambda p: jlearner.ppo_loss_fn(jnet, lcfg, p, jroll)[0])(params)
            params, st, metrics = jlearner.train_step(jnet, tx, lcfg, params, st, jroll)
            out.append((grads, params, st, metrics))
        return out

    want = ref(params)
    cfg = learner.PPOConfig(*lcfg)
    net = from_jax.pmc_params(params, pmc.PMCConfig(*jcfg), device=CPU, dtype=F64)
    opt = learner.make_optimizer(cfg, net)
    troll = learner.Rollout(**{k: torch.as_tensor(v) for k, v in roll.items()})
    for n, (grads, jparams, jst, jmetrics) in enumerate(want):
        metrics = learner.train_step(net, opt, cfg, troll)
        label = f"PMC train_step {n}"
        assert_metrics_close(metrics, jmetrics, 1e-9, 1e-9, label)
        assert_grads_close(opt, grads, 1e-9, 1e-9, label)
        assert_params_close(net, jparams, 1e-9, 1e-9, label)
        assert_moments_close(opt, jst, 1e-9, 1e-9, label)

    # restart_dead_codes: same usage, same generator -> the same codebook
    usage = np.zeros(jcfg.num_embeddings)
    usage[:5] = rng.uniform(10, 100, 5)
    usage[9] = 1e-4
    jtree = jax.tree.map(np.asarray, want[-1][1])
    pmc.load_params(net, jtree)  # the same codebook on both sides
    jnew, jn = jpmc.restart_dead_codes(jtree, usage, np.random.default_rng(11))
    n = pmc.restart_dead_codes(net, usage, np.random.default_rng(11))
    assert n == jn == 11
    np.testing.assert_array_equal(np_of(net.llc.embedding),
                                  np.asarray(jnew["params"]["llc"]["embedding"]))
    assert pmc.restart_dead_codes(net, np.zeros(jcfg.num_embeddings), None) == 0

"""Recurrent PPO: rollouts and TD-lambda updates for the LSTM policies.

Port of lifelike_tpu.learning.recurrent — the EPMC / SEPMC training path
(reference PPOLearner with use_lstm=True, rollout_len 8, burn-in 12, hidden
state stored per unroll; example_pmc_train.sh:119-125). Collection steps
the env with the policy carrying its LSTM state (a Python loop under
torch.no_grad()); training replays the unroll through the net step by step
from the stored hidden state of its first step, with the done-masks
resetting the LSTM exactly as during collection. Burn-in replays the first
`burn_in` steps without gradient to re-warm stale hidden states (the
hidden state is detached at the boundary), and the replay-staged variants
run the reference's rm_size / rollout_len / batch pipeline on the device
(learning/replay.py, overlapping burn-in windows).

Actions are multi-head: EPMC = (A_Z categorical 256, A_LLC diag-Gaussian
12); SEPMC adds A_HLC (Gaussian 1). Head neglogps add (independent heads).

Where the JAX package takes keys and parameter trees, these functions take
a torch.Generator and modules: `net` is trained in place; the SEPMC
opponent is a second module holding the frozen opponent's weights. Every
train step runs inside layers.full_fp32() (no TF32 in the backward).

Every train and learner step takes `group` (a parallel.mesh.Mesh) for
data-parallel training, as learning/learner.py's do; the replay windows
stay rank-local, and the SEPMC learner's return is averaged and its game
outcomes summed over the ranks, so every rank's league sees the same.

One deliberate difference: `_agent_obs` slices the agent axis of every
Chase Tag observation leaf. The JAX package's `x[..., i, :]` slices the
first row of the (..., 2, 25, 13) height maps instead, which hands its
SEPMC learner 2 x 13 maps; the port's SEPMCNet takes the 25 x 13 maps that
its forward, its eval and the TLeague import are held to.
"""
from typing import Any, NamedTuple

import torch

from lifelike_tpu_torch.learning import ppo
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.learning.learner import PPOConfig, apply_gradients, mark
from lifelike_tpu_torch.models import layers
from lifelike_tpu_torch.parallel import distributed


class RecurrentRollout(NamedTuple):
    obs: Any  # tree, leaves (T, B, ...)
    a_z: torch.Tensor  # (T, B) int64
    a_llc: torch.Tensor  # (T, B, 12)
    a_hlc: torch.Tensor  # (T, B, 1) (zeros for EPMC)
    neglogp: torch.Tensor  # (T, B) summed heads
    reward: torch.Tensor  # (T, B)
    discount: torch.Tensor  # (T, B)
    mask: torch.Tensor  # (T, B) 1.0 at episode starts
    hs: torch.Tensor  # (T, B, hs_len) hidden state BEFORE each step


def _dtype(net):
    return net.prop_rms.moving_mean.dtype


def _cast(obs, dtype):
    return rp.tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, obs)


@torch.no_grad()
def collect_epmc_rollout(net, env_bundle, cfg: PPOConfig, env_state, obs, hs, prev_done,
                         generator):
    """`unroll_length` steps of the playground env with the EPMC policy.

    Returns (env_state', obs', hs', done', RecurrentRollout)."""
    dtype = _dtype(net)
    steps = []
    for _ in range(cfg.unroll_length):
        obs = _cast(obs, dtype)
        mask = prev_done.to(hs.dtype)
        out = net(obs, hs, mask, generator=generator)
        a_llc = layers.gaussian_sample(generator, out.mean, out.logstd)
        neglogp = (layers.categorical_neglogp(out.z_logits, out.z_idx)
                   + layers.gaussian_neglogp(out.mean, out.logstd, a_llc))
        env_state, obs2, reward, done, _ = env_bundle.step_autoreset(
            env_state, {"A_Z": out.z_idx, "A_LLC": a_llc}, generator)
        reward = reward.to(dtype)
        steps.append(RecurrentRollout(
            obs=obs, a_z=out.z_idx.long(), a_llc=a_llc,
            a_hlc=torch.zeros(out.z_idx.shape + (1,), dtype=dtype, device=reward.device),
            neglogp=neglogp, reward=reward, discount=cfg.gamma * (1.0 - done.to(dtype)),
            mask=mask, hs=hs))
        obs, hs, prev_done = obs2, out.hs, done
    return env_state, obs, hs, prev_done, rp.tree_stack(steps)


def _replay_net(step, hs0, inputs, burn_in):
    """Run `step(hs, inp) -> (hs', outs)` over the time axis of `inputs`
    and stack the outs.

    The first `burn_in` steps only warm the hidden state: they run under
    the current parameters without gradient and the state is detached at
    the boundary, so no gradient flows through (or loss is taken from) the
    burn-in segment (the reference's burn_in 12)."""
    T = rp.tree_leaves(inputs)[0].shape[0]
    hs = hs0
    if burn_in:
        with torch.no_grad():
            for t in range(burn_in):
                hs, _ = step(hs, rp.tree_map(lambda x: x[t], inputs))
        hs = hs.detach()
    outs = []
    for t in range(burn_in, T):
        hs, o = step(hs, rp.tree_map(lambda x: x[t], inputs))
        outs.append(o)
    return tuple(torch.stack(x) for x in zip(*outs))


def _train_slice(roll: RecurrentRollout, burn_in):
    """The post-burn-in targets the loss is computed on."""
    if not burn_in:
        return roll
    return roll._replace(**{f: getattr(roll, f)[burn_in:]
                            for f in ("a_z", "a_llc", "a_hlc", "neglogp", "reward", "discount")})


def _ppo_terms(cfg, neglogp, vpred, ents, rms_losses, tr, group=None):
    entropy = torch.mean(ents)
    rms_loss = torch.mean(rms_losses)
    pg_loss, value_loss, mean_return = ppo.ppo2_loss(
        neglogp, tr.neglogp, vpred, tr.reward, tr.discount, lam=cfg.lam,
        clip_range=cfg.clip_range, clip_range_lower=cfg.clip_range_lower, group=group)
    loss = (pg_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
            + cfg.rms_loss_coef * rms_loss)
    metrics = {"pg_loss": pg_loss, "value_loss": value_loss, "entropy": entropy,
               "return": mean_return, "rms_loss": rms_loss,
               "reward_mean": torch.mean(tr.reward)}
    return loss, metrics


def epmc_loss_fn(net, cfg: PPOConfig, roll: RecurrentRollout, burn_in=0, group=None):
    """Replay the unroll through the net and compute the TD-lambda PPO loss
    with per-head entropy on the post-burn-in steps; the sampled codebook
    indices are injected (EPMCNet's z_idx=)."""

    def step(hs, inp):
        obs_t, mask_t, a_z_t, a_llc_t = inp
        out = net(obs_t, hs, mask_t, z_idx=a_z_t)
        nlp = (layers.categorical_neglogp(out.z_logits, a_z_t)
               + layers.gaussian_neglogp(out.mean, out.logstd, a_llc_t))
        ent = layers.categorical_entropy(out.z_logits) + layers.gaussian_entropy(out.logstd)
        return out.hs, (nlp, out.value[..., 0], ent, out.rms_loss)

    inputs = (roll.obs, roll.mask, roll.a_z, roll.a_llc)
    neglogp, vpred, ents, rms_losses = _replay_net(step, roll.hs[0], inputs, burn_in)
    return _ppo_terms(cfg, neglogp, vpred, ents, rms_losses, _train_slice(roll, burn_in), group)


@layers.full_fp32()
def epmc_train_step(net, optimizer, cfg: PPOConfig, roll, burn_in=0, group=None):
    """One recurrent PPO update of the EPMC net in place; returns metrics."""
    with layers.batch_group(group):
        loss, metrics = epmc_loss_fn(net, cfg, roll, burn_in, group)
    return apply_gradients(optimizer, loss, metrics, group)


_MAP_LEAVES = ("percept_2d", "percept_front")  # (..., 2, 25, 13); the rest (..., 2, k)


def _agent_obs(obs, i):
    """Agent i of a ChaseTagObs (every leaf has the agent axis 2 after the
    batch axes): the learner's (i = 0) or the opponent's view."""
    def pick(name, x):
        return x.select(x.dim() - (3 if name in _MAP_LEAVES else 2), i)

    return type(obs)(*(pick(f, getattr(obs, f)) for f in obs._fields))


@torch.no_grad()
def collect_sepmc_rollout(net, env_bundle, cfg: PPOConfig, opponent, env_state, obs, hs,
                          prev_done, generator):
    """Self-play collection on the chase-tag env: agent 0 is the learner
    (`net`), agent 1 the frozen `opponent` (PFSP-sampled weights), which
    plays its mean action. Only agent 0's transitions are recorded; rewards
    are zero-sum (..., 2).

    hs: (B, 2, hs_len). Returns (env_state', obs', hs', done', roll,
    learner_return (B,)) where learner_return accumulates agent 0's reward
    for the league's statistics."""
    dtype = _dtype(net)
    ret = torch.zeros(prev_done.shape, dtype=dtype, device=prev_done.device)
    steps = []
    for _ in range(cfg.unroll_length):
        obs = _cast(obs, dtype)
        mask = prev_done.to(hs.dtype)
        obs0 = _agent_obs(obs, 0)
        out0 = net(obs0, hs[..., 0, :], mask, generator=generator)
        out1 = opponent(_agent_obs(obs, 1), hs[..., 1, :], mask, generator=generator)
        a_llc0 = layers.gaussian_sample(generator, out0.mean, out0.logstd)
        neglogp = (layers.gaussian_neglogp(out0.hlc_mean, out0.hlc_logstd, out0.hlc_angle)
                   + layers.categorical_neglogp(out0.z_logits, out0.z_idx)
                   + layers.gaussian_neglogp(out0.mean, out0.logstd, a_llc0))
        a_llc = torch.stack([a_llc0, out1.mean], dim=-2)  # (..., 2, 12)
        env_state, obs2, rewards, done, _ = env_bundle.step_autoreset(
            env_state, {"A_LLC": a_llc}, generator)
        rewards = rewards.to(dtype)
        steps.append(RecurrentRollout(
            obs=obs0, a_z=out0.z_idx.long(), a_llc=a_llc0, a_hlc=out0.hlc_angle,
            neglogp=neglogp, reward=rewards[..., 0],
            discount=cfg.gamma * (1.0 - done.to(dtype)), mask=mask, hs=hs[..., 0, :]))
        ret = ret + rewards[..., 0]
        obs, hs, prev_done = obs2, torch.stack([out0.hs, out1.hs], dim=-2), done
    return env_state, obs, hs, prev_done, rp.tree_stack(steps), ret


def sepmc_loss_fn(net, cfg: PPOConfig, roll: RecurrentRollout, burn_in=0, group=None):
    """Replay + TD-lambda PPO for the 3-head SEPMC policy (the sampled
    angles and codebook indices injected)."""

    def step(hs, inp):
        obs_t, mask_t, a_hlc_t, a_z_t, a_llc_t = inp
        out = net(obs_t, hs, mask_t, a_hlc=a_hlc_t, a_z=a_z_t)
        nlp = (layers.gaussian_neglogp(out.hlc_mean, out.hlc_logstd, a_hlc_t)
               + layers.categorical_neglogp(out.z_logits, a_z_t)
               + layers.gaussian_neglogp(out.mean, out.logstd, a_llc_t))
        ent = (layers.gaussian_entropy(out.hlc_logstd) + layers.categorical_entropy(out.z_logits)
               + layers.gaussian_entropy(out.logstd))
        return out.hs, (nlp, out.value[..., 0], ent, out.rms_loss)

    inputs = (roll.obs, roll.mask, roll.a_hlc, roll.a_z, roll.a_llc)
    neglogp, vpred, ents, rms_losses = _replay_net(step, roll.hs[0], inputs, burn_in)
    return _ppo_terms(cfg, neglogp, vpred, ents, rms_losses, _train_slice(roll, burn_in), group)


@layers.full_fp32()
def sepmc_train_step(net, optimizer, cfg: PPOConfig, roll, burn_in=0, group=None):
    """One recurrent PPO update of the SEPMC net in place; returns metrics."""
    with layers.batch_group(group):
        loss, metrics = sepmc_loss_fn(net, cfg, roll, burn_in, group)
    return apply_gradients(optimizer, loss, metrics, group)


def _learner_stats(metrics, roll, ret, group):
    """The learner's mean return and the unroll's game outcomes (averaged /
    summed over the ranks of `group`) into `metrics`."""
    outcomes = _game_outcomes(roll)
    ret = torch.mean(ret)
    if group is not None:
        outcomes = distributed.sum_tree(outcomes, group)
        ret = distributed.all_mean(ret, group)
    metrics["learner_return"] = ret
    metrics.update(outcomes)


def _game_outcomes(roll: RecurrentRollout):
    """Per-EPISODE game results inside the unroll, for PFSP statistics: a
    game ends where discount hits zero; the learner's terminal reward sign
    is the outcome (+1 catch/win, -1 caught/loss, 0 fall/timeout draw), as
    the reference league counts match results (chase_tag_game_env.py:412-419)."""
    ended = roll.discount == 0.0
    return {"games": torch.sum(ended.float()),
            "wins": torch.sum((ended & (roll.reward > 0)).float()),
            "losses": torch.sum((ended & (roll.reward < 0)).float())}


def sepmc_learner_step(net, env_bundle, cfg: PPOConfig, optimizer, opponent, env_state, obs,
                       hs, prev_done, generator, timer=None, group=None):
    """One self-play PPO iteration: collect against the frozen opponent,
    update the learner. Returns (env_state', obs', hs', done', metrics)
    with the learner's mean return and the unroll's game outcomes."""
    env_state, obs, hs, done, roll, ret = collect_sepmc_rollout(
        net, env_bundle, cfg, opponent, env_state, obs, hs, prev_done, generator)
    mark(timer)
    metrics = sepmc_train_step(net, optimizer, cfg, roll, group=group)
    _learner_stats(metrics, roll, ret, group)
    return env_state, obs, hs, done, metrics


def epmc_learner_step(net, env_bundle, cfg: PPOConfig, optimizer, env_state, obs, hs,
                      prev_done, generator, timer=None, group=None):
    """One recurrent PPO iteration for the EPMC task (one update, no
    burn-in). Returns (env_state', obs', hs', done', metrics)."""
    env_state, obs, hs, done, roll = collect_epmc_rollout(net, env_bundle, cfg, env_state, obs,
                                                          hs, prev_done, generator)
    mark(timer)
    metrics = epmc_train_step(net, optimizer, cfg, roll, group=group)
    return env_state, obs, hs, done, metrics


# ---------------------------------------------------------------------------
# Replay-staged variants: the reference learner pipeline (rm_size unrolls,
# rollout_len windows, burn-in, several optimizer steps per unroll —
# run_pg_learner.py:36,42-43 + example_pmc_train.sh:119-125).
# ---------------------------------------------------------------------------


def _window(cfg: PPOConfig):
    window = cfg.burn_in + cfg.rollout_length
    if cfg.unroll_length < window:
        raise ValueError(f"unroll_length {cfg.unroll_length} < burn_in {cfg.burn_in} + "
                         f"rollout_length {cfg.rollout_length}")
    return window


def _stage_windows(cfg: PPOConfig, roll: RecurrentRollout):
    return rp.windows_overlapping(roll, _window(cfg), cfg.rollout_length)


def rollout_example(cfg: PPOConfig, obs, hs, n_act=12):
    """Zero-filled RecurrentRollout with (T, B) leaves, for replay_init.
    obs: one observation tree with (B, ...) leaves (agent-sliced for SEPMC);
    hs: the learner's hidden state (B, hs_len)."""
    T = cfg.unroll_length
    batch = tuple(hs.shape[:-1])

    def tile(x):
        return torch.zeros((T,) + tuple(x.shape), dtype=x.dtype, device=x.device)

    def z(*trail):
        return torch.zeros((T,) + batch + trail, dtype=hs.dtype, device=hs.device)

    return RecurrentRollout(obs=rp.tree_map(tile, obs),
                            a_z=torch.zeros((T,) + batch, dtype=torch.int64, device=hs.device),
                            a_llc=z(n_act), a_hlc=z(1), neglogp=z(), reward=z(), discount=z(),
                            mask=z(), hs=z(hs.shape[-1]))


def recurrent_replay_init(cfg: PPOConfig, roll_example: RecurrentRollout):
    """Empty replay shaped after one (burn_in + rollout_length)-step window.
    roll_example: any rollout with (T, B) leaves from the same env / net."""
    window = _window(cfg)
    one = rp.tree_map(lambda x: torch.zeros((window,) + tuple(x.shape[2:]), dtype=x.dtype,
                                            device=x.device), roll_example)
    return rp.replay_init(one, cfg.replay_size)


def _replayed_updates(train_step_fn, cfg: PPOConfig, replay, roll, generator):
    """Stage the unroll's windows, then cfg.num_updates updates on sampled
    minibatches. Returns (replay', the last update's metrics)."""
    replay = rp.replay_add(replay, _stage_windows(cfg, roll))
    for _ in range(cfg.num_updates):
        batch = rp.replay_sample(replay, generator, cfg.batch_windows)
        metrics = train_step_fn(rp.as_time_major(batch))
    return replay, metrics


def epmc_learner_step_replayed(net, env_bundle, cfg: PPOConfig, optimizer, env_state, obs, hs,
                               prev_done, replay, generator, timer=None, group=None):
    """Collect one unroll, stage burn-in windows into the replay, run
    cfg.num_updates sampled-minibatch PPO updates with burn-in replay.
    Returns (env_state', obs', hs', done', replay', metrics)."""
    env_state, obs, hs, done, roll = collect_epmc_rollout(net, env_bundle, cfg, env_state, obs,
                                                          hs, prev_done, generator)
    mark(timer)
    replay, metrics = _replayed_updates(
        lambda b: epmc_train_step(net, optimizer, cfg, b, burn_in=cfg.burn_in, group=group),
        cfg, replay,
        roll, generator)
    return env_state, obs, hs, done, replay, metrics


def sepmc_learner_step_replayed(net, env_bundle, cfg: PPOConfig, optimizer, opponent, env_state,
                                obs, hs, prev_done, replay, generator, timer=None, group=None):
    """Self-play collection + replay-staged burn-in PPO updates. Returns
    (env_state', obs', hs', done', replay', metrics)."""
    env_state, obs, hs, done, roll, ret = collect_sepmc_rollout(
        net, env_bundle, cfg, opponent, env_state, obs, hs, prev_done, generator)
    mark(timer)
    replay, metrics = _replayed_updates(
        lambda b: sepmc_train_step(net, optimizer, cfg, b, burn_in=cfg.burn_in, group=group),
        cfg, replay, roll, generator)
    _learner_stats(metrics, roll, ret, group)
    return env_state, obs, hs, done, replay, metrics

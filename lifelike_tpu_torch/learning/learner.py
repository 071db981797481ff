"""PPO learner for the PMC task: batched rollouts + TD-lambda PPO.

Port of lifelike_tpu.learning.learner. The JAX package runs collection and
the update as one jitted program; here collection is a Python loop of
`unroll_length` batched env steps under torch.no_grad() and the update is
one autograd step. Hyperparameters mirror reference example_pmc_train.sh
(lr 1e-5, gamma = lam = 0.95, clip 0.1, vf_coef 1, ent_coef 0, q_latent
1.0, e_latent 0.25, rms 1.0, grad clip 0.5).

Randomness: where the JAX package splits a key per step and per purpose,
the port draws the actions, the env resets and the replay's indices from
one torch.Generator on the learner's device, in that order.

The train step runs at full float32 precision: forward, backward and the
optimizer step inside layers.full_fp32(), so no convolution or matmul of
the backward pass runs in TF32 (the JAX learner trains at
jax_default_matmul_precision="highest").

Data-parallel training: every step function takes `group`, a
parallel.mesh.Mesh whose ranks each hold a local batch of the same size.
The step then computes what the JAX package's one global jit computes on
the concatenated global batch: the batch statistics a loss reads (the
advantage normalization, the RMS layers' batch mean / std, the VQ
perplexity) are over every rank (layers.batch_group), the gradients are
averaged over the ranks before ClipAdam's global-norm clip (as the JAX
package's pmean sits before optax), the metrics are averaged, and the
clip statistics and code counts of the unrolls are summed. The parameters
then stay bitwise equal on every rank.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.envs import primitive
from lifelike_tpu_torch.learning import freeze, ppo
from lifelike_tpu_torch.learning import replay as rp
from lifelike_tpu_torch.models import layers
from lifelike_tpu_torch.parallel import distributed


class PPOConfig(NamedTuple):
    learning_rate: float = 1e-5
    gamma: float = 0.95
    lam: float = 0.95
    clip_range: float = 0.1
    clip_range_lower: float = 0.1
    vf_coef: float = 1.0
    ent_coef: float = 0.0
    q_latent_coef: float = 1.0
    e_latent_coef: float = 0.25
    rms_loss_coef: float = 1.0
    max_grad_norm: float = 0.5
    unroll_length: int = 16  # reference uses 128; shorter default for tests
    # replay staging (reference: rollout_len 8, rm_size 1024, batch 256)
    rollout_length: int = 8  # window length sampled from the replay
    replay_size: int = 256  # window slots held on the device
    batch_windows: int = 32  # slots per sampled minibatch
    num_updates: int = 4  # optimizer steps per collected unroll
    # LSTM-state warmup steps replayed gradient-free before each sampled
    # window (recurrent replayed paths only; reference burn_in 12,
    # example_pmc_train.sh:119-125)
    burn_in: int = 12


class Rollout(NamedTuple):
    """(T, B, ...) unroll tensors."""

    prop: torch.Tensor
    prop_a: torch.Tensor
    future: torch.Tensor
    action: torch.Tensor
    neglogp: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor  # gamma * (1 - done)


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)), written out.

    Every part is hand-written (no torch.optim): the gradients of the
    trainable parameters are gathered into one flat buffer (a parameter
    without a gradient counts as zeros, as JAX's gradient of an unused leaf
    is zeros); the global norm is taken over that buffer; the gradients
    stay as they are while norm < max_norm and are otherwise g / norm *
    max_norm, as optax computes them; Adam keeps its first and second
    moments as flat buffers (exp_avg, exp_avg_sq) with b1 0.9, b2 0.999,
    eps 1e-8 added outside the square root, eps_root 0, and bias correction
    by the integer step count:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  step += 1
        p += -lr * (mu / (1 - b1^step)) / (sqrt(nu / (1 - b2^step)) + eps)

    One multi-tensor add writes the update into the parameters. Frozen
    parameters are simply not in the list (optax multi_transform +
    set_to_zero). The trainable parameters share one dtype and device.
    """

    def __init__(self, named_params, learning_rate, max_grad_norm, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.names = [k for k, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.max_norm = float(learning_rate), float(max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.numel = [p.numel() for p in self.params]
        p0 = self.params[0]
        self.step_count = 0
        self.exp_avg = torch.zeros(sum(self.numel), dtype=p0.dtype, device=p0.device)
        self.exp_avg_sq = torch.zeros_like(self.exp_avg)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def flat_grad(self):
        return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                          for p in self.params])

    def views(self, flat):
        """A flat buffer as one tensor per parameter, in its shape."""
        return [x.view_as(p) for x, p in zip(flat.split(self.numel), self.params)]

    @torch.no_grad()
    def step(self, group=None):
        """One update; with `group` (a parallel.mesh.Mesh) the gradients are
        first averaged over its ranks (one collective)."""
        g = self.flat_grad()
        if group is not None:
            g = distributed.all_mean(g, group)
        norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
        self.exp_avg.mul_(self.b1).add_(g * (1.0 - self.b1))
        self.exp_avg_sq.mul_(self.b2).add_(g * g * (1.0 - self.b2))
        self.step_count += 1
        mu_hat = self.exp_avg / (1.0 - self.b1 ** self.step_count)
        nu_hat = self.exp_avg_sq / (1.0 - self.b2 ** self.step_count)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps) * (-self.lr)
        torch._foreach_add_(self.params, self.views(update))

    def state_dict(self):
        return {"names": list(self.names), "step": self.step_count,
                "exp_avg": self.exp_avg.clone(), "exp_avg_sq": self.exp_avg_sq.clone()}

    def load_state_dict(self, state):
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state for other parameters")
        self.step_count = int(state["step"])
        self.exp_avg.copy_(state["exp_avg"])
        self.exp_avg_sq.copy_(state["exp_avg_sq"])


def make_optimizer(cfg: PPOConfig, net, frozen=()):
    """ClipAdam (clip by global norm, then Adam at cfg.learning_rate) over
    `net`'s parameters; those under the Flax path prefixes `frozen` are
    frozen (learning/freeze.py) and left out."""
    skip = set(freeze.freeze(net, frozen)) if frozen else set()
    named = [(k, p) for k, p in net.named_parameters() if k not in skip]
    return ClipAdam(named, cfg.learning_rate, cfg.max_grad_norm)


def mark(timer):
    if timer is not None:
        timer.mark()


def _policy_obs(obs, dtype):
    return primitive.Observation(*(x.to(dtype) for x in obs))


@torch.no_grad()
def collect_rollout(net, model, clips, env_cfg, cfg: PPOConfig, env_state, generator,
                    clip_probs=None):
    """`unroll_length` env steps with the stochastic policy.

    Returns (env_state', Rollout with (T, B) leaves, clip_stats) where
    clip_stats = (reward_sum (n_clips,), episode_count (n_clips,),
    code_counts (num_embeddings,)) holds the per-clip episode-average-reward
    sums and counts of the episodes that ENDED inside the unroll (the
    device-side half of the reference's prioritized clip resampling,
    primitive_level_env.py:236-240) and the VQ codes' selection counts (for
    models.pmc.restart_dead_codes). The observations are cast to the
    policy's dtype."""
    dtype = net.llc.embedding.dtype
    dev = env_state.t.device
    n_clips, n_codes = clips.num_clips, net.cfg.num_embeddings
    reward_sum = torch.zeros(n_clips, dtype=dtype, device=dev)
    ep_count = torch.zeros(n_clips, dtype=dtype, device=dev)
    code_counts = torch.zeros(n_codes, dtype=torch.int64, device=dev)
    steps = []
    for _ in range(cfg.unroll_length):
        obs = _policy_obs(primitive._observe(clips, env_cfg, env_state), dtype)
        out = net(*obs)
        action = layers.gaussian_sample(generator, out.mean, out.logstd)
        neglogp = layers.gaussian_neglogp(out.mean, out.logstd, action)
        ep_clip = env_state.clip_idx.reshape(-1).long()  # the episode's clip (pre-reset)
        env_state, _, reward, done, info = primitive.step_autoreset(
            model, clips, env_cfg, env_state, action, generator, clip_probs)
        reward = reward.to(dtype)
        ended = done.to(dtype)
        steps.append(Rollout(prop=obs.prop, prop_a=obs.prop_a, future=obs.future,
                             action=action, neglogp=neglogp, reward=reward,
                             discount=cfg.gamma * (1.0 - ended)))
        reward_sum.index_add_(0, ep_clip, (info["ep_avg_reward"].to(dtype) * ended).reshape(-1))
        ep_count.index_add_(0, ep_clip, ended.reshape(-1))
        code_counts += torch.bincount(out.z_idx.reshape(-1).long(), minlength=n_codes)
    return env_state, rp.tree_stack(steps), (reward_sum, ep_count, code_counts.float())


def ppo_loss_fn(net, cfg: PPOConfig, rollout: Rollout, group=None):
    out = net(rollout.prop, rollout.prop_a, rollout.future)
    neglogp = layers.gaussian_neglogp(out.mean, out.logstd, rollout.action)
    vpred = out.value[..., 0]  # (T, B)
    pg_loss, value_loss, mean_return = ppo.ppo2_loss(
        neglogp, rollout.neglogp, vpred, rollout.reward, rollout.discount, lam=cfg.lam,
        clip_range=cfg.clip_range, clip_range_lower=cfg.clip_range_lower, group=group)
    entropy = torch.mean(layers.gaussian_entropy(out.logstd))
    loss = (pg_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
            + cfg.q_latent_coef * out.q_latent_loss + cfg.e_latent_coef * out.e_latent_loss
            + cfg.rms_loss_coef * out.rms_loss)
    metrics = {
        "pg_loss": pg_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "return": mean_return,
        "rms_loss": out.rms_loss,
        "q_latent_loss": out.q_latent_loss,
        "e_latent_loss": out.e_latent_loss,
        "perplexity": out.perplexity,
        "reward_mean": torch.mean(rollout.reward),
    }
    return loss, metrics


def apply_gradients(optimizer, loss, metrics, group=None):
    """backward, then the optimizer step; metrics (detached) + "loss". With
    `group` the gradients and the metrics are averaged over its ranks."""
    optimizer.zero_grad()
    loss.backward()
    optimizer.step(group)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    if group is not None:
        metrics = distributed.mean_tree(metrics, group)
    return metrics


@layers.full_fp32()
def train_step(net, optimizer, cfg: PPOConfig, rollout: Rollout, group=None):
    """One PPO update of `net` in place; returns the metrics (device
    tensors). The gradients stay in the parameters' .grad until the next
    step (this rank's own, before the average). `group`: see the module's
    docstring."""
    with layers.batch_group(group):
        loss, metrics = ppo_loss_fn(net, cfg, rollout, group)
    return apply_gradients(optimizer, loss, metrics, group)


def learner_step(net, model, clips, env_cfg, cfg: PPOConfig, optimizer, env_state, generator,
                 clip_probs=None, timer=None, group=None):
    """Collect one unroll and apply one PPO update. clip_stats (per-clip
    reward sums / episode counts, code counts) ride along in the metrics
    for host-side prioritized resampling (summed over the ranks of
    `group`). `timer.mark()` (when given) is called between collection
    and the update. Returns (env_state', metrics)."""
    env_state, rollout, clip_stats = collect_rollout(net, model, clips, env_cfg, cfg, env_state,
                                                     generator, clip_probs)
    mark(timer)
    metrics = train_step(net, optimizer, cfg, rollout, group)
    if group is not None:
        clip_stats = distributed.sum_tree(clip_stats, group)
    metrics["clip_reward_sum"], metrics["clip_ep_count"], metrics["code_counts"] = clip_stats
    return env_state, metrics


def replay_init(net, model, clips, env_cfg, cfg: PPOConfig, env_state):
    """Empty replay buffer shaped after one (rollout_length,) window slot."""
    dtype = net.llc.embedding.dtype
    obs = primitive._observe(clips, env_cfg, env_state)
    W, dev = cfg.rollout_length, env_state.t.device

    def z(*trail):
        return torch.zeros((W,) + trail, dtype=dtype, device=dev)

    example = Rollout(prop=z(obs.prop.shape[-1]), prop_a=z(obs.prop_a.shape[-1]),
                      future=z(obs.future.shape[-1]), action=z(12), neglogp=z(), reward=z(),
                      discount=z())
    return rp.replay_init(example, cfg.replay_size)


def learner_step_replayed(net, model, clips, env_cfg, cfg: PPOConfig, optimizer, env_state,
                          replay, generator, clip_probs=None, timer=None):
    """Collect one unroll, stage it in the replay, and run cfg.num_updates
    sampled-minibatch PPO updates — the reference's pull-worker /
    replay-memory / batch-worker pipeline (run_pg_learner.py:36,42-43).
    Returns (env_state', replay', the last update's metrics)."""
    env_state, rollout, clip_stats = collect_rollout(net, model, clips, env_cfg, cfg, env_state,
                                                     generator, clip_probs)
    mark(timer)
    replay = rp.replay_add(replay, rp.windows_from_unroll(rollout, cfg.rollout_length))
    for _ in range(cfg.num_updates):
        batch = rp.replay_sample(replay, generator, cfg.batch_windows)
        metrics = train_step(net, optimizer, cfg, rp.as_time_major(batch))
    metrics["clip_reward_sum"], metrics["clip_ep_count"], metrics["code_counts"] = clip_stats
    return env_state, replay, metrics

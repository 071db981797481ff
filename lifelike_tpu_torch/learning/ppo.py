"""PPO losses (clip variant + TD-lambda 'ppo2').

Port of lifelike_tpu.learning.ppo (the loss math of the reference's
tpolicies tp_losses.ppo_loss / ppo2_loss, reference pmc_net.py:183-240):

  * advantage normalization by the population statistics of the batch,
    std = sqrt(max(E[x^2] - E[x]^2, 0)) + 1e-8, as the JAX package
    computes it; with `group` (a parallel.mesh.Mesh) E[x] and E[x^2] are
    averaged over its ranks (the JAX package's `axis_name` pmean), which
    for equal local batches are the global batch's
  * double-sided clipping with clip_range / clip_range_lower
  * TD-lambda returns by a reverse loop over the rollout axis (the JAX
    package's reverse lax.scan)
"""
import torch

from lifelike_tpu_torch.parallel import distributed


def _normalize_adv(adv, group=None):
    mean = torch.mean(adv)
    msq = torch.mean(adv ** 2)
    if group is not None:
        mean, msq = distributed.all_mean(torch.stack([mean, msq]), group)
    std = torch.sqrt(torch.clamp_min(msq - mean ** 2, 0.0))
    return (adv - mean) / (std + 1e-8)


def ppo_surrogate(neglogp, oldneglogp, adv, clip_range, clip_range_lower=None):
    ratio = torch.exp(oldneglogp - neglogp)
    lo = clip_range if clip_range_lower is None else clip_range_lower
    clipped = torch.clamp(ratio, 1.0 - lo, 1.0 + clip_range)
    return -torch.minimum(ratio * adv, clipped * adv)


def ppo_loss(neglogp, oldneglogp, vpred, R, V, clip_range=0.1, clip_range_lower=0.1,
             adv_normalize=True, group=None):
    """Classic PPO with actor-computed returns (reference 'rl'/'ppo' path).

    R: returns, V: behavior values (both (..., n_v)); advantage = R - V summed
    over value heads. Returns (pg_loss, value_loss).
    """
    adv = torch.sum(R - V, dim=-1)
    if adv_normalize:
        adv = _normalize_adv(adv, group)
    pg = torch.mean(ppo_surrogate(neglogp, oldneglogp, adv, clip_range, clip_range_lower))
    value_loss = torch.mean(0.5 * (R - vpred) ** 2)
    return pg, value_loss


def lambda_return(reward, discount, vpred_next, lam):
    """TD-lambda multi-step forward view over axis 0 (time).

    reward, discount: (T, B); vpred_next: (T, B) = V(s_{t+1}).
    G_t = r_t + d_t * ((1-lam) * V_{t+1} + lam * G_{t+1}), G_T seeded with
    vpred_next[-1].
    """
    g = vpred_next[-1]
    out = []
    for t in range(reward.shape[0] - 1, -1, -1):
        g = reward[t] + discount[t] * ((1.0 - lam) * vpred_next[t] + lam * g)
        out.append(g)
    return torch.stack(out[::-1])


def ppo2_loss(neglogp, oldneglogp, vpred, reward, discount, lam=0.95, clip_range=0.1,
              clip_range_lower=0.1, adv_normalize=True, mask=None, group=None):
    """TD-lambda PPO on (T, B) rollout tensors (reference 'ppo2' path).

    vpred: (T, B) value predictions. Uses steps [0, T-1) with the off-by-one
    V(s_{t+1}) alignment of the reference (pmc_net.py:218-240); the returns
    and the baseline carry no gradient. Returns (pg_loss, value_loss,
    mean_return).
    """
    R = lambda_return(reward[:-1], discount[:-1], vpred[1:], lam).detach()
    adv = R - vpred[:-1].detach()
    if adv_normalize:
        adv = _normalize_adv(adv, group)
    pg = ppo_surrogate(neglogp[:-1], oldneglogp[:-1], adv, clip_range, clip_range_lower)
    if mask is not None:
        pg = pg * mask[:-1]
    pg_loss = torch.mean(pg)
    value_loss = torch.mean(0.5 * (R - vpred[:-1]) ** 2)
    return pg_loss, value_loss, torch.mean(R)

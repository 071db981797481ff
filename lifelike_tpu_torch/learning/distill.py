"""Teacher-student distillation: losses, actor mixing, learner step.

Port of lifelike_tpu.learning.distill (reference PureDistillActor /
PureDistillLearner, learning/actors/distill_actor.py,
learning/learners/distill_learner.py): a frozen teacher policy and a live
student both run on the batched env; which one acts is sampled per step
with an annealed teacher ratio (:214-244), and the student is trained
supervised / by KL against the teacher's action distribution.

Distill loss modes match the reference z_mlp 'distill' family (:167-191):
  'standard'   — KL(teacher || student) from the teacher's (mean, logstd)
  'action_var' — KL with teacher mean = the executed action, fixed variance
  'supervised' — plain MSE to the teacher action

The optimizer is learning.learner.ClipAdam (optax's clip_by_global_norm +
adam, written out); a step updates the student in place.
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch.learning import learner
from lifelike_tpu_torch.models import layers
from lifelike_tpu_torch.models.z_net import ar1_prior_loss


class DistillConfig(NamedTuple):
    loss_type: str = "standard"  # {'standard', 'action_var', 'supervised'}
    action_var: float = 1.0
    teacher_ratio_start: float = 1.0
    teacher_ratio_end: float = 0.0
    teacher_ratio_decay_steps: int = 100_000
    learning_rate: float = 1e-4
    max_grad_norm: float = 0.5
    beta: float = 1.0  # AR(1) prior weight when distilling a ZNet


def teacher_ratio(cfg: DistillConfig, step):
    frac = torch.clamp(torch.as_tensor(step) / cfg.teacher_ratio_decay_steps, 0.0, 1.0)
    return cfg.teacher_ratio_start + frac * (cfg.teacher_ratio_end - cfg.teacher_ratio_start)


def mix_actions(generator, cfg: DistillConfig, step, teacher_action, student_action):
    """Per-env-step choice of which policy acts (reference :214-244): the
    teacher's action with probability teacher_ratio(step), a Bernoulli draw
    per action row from `generator`."""
    ratio = teacher_ratio(cfg, step)
    u = torch.rand(teacher_action.shape[:-1], generator=generator, dtype=teacher_action.dtype,
                   device=teacher_action.device)
    use_teacher = u < ratio
    return torch.where(use_teacher[..., None], teacher_action, student_action)


def distill_loss(cfg: DistillConfig, student_mean, student_logstd, teacher_mean,
                 teacher_logstd=None, teacher_action=None):
    if cfg.loss_type == "standard":
        if teacher_logstd is None:
            raise ValueError("loss_type 'standard' needs teacher_logstd")
        return torch.mean(layers.gaussian_kl(teacher_mean, teacher_logstd, student_mean,
                                             student_logstd))
    if cfg.loss_type == "action_var":
        if teacher_action is None:
            raise ValueError("loss_type 'action_var' needs teacher_action")
        t_logstd = torch.full_like(student_logstd, 0.5 * math.log(cfg.action_var))
        return torch.mean(layers.gaussian_kl(teacher_action, t_logstd, student_mean,
                                             student_logstd))
    if cfg.loss_type == "supervised":
        if teacher_action is None:
            raise ValueError("loss_type 'supervised' needs teacher_action")
        return torch.mean(torch.sum((student_mean - teacher_action) ** 2, dim=-1))
    raise ValueError(cfg.loss_type)


def make_distill_optimizer(cfg: DistillConfig, net):
    """ClipAdam over `net`'s parameters at cfg.learning_rate, clipping the
    global gradient norm to cfg.max_grad_norm."""
    return learner.ClipAdam(list(net.named_parameters()), cfg.learning_rate,
                            cfg.max_grad_norm)


@layers.full_fp32()
def znet_distill_step(znet, cfg: DistillConfig, optimizer, batch, generator=None, eps=None):
    """One supervised update of a ZNet on teacher rollout data, in place.

    batch: dict with obs (T, B, D), teacher_mean / teacher_logstd (T, B, 12)
    or teacher_action, masks (T, B), z_init (B, z_len). The latent normals
    come from `generator` or `eps` (see ZNet.forward). Returns the metrics
    (distill_loss, prior_loss, rms_loss, loss; detached)."""
    out = znet(batch["obs"], batch["z_init"], batch["masks"], generator=generator, eps=eps)
    d = distill_loss(cfg, out.mean, out.logstd,
                     batch.get("teacher_mean", batch.get("teacher_action")),
                     batch.get("teacher_logstd"), batch.get("teacher_action"))
    prior = ar1_prior_loss(znet.cfg, out)
    loss = d + cfg.beta * prior + out.rms_loss
    return learner.apply_gradients(
        optimizer, loss, {"distill_loss": d, "prior_loss": prior, "rms_loss": out.rms_loss})

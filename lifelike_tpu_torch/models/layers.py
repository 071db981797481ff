"""Shared network layers: trainable running-mean-std, initializers, heads.

Port of lifelike_tpu.models.layers. The running normalization keeps the
reference's trick (reference networks/layers.py:5-60): mean and std are
trainable parameters regressed toward the batch statistics by a
least-squares "rms loss", so the update rides the optimizer.

Parameter names follow the JAX package's Flax scopes (`moving_mean`,
`Dense_0`, `mean`, `logstd`, ...) so that models/params.py maps a Flax
parameter tree onto a module's state_dict by path. Dense layers are
nn.Linear (weight (out, in), the transpose of a Flax kernel).
"""
import contextlib
import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


def act_fn(name):
    """The Flax activation of that name (nn.relu, nn.tanh, ...)."""
    return {"relu": F.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "elu": F.elu, "gelu": F.gelu, "swish": F.silu, "silu": F.silu}[name]


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls at full float32 precision.

    cuDNN convolutions may use TF32 by default; the VQ argmin and a sampled
    codebook index turn TF32's rounding into different actions, so the
    networks' forward passes run inside this context. A backward pass reads
    the setting when it runs, after the forward's context has exited, so the
    learner's train steps run wholly inside it — forward, backward and the
    optimizer step — with the context as their decorator
    (learning/learner.train_step, learning/recurrent.*_train_step). No
    effect on the CPU.
    """
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = (conv.fp32_precision, matmul.fp32_precision)
    conv.fp32_precision = matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved


def normc_init(scale=1.0):
    """Column-normalized initializer (reference networks/utils.py:10-16).

    Returns init(shape, generator=None, dtype=torch.float32) for a kernel in
    the Flax layout (..., in, out): each output column has norm `scale`.
    """

    def init(shape, generator=None, dtype=torch.float32):
        w = torch.randn(shape, generator=generator, dtype=dtype)
        return w * scale / torch.sqrt(torch.sum(w ** 2, dim=0, keepdim=True))

    return init


def dense(in_features, out_features, scale=1.0, generator=None):
    """nn.Linear with a normc kernel (`scale`) and a zero bias, as the JAX
    package's nn.Dense(kernel_init=normc_init(scale))."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(normc_init(scale)((in_features, out_features), generator).T)
        lin.bias.zero_()
    return lin


class RMS(nn.Module):
    """Running mean/std as trainable params + auxiliary least-squares loss.

    Returns (normalized, rms_loss). The normalized output is detached and
    clipped to +-5 like the reference (pmc_net.py:131-135); the batch
    statistics are population statistics over every axis but the last.
    """

    def __init__(self, dim, momentum=1e-4):
        super().__init__()
        self.momentum = momentum
        self.moving_mean = nn.Parameter(torch.zeros(dim))
        self.moving_std = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        mean, std = self.moving_mean, self.moving_std
        out = torch.clamp(((x - mean) / (std + 1e-8)).detach(), -5.0, 5.0)
        flat = x.detach().reshape(-1, x.shape[-1])
        b_mean = flat.mean(0)
        b_std = flat.std(0, correction=0)
        rms_loss = 0.5 * self.momentum * (
            torch.mean((mean - b_mean) ** 2) + torch.mean((std - b_std) ** 2)
        )
        return out, rms_loss


class MLP(nn.Module):
    """Dense stack `Dense_0`, `Dense_1`, ... with the named activation."""

    def __init__(self, in_features, features: Sequence[int], activation="relu",
                 final_activation=True, kernel_init_scale=1.0, generator=None):
        super().__init__()
        self.activation = activation
        self.final_activation = final_activation
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", dense(in_features, f, kernel_init_scale, generator))
            in_features = f

    def forward(self, x):
        act = act_fn(self.activation)
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if self.final_activation or i < self.n - 1:
                x = act(x)
        return x


class DiagGaussianHead(nn.Module):
    """12-d diagonal Gaussian action head with learned state-independent
    logstd (reference pmc_net.py:99-114)."""

    def __init__(self, in_features, action_dim=12, logstd_init=-2.0, mean_init_scale=0.01,
                 generator=None):
        super().__init__()
        self.mean = dense(in_features, action_dim, mean_init_scale, generator)
        self.logstd = nn.Parameter(torch.full((action_dim,), float(logstd_init)))

    def forward(self, x):
        mean = self.mean(x)
        return mean, self.logstd.expand(mean.shape)


_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_neglogp(mean, logstd, x):
    return (0.5 * torch.sum(((x - mean) / torch.exp(logstd)) ** 2, dim=-1)
            + 0.5 * _LOG_2PI * x.shape[-1] + torch.sum(logstd, dim=-1))


def gaussian_entropy(logstd):
    return torch.sum(logstd + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


def gaussian_sample(generator, mean, logstd):
    eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
    return mean + torch.exp(logstd) * eps


def gaussian_kl(mean_a, logstd_a, mean_b, logstd_b):
    var_a, var_b = torch.exp(2 * logstd_a), torch.exp(2 * logstd_b)
    return torch.sum(
        logstd_b - logstd_a + (var_a + (mean_a - mean_b) ** 2) / (2 * var_b) - 0.5, dim=-1
    )


def categorical_neglogp(logits, idx):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, idx[..., None].long())[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_sample(generator, logits):
    """Index drawn from softmax(logits) by the Gumbel-max trick, as
    jax.random.categorical draws it (the same distribution; a torch
    generator's numbers, not JAX's)."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)

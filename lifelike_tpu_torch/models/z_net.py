"""Z pretraining net: a temporal VAE distilling mocap tracking into latents.

Port of lifelike_tpu.models.z_net (reference z/z_mlp.py:103-221): per
rollout step, an encoder maps [future_rms, z_prev] -> (mu, logvar), the
reparameterized z feeds an MLP decoder with prop_rms to produce the 12-d
action mean; the latent prior is AR(1): z_t ~ N(alpha * z_{t-1}, 1 -
alpha^2) with z_prev masked to zero at episode starts. The rollout axis is
a Python loop, as the reference unrolls it in-graph.

Parameter names are the Flax scopes (rms, encoder/Dense_i, enc_mu,
enc_logvar, decoder/Dense_i, dec_mean, logstd), so `load_params` reads a
JAX parameter tree. The reparameterization normals come from a
torch.Generator, or are injected with `eps=` (the JAX net draws them from
its "z" rng). `use_lstm_encoder` is kept for the config's sake: the
reference builds an LSTM cell under it but never calls it, so its tree has
no such parameters, and the port builds none.
"""
import math
from typing import NamedTuple

import torch
from torch import nn

from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models.layers import MLP, RMS, dense

FUTURE_DIM = 72  # four future frames x (dpos 3, rotvec 3, joints 12): the PMC goal


class ZNetConfig(NamedTuple):
    z_len: int = 32
    embed_dim: int = 256
    prop_dim: int = 135  # prop (99) + prop_a (36)
    alpha: float = 0.95  # AR(1) coefficient (reference pmc_net_data.py:86)
    beta: float = 1.0  # KL weight
    logstd_init: float = -2.0
    activation: str = "relu"
    use_lstm_encoder: bool = False
    nlstm: int = 32

    @property
    def logvar_prior(self):
        return math.log(1.0 - self.alpha**2)


class ZNetOutputs(NamedTuple):
    mean: torch.Tensor  # (T, B, 12)
    logstd: torch.Tensor  # (T, B, 12)
    z: torch.Tensor  # (T, B, z_len)
    mu: torch.Tensor
    logvar: torch.Tensor
    z_prev: torch.Tensor  # (T, B, z_len)
    hs: torch.Tensor  # (B, z_len) final latent for carry-over
    rms_loss: torch.Tensor


def log_normal_pdf(x, mean, logvar):
    logvar = torch.as_tensor(logvar, dtype=x.dtype, device=x.device)
    log2pi = math.log(2.0 * math.pi)
    return torch.sum(-0.5 * ((x - mean) ** 2 * torch.exp(-logvar) + logvar + log2pi), dim=-1)


class ZNet(nn.Module):
    """obs (T, B, prop_dim + future_dim) -> ZNetOutputs; `future_dim` is the
    width of the future-goal features after the proprioception."""

    def __init__(self, cfg: ZNetConfig = ZNetConfig(), future_dim=FUTURE_DIM, generator=None):
        super().__init__()
        self.cfg = c = cfg
        self.rms = RMS(c.prop_dim + future_dim)
        self.encoder = MLP(future_dim + c.z_len, [c.embed_dim, c.embed_dim],
                           activation=c.activation, generator=generator)
        self.enc_mu = dense(c.embed_dim, c.z_len, 1.0, generator)
        self.enc_logvar = dense(c.embed_dim, c.z_len, 1.0, generator)
        self.decoder = MLP(c.prop_dim + c.z_len, [c.embed_dim, c.embed_dim],
                           activation=c.activation, generator=generator)
        self.dec_mean = dense(c.embed_dim, 12, 0.01, generator)
        self.logstd = nn.Parameter(torch.full((12,), float(c.logstd_init)))

    def forward(self, obs, z_init, masks, generator=None, eps=None):
        """obs: (T, B, D); z_init: (B, z_len); masks: (T, B), 1.0 at episode
        starts. eps: (T, B, z_len) standard normals (else drawn from
        `generator`)."""
        c = self.cfg
        ob_rms, rms_loss = self.rms(obs)
        prop = ob_rms[..., : c.prop_dim]
        future = ob_rms[..., c.prop_dim:]
        T = obs.shape[0]
        if eps is None:
            eps = torch.randn((T,) + tuple(z_init.shape), generator=generator, dtype=obs.dtype,
                              device=obs.device)
        z_prev = z_init
        ys = []
        for t in range(T):
            z_in = z_prev * (1.0 - masks[t][..., None])
            enc = self.encoder(torch.cat([future[t], z_in], dim=-1))
            mu = self.enc_mu(enc)
            logvar = self.enc_logvar(enc)
            z = mu + torch.exp(0.5 * logvar) * eps[t]
            dec = self.decoder(torch.cat([prop[t], z], dim=-1))
            ys.append((self.dec_mean(dec), z, mu, logvar, z_in))
            z_prev = z
        mean, z, mu, logvar, z_prevs = (torch.stack(col) for col in zip(*ys))
        return ZNetOutputs(mean=mean, logstd=self.logstd.expand(mean.shape), z=z, mu=mu,
                           logvar=logvar, z_prev=z_prevs, hs=z_prev, rms_loss=rms_loss)


def ar1_prior_loss(cfg: ZNetConfig, out: ZNetOutputs):
    """-(log p(z) - log q(z|x)) with the AR(1) prior (reference :187-190).
    out.z_prev is already zeroed at episode starts, so the prior mean alpha
    * z_prev is 0 there."""
    logpz = log_normal_pdf(out.z, cfg.alpha * out.z_prev, cfg.logvar_prior)
    logqz = log_normal_pdf(out.z, out.mu, out.logvar)
    return -torch.mean(logpz - logqz)


def load_params(net: ZNet, tree):
    """Load a Flax-layout ZNet parameter tree into `net`."""
    if not isinstance(net, ZNet):
        raise TypeError(f"expected a ZNet, got {type(net).__name__}")
    return P.load_flax_tree(net, tree)

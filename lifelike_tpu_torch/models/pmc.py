"""PMC network: VQ-VAE mocap-tracking policy with the reusable LLC decoder.

Port of lifelike_tpu.models.pmc (reference pmc_net/pmc_net.py):

  prop (+ stacked actions) --rms--+--> value MLP (2x256 tanh -> 1)
  future ------------------rms---+
                                 +--> encoder MLP (2x256 relu) -> z (32)
                                        -> VQ against a 256-entry codebook
                                           (straight-through estimator)
  LLC decoder: prop_embed(64) || z_embed(32) -> 2x256 relu -> DiagGaussian(12)

The codebook lives inside the `llc` submodule (`llc.embedding`, shaped
(z_len, num_embeddings) as in the Flax tree), so EPMC / SEPMC load the same
frozen LLC by path. Parameters are float32 unless the module is cast
(`.double()`); the forward runs in the parameters' dtype and device.
"""
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models.layers import (MLP, RMS, DiagGaussianHead, act_fn, batch_mean, dense,
                                             full_fp32)

PROP_DIM, PROP_A_DIM, FUTURE_DIM = 99, 36, 72  # envs.primitive observation widths


class PMCConfig(NamedTuple):
    # canonical values from reference train_scripts/example_pmc_train.sh:25-41
    z_len: int = 32
    num_embeddings: int = 256
    embed_dim: int = 256
    bot_neck_prop_embed_size: int = 64
    bot_neck_z_embed_size: int = 32
    rms_momentum: float = 1e-4
    logstd_init: float = -2.0
    append_hist_a: bool = True
    activation: str = "relu"
    z_prior_type: str = "VQ"  # {'VQ', 'Gaussian'}


class PMCOutputs(NamedTuple):
    mean: torch.Tensor  # (..., 12) action mean
    logstd: torch.Tensor  # (..., 12)
    value: torch.Tensor  # (..., 1)
    z: torch.Tensor  # (..., z_len) straight-through latent
    z_idx: torch.Tensor  # (...,) int codebook index (VQ)
    e_latent_loss: torch.Tensor  # scalar
    q_latent_loss: torch.Tensor  # scalar
    perplexity: torch.Tensor  # scalar
    rms_loss: torch.Tensor  # scalar
    kl_loss: torch.Tensor  # scalar (Gaussian prior variant)


def prop_width(cfg, prop_dim=PROP_DIM, prop_a_dim=PROP_A_DIM):
    return prop_dim + (prop_a_dim if cfg.append_hist_a else 0)


class LLC(nn.Module):
    """Low-level controller: (prop_rms, z) -> Gaussian action params.

    Holds the VQ codebook so PMC / EPMC / SEPMC share one frozen module
    (reference pmc_net.py:99-114, codebook :159-161).
    """

    def __init__(self, cfg: PMCConfig, prop_in, generator=None):
        super().__init__()
        c = self.cfg = cfg
        # variance_scaling(1.0, "fan_in", "uniform") over the Flax shape
        # (z_len, K): fan_in is z_len
        limit = (3.0 / c.z_len) ** 0.5
        self.embedding = nn.Parameter(
            (torch.rand((c.z_len, c.num_embeddings), generator=generator) * 2 - 1) * limit)
        self.prop_embed = dense(prop_in, c.bot_neck_prop_embed_size, generator=generator)
        self.z_embed = dense(c.z_len, c.bot_neck_z_embed_size, generator=generator)
        self.decoder = MLP(c.bot_neck_prop_embed_size + c.bot_neck_z_embed_size,
                           [c.embed_dim, c.embed_dim], activation=c.activation,
                           generator=generator)
        self.head = DiagGaussianHead(c.embed_dim, 12, logstd_init=c.logstd_init,
                                     generator=generator)

    def quantize(self, z_encode):
        """Nearest-codebook lookup with straight-through gradients; ties go to
        the first index, as jnp.argmin's."""
        cb = self.embedding
        d = (torch.sum(z_encode ** 2, -1, keepdim=True) - 2.0 * z_encode @ cb
             + torch.sum(cb ** 2, 0))
        idx = torch.argmin(d, dim=-1)
        quantized = self.lookup(idx)
        z_st = z_encode + (quantized - z_encode).detach()
        return z_st, quantized, idx

    def lookup(self, idx):
        """Codebook row (a row of the transpose) for an explicit index."""
        return F.embedding(idx.long(), self.embedding.T)

    def forward(self, prop_rms, z):
        act = act_fn(self.cfg.activation)
        pe = act(self.prop_embed(prop_rms))
        ze = act(self.z_embed(z))
        h = self.decoder(torch.cat([pe, ze], dim=-1))
        return self.head(h)

    decode = forward


class PMCNet(nn.Module):
    def __init__(self, cfg: PMCConfig = PMCConfig(), prop_dim=PROP_DIM, prop_a_dim=PROP_A_DIM,
                 future_dim=FUTURE_DIM, generator=None):
        super().__init__()
        c = self.cfg = cfg
        g = generator
        p_in = prop_width(c, prop_dim, prop_a_dim)
        self.prop_rms = RMS(p_in, c.rms_momentum)
        self.future_rms = RMS(future_dim, c.rms_momentum)
        self.vf = MLP(p_in + future_dim, [c.embed_dim, c.embed_dim], activation="tanh",
                      generator=g)
        self.value_out = dense(c.embed_dim, 1, generator=g)
        self.encoder = MLP(p_in + future_dim, [c.embed_dim, c.embed_dim],
                           activation=c.activation, generator=g)
        if c.z_prior_type == "VQ":
            self.z_out = dense(c.embed_dim, c.z_len, generator=g)
        else:
            self.z_mu = dense(c.embed_dim, c.z_len, generator=g)
            self.z_logvar = dense(c.embed_dim, c.z_len, generator=g)
        self.llc = LLC(c, p_in, generator=g)

    def _prop_in(self, prop, prop_a):
        if self.cfg.append_hist_a:
            return torch.cat([prop, prop_a], dim=-1)
        return prop

    def forward(self, prop, prop_a, future, generator=None, eps=None):
        """The Gaussian prior draws its noise from `generator`, or takes the
        standard normals `eps` (shaped as z) when given."""
        with full_fp32():
            return self._forward(prop, prop_a, future, generator, eps)

    def _forward(self, prop, prop_a, future, generator, eps):
        c = self.cfg
        prop_rms, prop_loss = self.prop_rms(self._prop_in(prop, prop_a))
        future_rms, future_loss = self.future_rms(future)
        rms_loss = prop_loss + future_loss
        ob_rms = torch.cat([prop_rms, future_rms], dim=-1)

        value = self.value_out(self.vf(ob_rms))

        enc = self.encoder(ob_rms)
        zero = torch.zeros((), dtype=prop.dtype, device=prop.device)
        if c.z_prior_type == "VQ":
            z_encode = self.z_out(enc)
            z, quantized, idx = self.llc.quantize(z_encode)
            e_latent = torch.mean((quantized.detach() - z_encode) ** 2)
            q_latent = torch.mean((quantized - z_encode.detach()) ** 2)
            one_hot = F.one_hot(idx, c.num_embeddings).to(prop.dtype)
            avg = batch_mean(one_hot.reshape(-1, c.num_embeddings))
            perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
            kl = zero
        else:  # Gaussian reparameterized latent (reference pmc_net.py:150-155)
            mu = self.z_mu(enc)
            logvar = self.z_logvar(enc)
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                                  device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
            idx = torch.zeros(z.shape[:-1], dtype=torch.int32, device=z.device)
            e_latent = q_latent = perplexity = zero
            kl = torch.mean(0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - 1.0 - logvar, -1))

        mean, logstd = self.llc(prop_rms, z)
        return PMCOutputs(mean=mean, logstd=logstd, value=value, z=z, z_idx=idx,
                          e_latent_loss=e_latent, q_latent_loss=q_latent,
                          perplexity=perplexity, rms_loss=rms_loss, kl_loss=kl)

    def decode_only(self, prop, prop_a, z):
        """rms + LLC decode for an externally chosen latent (EPMC path)."""
        with full_fp32():
            prop_rms, _ = self.prop_rms(self._prop_in(prop, prop_a))
            return self.llc(prop_rms, z)

    def decode_index(self, prop, prop_a, z_idx):
        """LLC decode for a discrete codebook index (EPMC A_Z action path)."""
        with full_fp32():
            prop_rms, _ = self.prop_rms(self._prop_in(prop, prop_a))
            return self.llc(prop_rms, self.llc.lookup(z_idx))


def load_params(net: PMCNet, tree):
    """Load a Flax-layout PMCNet parameter tree (`{"params": {...}}` as
    `PMCNet().init` and the ModelPool files hold it) into `net`."""
    if not isinstance(net, PMCNet):
        raise TypeError(f"expected a PMCNet, got {type(net).__name__}")
    return P.load_flax_tree(net, tree)


def restart_dead_codes(net: PMCNet, usage, rng, min_frac=1.0 / 1024.0, jitter=0.03):
    """Host-side VQ dead-code restart (codebook-collapse counter-measure).

    Port of lifelike_tpu.models.pmc.restart_dead_codes: every code whose
    recent usage fraction is below `min_frac` is set to a usage-weighted
    random LIVE code plus small jitter, so the next nearest-neighbour
    assignment splits that live code's cluster. Host numpy on the codebook's
    values and `rng` (a numpy Generator), as the JAX package computes it, so
    the same usage and generator give the same codebook; the result is
    written into `net.llc.embedding` in place (no gradient; the optimizer's
    moments are left alone). usage: (K,) recent selection counts (the
    learner's "code_counts" EMA). Returns the number of codes restarted.
    """
    emb = net.llc.embedding
    cb = emb.detach().cpu().numpy()  # (z_len, K)
    usage = np.asarray(usage, np.float64)
    total = usage.sum()
    if total <= 0:
        return 0
    dead = usage < min_frac * total
    n = int(dead.sum())
    if n == 0 or n == cb.shape[1]:
        return 0
    live_p = np.where(dead, 0.0, usage)
    live_p = live_p / live_p.sum()
    donors = rng.choice(cb.shape[1], size=n, p=live_p)
    scale = cb[:, ~dead].std() + 1e-6
    cb2 = cb.copy()
    cb2[:, dead] = cb[:, donors] + jitter * scale * rng.standard_normal((cb.shape[0], n))
    with torch.no_grad():
        emb.copy_(torch.as_tensor(cb2))
    return n

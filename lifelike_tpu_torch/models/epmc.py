"""EPMC network: mid-level controller (MLC) over the frozen PMC LLC.

Port of lifelike_tpu.models.epmc (reference epmc_net/epmc_net.py),
canonical dims from train_scripts/example_epmc_train.sh:25-52:

  perception encoders (:83-131):
    percep_2d / percep_front: conv2d 4@1x1 -> 4@4x4 s2 -> 4@2x2 s2 -> 1@2x2,
      relu, SAME padding, flattened
    percep_1d: circular-padded conv1d stack 4@4 -> 4@4 s2 -> 4@4 s2 -> 1@4
    target vec: FC 32
    concat -> FC 64 (usr_cmd embed)
  mlc_encoder (:134-163): prop-embed 64 || usr_cmd 64 -> FC 256 -> LayerNorm
    LSTM (nlstm 32) -> 256-way categorical z logits
  z index -> 32-d codebook row of the frozen PMC LLC -> LLC decode
  value tower (:224-241): prop FC 128 tanh || usr_cmd FC 128 tanh -> FC 256
    tanh -> LSTM -> n_v values (own hidden-state slice)

Hidden state layout hs = [vf 64 | pi 64 | z 64]; each 64 = (c 32, h 32).
llc_light has no pi LSTM, so hs_pi passes through as zeros.

Flax's padding="SAME" is TensorFlow's: at stride 2 it pads asymmetrically
(less before than after), which torch's padding="same" does not do, so the
convolutions pad explicitly. Convolutions take (N, C, ...) inputs; the
leading batch axes of an observation are flattened around them.
"""
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models.layers import RMS, act_fn, categorical_sample, dense, full_fp32
from lifelike_tpu_torch.models.pmc import LLC, PMCConfig

PROP_IN = 135  # prop (99) || prop_a (36): the playground / chase observation
PERCEP_2D = (25, 13)  # height map rows x cols (envs.playground)
LIDAR = 128


class EPMCConfig(NamedTuple):
    z_len: int = 256  # categorical codebook entries
    z_len_llc: int = 32  # codebook row dim
    nlstm: int = 32
    hs_slice: int = 64  # 2 * nlstm per lstm head
    embed_dim: int = 256
    bot_neck_prop_embed_size: int = 64
    bot_neck_z_embed_size: int = 32
    rms_momentum: float = 1e-4
    n_v: int = 1
    append_hist_a: bool = True
    activation: str = "relu"

    @property
    def hs_len(self):
        return 3 * self.hs_slice

    @property
    def llc_cfg(self):
        return PMCConfig(
            z_len=self.z_len_llc,
            num_embeddings=self.z_len,
            bot_neck_prop_embed_size=self.bot_neck_prop_embed_size,
            bot_neck_z_embed_size=self.bot_neck_z_embed_size,
        )


def _same(n, k, s):
    """TensorFlow SAME padding (before, after) of an axis of length n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal(shape, generator):
    std = (1.0 / shape[0]) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _conv(cls, cin, cout, k, generator):
    """A conv with lecun-normal weights and a zero bias (Flax nn.Conv's
    defaults), drawn in the Flax kernel layout."""
    conv = cls(cin, cout, k)
    w = _lecun_normal((math.prod(conv.weight.shape[1:]), cout), generator)
    with torch.no_grad():
        # fan_in ordering is irrelevant to the draw's distribution
        conv.weight.copy_(w.T.reshape(conv.weight.shape))
        conv.bias.zero_()
    return conv


class LayerNormLSTMCell(nn.Module):
    """TLeague-compatible layer-norm LSTM (reference lstm_cell_type='lstm',
    lstm_layer_norm=True, forget_bias=1.0 — epmc_net_data.py:81-85):

        z = LN(x @ wx; g_x, b_x) + LN(h @ wh; g_h, b_h) + b
        i, f, o, u = split(z, 4)
        c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(u)
        h' = sigmoid(o) * tanh(LN(c'; g_c, b_c))

    State packed as hs = concat[c, h]. Layer norms use population variance
    and eps 1e-12 (tf.contrib.layers.layer_norm).
    """

    def __init__(self, in_features, features, forget_bias=1.0, ln_eps=1e-12, generator=None):
        super().__init__()
        nh = self.features = features
        self.forget_bias = forget_bias
        self.ln_eps = ln_eps
        self.wx = nn.Parameter(_lecun_normal((in_features, 4 * nh), generator))
        self.wh = nn.Parameter(_lecun_normal((nh, 4 * nh), generator))
        self.b = nn.Parameter(torch.zeros(4 * nh))
        for name, n in (("ln_x", 4 * nh), ("ln_h", 4 * nh), ("ln_c", nh)):
            setattr(self, f"{name}_gamma", nn.Parameter(torch.ones(n)))
            setattr(self, f"{name}_beta", nn.Parameter(torch.zeros(n)))

    def _ln(self, v, name):
        mu = v.mean(-1, keepdim=True)
        var = v.var(-1, keepdim=True, correction=0)
        gamma, beta = getattr(self, f"{name}_gamma"), getattr(self, f"{name}_beta")
        return gamma * (v - mu) * torch.rsqrt(var + self.ln_eps) + beta

    def forward(self, hs, x):
        c, h = torch.chunk(hs, 2, dim=-1)
        z = self._ln(x @ self.wx, "ln_x") + self._ln(h @ self.wh, "ln_h") + self.b
        i, f, o, u = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f + self.forget_bias) * c + torch.sigmoid(i) * torch.tanh(u)
        h = torch.sigmoid(o) * torch.tanh(self._ln(c, "ln_c"))
        return torch.cat([c, h], dim=-1), h


class Percep2DEncoder(nn.Module):
    """(..., H, W) height map -> (..., H' * W') features."""

    LAYERS = ((1, 4, 1, 1), (4, 4, 4, 2), (4, 4, 2, 2), (4, 1, 2, 1))  # cin, cout, k, s

    def __init__(self, activation="relu", generator=None):
        super().__init__()
        self.activation = activation
        for i, (cin, cout, k, _) in enumerate(self.LAYERS):
            setattr(self, f"Conv_{i}", _conv(nn.Conv2d, cin, cout, k, generator))

    @classmethod
    def width(cls, shape):
        h, w = shape
        for *_, s in cls.LAYERS:
            h, w = -(-h // s), -(-w // s)
        return h * w * cls.LAYERS[-1][1]

    def forward(self, x):
        act = act_fn(self.activation)
        lead = x.shape[:-2]
        h = x.reshape((-1, 1) + tuple(x.shape[-2:]))
        for i, (_, _, k, s) in enumerate(self.LAYERS):
            conv = getattr(self, f"Conv_{i}")
            (t, b), (l, r) = _same(h.shape[-2], k, s), _same(h.shape[-1], k, s)
            h = act(F.conv2d(F.pad(h, (l, r, t, b)), conv.weight, conv.bias, stride=s))
        # Flax flattens (H', W', C)
        return h.permute(0, 2, 3, 1).reshape(lead + (-1,))


class Percep1DEncoder(nn.Module):
    """(..., 128) circular lidar -> (..., 32) features: padded circularly by
    `kernel` on both ends, then sliced back after the first conv."""

    LAYERS = ((1, 4, 1), (4, 4, 2), (4, 4, 2), (4, 1, 1))  # cin, cout, stride

    def __init__(self, activation="relu", kernel=4, generator=None):
        super().__init__()
        self.activation = activation
        self.kernel = kernel
        for i, (cin, cout, _) in enumerate(self.LAYERS):
            setattr(self, f"Conv_{i}", _conv(nn.Conv1d, cin, cout, kernel, generator))

    @classmethod
    def width(cls, n):
        for *_, s in cls.LAYERS[1:]:
            n = -(-n // s)
        return n * cls.LAYERS[-1][1]

    def forward(self, x):
        act = act_fn(self.activation)
        k = self.kernel
        lead = x.shape[:-1]
        h = torch.cat([x[..., -k:], x, x[..., :k]], dim=-1).reshape(-1, 1, x.shape[-1] + 2 * k)
        for i, (_, _, s) in enumerate(self.LAYERS):
            conv = getattr(self, f"Conv_{i}")
            h = act(F.conv1d(F.pad(h, _same(h.shape[-1], k, s)), conv.weight, conv.bias,
                             stride=s))
            if i == 0:
                h = h[..., k:-k]
        return h.permute(0, 2, 1).reshape(lead + (-1,))


class UsrCmdEncoder(nn.Module):
    """Perception-command encoder (reference epmc_net.py:117-131,
    sepmc_net.py mlc_usr_cmd_encoder). The vec branch (target fc 3->32)
    exists only with `with_vec` — the SEPMC value / HLC towers encode
    percepts alone (bottleneck 88->64), the MLC proper gets target_info
    (bottleneck 120->64)."""

    def __init__(self, cfg: EPMCConfig, with_vec=True, percep_2d=PERCEP_2D,
                 percep_front=PERCEP_2D, lidar=LIDAR, target_dim=3, generator=None):
        super().__init__()
        self.cfg = cfg
        self.percep_2d = Percep2DEncoder(cfg.activation, generator)
        self.percep_1d = Percep1DEncoder(cfg.activation, generator=generator)
        self.percep_front = Percep2DEncoder(cfg.activation, generator)
        width = (Percep2DEncoder.width(percep_2d) + Percep1DEncoder.width(lidar)
                 + Percep2DEncoder.width(percep_front))
        self.with_vec = with_vec
        if with_vec:
            self.vec_fc = dense(target_dim, 32, generator=generator)
            width += 32
        self.bottleneck = dense(width, cfg.bot_neck_prop_embed_size, generator=generator)

    def forward(self, percep_2d, percep_1d, percep_front, target=None):
        act = act_fn(self.cfg.activation)
        embeds = [self.percep_2d(percep_2d), self.percep_1d(percep_1d),
                  self.percep_front(percep_front)]
        if self.with_vec:
            embeds = [act(self.vec_fc(target))] + embeds
        return act(self.bottleneck(torch.cat(embeds, dim=-1)))


class EPMCOutputs(NamedTuple):
    z_logits: torch.Tensor  # (..., 256)
    z_idx: torch.Tensor  # (...,)
    mean: torch.Tensor  # (..., 12) LLC action mean
    logstd: torch.Tensor  # (..., 12)
    value: torch.Tensor  # (..., n_v)
    hs: torch.Tensor  # (..., 192) new hidden state
    rms_loss: torch.Tensor


def getter(obs):
    return obs.get if isinstance(obs, dict) else (lambda k: getattr(obs, k))


class EPMCNet(nn.Module):
    def __init__(self, cfg: EPMCConfig = EPMCConfig(), prop_in=PROP_IN, generator=None):
        super().__init__()
        c = self.cfg = cfg
        g = generator
        d = c.bot_neck_prop_embed_size
        self.prop_rms = RMS(prop_in, c.rms_momentum)
        # value tower
        self.vf_fc1 = dense(prop_in, c.embed_dim // 2, generator=g)
        self.vf_cmd = UsrCmdEncoder(c, generator=g)
        self.vf_fc2 = dense(d, c.embed_dim // 2, generator=g)
        self.vf_fc3 = dense(c.embed_dim, c.embed_dim, generator=g)
        self.vf_lstm = LayerNormLSTMCell(c.embed_dim, c.nlstm, generator=g)
        self.value_out = dense(c.nlstm, c.n_v, generator=g)
        # policy tower (mlc_encoder)
        self.pi_prop_embed = dense(prop_in, d, generator=g)
        self.pi_cmd = UsrCmdEncoder(c, generator=g)
        self.pi_fc = dense(2 * d, c.embed_dim, generator=g)
        self.pi_lstm = LayerNormLSTMCell(c.embed_dim, c.nlstm, generator=g)
        self.z_out = dense(c.nlstm, c.z_len, generator=g)
        # frozen LLC (codebook + decoder), loaded from the PMC checkpoint
        self.llc = LLC(c.llc_cfg, prop_in, generator=g)

    def forward(self, obs, hs, mask, z_idx=None, generator=None):
        """obs: PlaygroundObs-like namedtuple / dict; hs: (..., 192); mask:
        (...,) 1.0 at episode starts (resets the LSTM state); z_idx: given
        codebook indices ('outer-fed') or None to sample from `generator`
        ('self-fed')."""
        with full_fp32():
            return self._forward(obs, hs, mask, z_idx, generator)

    def _forward(self, obs, hs, mask, z_idx, generator):
        c = self.cfg
        act = act_fn(c.activation)
        get = getter(obs)

        x = get("prop")
        if c.append_hist_a:
            x = torch.cat([x, get("prop_a")], dim=-1)
        prop_rms, rms_loss = self.prop_rms(x)

        keep = (1.0 - mask)[..., None]
        hs_vf = hs[..., : c.hs_slice] * keep
        hs_z = hs[..., 2 * c.hs_slice:] * keep
        cmd = (get("percep_2d"), get("percep_1d"), get("percep_front"), get("target"))

        # value
        v1 = torch.tanh(self.vf_fc1(prop_rms))
        v2 = torch.tanh(self.vf_fc2(self.vf_cmd(*cmd)))
        v = torch.tanh(self.vf_fc3(torch.cat([v1, v2], dim=-1)))
        hs_vf_new, v_emb = self.vf_lstm(hs_vf, v)
        value = self.value_out(v_emb)

        # policy: z logits
        pe = act(self.pi_prop_embed(prop_rms))
        ce = self.pi_cmd(*cmd)
        h = act(self.pi_fc(torch.cat([pe, ce], dim=-1)))
        hs_z_new, z_emb = self.pi_lstm(hs_z, h)
        z_logits = self.z_out(z_emb)

        if z_idx is None:
            z_idx = categorical_sample(generator, z_logits)

        mean, logstd = self.llc(prop_rms, self.llc.lookup(z_idx))

        hs_pi_new = torch.zeros_like(hs_vf_new)  # llc_light: no pi LSTM (:256)
        hs_new = torch.cat([hs_vf_new, hs_pi_new, hs_z_new], dim=-1)
        return EPMCOutputs(z_logits=z_logits, z_idx=z_idx, mean=mean, logstd=logstd,
                           value=value, hs=hs_new, rms_loss=rms_loss)

    def initial_state(self, batch=(), device=None, dtype=None):
        p = self.prop_rms.moving_mean
        return torch.zeros(tuple(batch) + (self.cfg.hs_len,), device=device or p.device,
                           dtype=dtype or p.dtype)


def load_params(net: EPMCNet, tree):
    """Load a Flax-layout EPMCNet parameter tree into `net`."""
    if not isinstance(net, EPMCNet):
        raise TypeError(f"expected an EPMCNet, got {type(net).__name__}")
    return P.load_flax_tree(net, tree)

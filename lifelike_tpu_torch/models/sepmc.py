"""SEPMC network: high-level controller (HLC) over frozen MLC + LLC.

Port of lifelike_tpu.models.sepmc (reference sepmc_net/sepmc_net.py):

  hlc_usr_cmd (percept_vec 5 + oppo_info 15 + flag_info 7 + with_flag 2)
    -> FC 64 -> FC 64 (:117-124)
  hlc_encoder (:127-152): prop embed 64 || mlc_cmd embed 64 || hlc_cmd embed
    -> FC 256 -> LayerNorm LSTM -> 1-d Gaussian steering angle, mean clipped
    to +-pi, learned state-independent logvar
  angle -> target_info = [cos, sin, control_spd] injected into the MLC's
    command (:300-308); frozen MLC emits the 256-way z; frozen LLC decodes
    the 12-d action
  value tower (:271-289): prop / mlc cmd / CHEAT hlc cmd (true opponent and
    flag state) -> concat -> FC 256 tanh -> LSTM -> n_v

Hidden state hs = [vf 64 | pi 64 | z 64 | hlc 64]; the pi slice is zeros
under llc_light. Sampling of the angle and of z uses the caller's
torch.Generator.
"""
import math
from typing import NamedTuple

import torch
from torch import nn

from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models.epmc import (PROP_IN, EPMCConfig, LayerNormLSTMCell,
                                            UsrCmdEncoder, getter)
from lifelike_tpu_torch.models.layers import RMS, act_fn, categorical_sample, dense, full_fp32
from lifelike_tpu_torch.models.pmc import LLC

HLC_CMD_IN = 5 + 15 + 7 + 2  # percept_vec, oppo_info, flag_info, with_flag


class SEPMCConfig(NamedTuple):
    epmc: EPMCConfig = EPMCConfig()
    hlc_logvar_init: float = -0.5
    n_v: int = 1
    outer_control_spd: bool = True

    @property
    def hs_slice(self):
        return self.epmc.hs_slice

    @property
    def hs_len(self):
        return 4 * self.epmc.hs_slice


class HLCUsrCmdEncoder(nn.Module):
    def __init__(self, cfg: SEPMCConfig, in_features=HLC_CMD_IN, generator=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.epmc.bot_neck_prop_embed_size
        self.Dense_0 = dense(in_features, d, generator=generator)
        self.Dense_1 = dense(d, d, generator=generator)

    def forward(self, percept_vec, oppo_info, flag_info, with_flag):
        act = act_fn(self.cfg.epmc.activation)
        x = torch.cat([percept_vec, oppo_info, flag_info, with_flag], dim=-1)
        return act(self.Dense_1(act(self.Dense_0(x))))


class SEPMCOutputs(NamedTuple):
    hlc_mean: torch.Tensor  # (..., 1) steering angle mean in [-pi, pi]
    hlc_logstd: torch.Tensor  # (..., 1)
    hlc_angle: torch.Tensor  # (..., 1) sampled / provided angle
    z_logits: torch.Tensor  # (..., 256)
    z_idx: torch.Tensor  # (...,)
    mean: torch.Tensor  # (..., 12)
    logstd: torch.Tensor  # (..., 12)
    value: torch.Tensor  # (..., n_v)
    hs: torch.Tensor  # (..., 256)
    rms_loss: torch.Tensor


class SEPMCNet(nn.Module):
    def __init__(self, cfg: SEPMCConfig = SEPMCConfig(), prop_in=PROP_IN, generator=None):
        super().__init__()
        c = self.cfg = cfg
        e = c.epmc
        g = generator
        d, ed = e.bot_neck_prop_embed_size, e.embed_dim
        self.prop_rms = RMS(prop_in, e.rms_momentum)
        # value towers (cheat obs)
        self.vf_fc1 = dense(prop_in, ed // 2, generator=g)
        self.vf_mlc_cmd = UsrCmdEncoder(e, with_vec=False, generator=g)
        self.vf_fc2 = dense(d, ed // 2, generator=g)
        self.vf_hlc_cmd = HLCUsrCmdEncoder(c, generator=g)
        self.vf_fc3 = dense(d, ed // 2, generator=g)
        self.vf_fc4 = dense(3 * (ed // 2), ed, generator=g)
        self.vf_lstm = LayerNormLSTMCell(ed, e.nlstm, generator=g)
        self.value_out = dense(e.nlstm, c.n_v, generator=g)
        # HLC
        self.hlc_prop_embed = dense(prop_in, d, generator=g)
        self.hlc_mlc_cmd = UsrCmdEncoder(e, with_vec=False, generator=g)
        self.hlc_cmd = HLCUsrCmdEncoder(c, generator=g)
        self.hlc_fc = dense(3 * d, ed, generator=g)
        self.hlc_lstm = LayerNormLSTMCell(ed, e.nlstm, generator=g)
        self.hlc_mu = dense(e.nlstm, 1, scale=0.01, generator=g)
        self.hlc_logvar = nn.Parameter(torch.full((1,), float(c.hlc_logvar_init)))
        # frozen MLC (same submodule family as EPMCNet's policy tower)
        self.mlc_prop_embed = dense(prop_in, d, generator=g)
        self.mlc_cmd = UsrCmdEncoder(e, with_vec=True, generator=g)
        self.mlc_fc = dense(2 * d, ed, generator=g)
        self.mlc_lstm = LayerNormLSTMCell(ed, e.nlstm, generator=g)
        self.z_out = dense(e.nlstm, e.z_len, generator=g)
        # frozen LLC
        self.llc = LLC(e.llc_cfg, prop_in, generator=g)

    def forward(self, obs, hs, mask, a_hlc=None, a_z=None, generator=None):
        """obs: ChaseTagObs-like per-agent dict / namedtuple (the agent axis
        is a batch axis); a_hlc / a_z: given actions, or None to sample them
        from `generator`."""
        with full_fp32():
            return self._forward(obs, hs, mask, a_hlc, a_z, generator)

    def _forward(self, obs, hs, mask, a_hlc, a_z, generator):
        c = self.cfg
        e = c.epmc
        act = act_fn(e.activation)
        get = getter(obs)

        x = get("prop")
        if e.append_hist_a:
            x = torch.cat([x, get("prop_a")], dim=-1)
        prop_rms, rms_loss = self.prop_rms(x)

        sl = c.hs_slice
        keep = (1.0 - mask)[..., None]
        hs_vf = hs[..., :sl] * keep
        hs_z = hs[..., 2 * sl:3 * sl] * keep
        hs_hlc = hs[..., 3 * sl:] * keep

        p2d, p1d, pfr = get("percept_2d"), get("percept_1d"), get("percept_front")

        # value (cheat obs); the vf / hlc MLC-command encoders see percepts
        # only — no target branch (reference sepmc_net.py:275, :131)
        v1 = torch.tanh(self.vf_fc1(prop_rms))
        v2 = torch.tanh(self.vf_fc2(self.vf_mlc_cmd(p2d, p1d, pfr)))
        v3 = torch.tanh(self.vf_fc3(self.vf_hlc_cmd(
            get("percept_vec"), get("oppo_info_cheat"), get("flag_info_cheat"),
            get("with_flag"))))
        v = torch.tanh(self.vf_fc4(torch.cat([v1, v2, v3], dim=-1)))
        hs_vf_new, v_emb = self.vf_lstm(hs_vf, v)
        value = self.value_out(v_emb)

        # HLC: steering angle
        he = act(self.hlc_prop_embed(prop_rms))
        hm = self.hlc_mlc_cmd(p2d, p1d, pfr)
        hc = self.hlc_cmd(get("percept_vec"), get("oppo_info"), get("flag_info"),
                          get("with_flag"))
        h = act(self.hlc_fc(torch.cat([he, hm, hc], dim=-1)))
        hs_hlc_new, h_emb = self.hlc_lstm(hs_hlc, h)
        hlc_mean = torch.clamp(self.hlc_mu(h_emb), -math.pi, math.pi)
        hlc_logstd = (0.5 * self.hlc_logvar).expand(hlc_mean.shape)

        if a_hlc is None:
            eps = torch.randn(hlc_mean.shape, generator=generator, dtype=hlc_mean.dtype,
                              device=hlc_mean.device)
            a_hlc = hlc_mean + torch.exp(hlc_logstd) * eps

        # target_info injection (:300-308)
        target_info = torch.cat([torch.cos(a_hlc), torch.sin(a_hlc), get("control_spd")],
                                dim=-1)

        # frozen MLC -> z
        pe = act(self.mlc_prop_embed(prop_rms))
        ce = self.mlc_cmd(p2d, p1d, pfr, target_info)
        m = act(self.mlc_fc(torch.cat([pe, ce], dim=-1)))
        hs_z_new, z_emb = self.mlc_lstm(hs_z, m)
        z_logits = self.z_out(z_emb)
        if a_z is None:
            a_z = categorical_sample(generator, z_logits)

        mean, logstd = self.llc(prop_rms, self.llc.lookup(a_z))

        hs_pi_new = torch.zeros_like(hs_vf_new)
        hs_new = torch.cat([hs_vf_new, hs_pi_new, hs_z_new, hs_hlc_new], dim=-1)
        return SEPMCOutputs(hlc_mean=hlc_mean, hlc_logstd=hlc_logstd, hlc_angle=a_hlc,
                            z_logits=z_logits, z_idx=a_z, mean=mean, logstd=logstd,
                            value=value, hs=hs_new, rms_loss=rms_loss)

    def initial_state(self, batch=(), device=None, dtype=None):
        p = self.prop_rms.moving_mean
        return torch.zeros(tuple(batch) + (self.cfg.hs_len,), device=device or p.device,
                           dtype=dtype or p.dtype)


def load_params(net: SEPMCNet, tree):
    """Load a Flax-layout SEPMCNet parameter tree into `net`."""
    if not isinstance(net, SEPMCNet):
        raise TypeError(f"expected a SEPMCNet, got {type(net).__name__}")
    return P.load_flax_tree(net, tree)

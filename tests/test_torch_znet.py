"""The z network, the distillation losses / step and the profiling utilities
of lifelike_tpu_torch vs the JAX reference, on the CPU.

Item 1, float64 at 1e-9 against one jitted JAX function: ZNet's forward
(the parameter layout from jax.eval_shape, filled with seeded numpy; the
reparameterization normals JAX drew from its "z" rng recovered from its own
outputs, (z - mu) / exp(logvar / 2), and injected), ar1_prior_loss, the three
distill losses, teacher_ratio and one znet_distill_step (ClipAdam against
optax's clip + adam). Item 2: utils.profiling — speed_of_light on explicit
counts, cost_analysis of a matmul (2mnk, as XLA reports), chained_latency
(positive on the CPU), detect_chip's fallback and its H100 entry, trace.
"""
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.learning import distill as jdistill
from lifelike_tpu.models import z_net as jz_net
from lifelike_tpu.utils import profiling as jprofiling
from lifelike_tpu_torch.learning import distill
from lifelike_tpu_torch.models import params, z_net
from lifelike_tpu_torch.utils import profiling

from tests.torch_port_util import F64, assert_close

CFG = dict(z_len=8, embed_dim=16, prop_dim=10)
FUT, T, BATCH = 6, 3, 4
TOL = dict(rtol=1e-9, atol=1e-9)


def _batch(rng):
    obs = rng.standard_normal((T, BATCH, CFG["prop_dim"] + FUT))
    masks = np.zeros((T, BATCH))
    masks[1, 0] = 1.0  # robot 0's episode restarts at step 1
    return dict(obs=obs, masks=masks, z_init=0.5 * rng.standard_normal((BATCH, CFG["z_len"])),
                teacher_mean=0.3 * rng.standard_normal((T, BATCH, 12)),
                teacher_logstd=-1.0 + 0.1 * rng.standard_normal((T, BATCH, 12)),
                teacher_action=0.3 * rng.standard_normal((T, BATCH, 12)))


def _tree(rng, net, b):
    """A float64 Flax parameter tree of `net` in its init layout, seeded."""
    shapes = jax.eval_shape(functools.partial(net.init, {"params": jax.random.PRNGKey(0),
                                                         "z": jax.random.PRNGKey(0)}),
                            b["obs"], b["z_init"], b["masks"])

    def leaf(path, s):
        name = path[-1].key
        if name == "moving_std":
            return 0.5 + rng.uniform(size=s.shape)
        if name == "logstd":
            return -1.0 + 0.1 * rng.standard_normal(s.shape)
        scale = 1.0 / np.sqrt(s.shape[0]) if name == "kernel" else 0.2
        return scale * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _reference():
    """Every JAX result of item 1 (one jit)."""
    rng = np.random.default_rng(71)
    b = _batch(rng)
    jcfg = jz_net.ZNetConfig(**CFG)
    net = jz_net.ZNet(jcfg)
    tree = _tree(rng, net, b)
    key = jax.random.PRNGKey(5)
    dcfgs = [jdistill.DistillConfig(loss_type=t, action_var=0.4, learning_rate=1e-2,
                                    max_grad_norm=m, beta=0.7)
             for t, m in (("standard", 0.5), ("action_var", 100.0), ("supervised", 0.5))]

    @jax.jit
    def run(tree, b, key):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        out = net.apply(tree, jb["obs"], jb["z_init"], jb["masks"], rngs={"z": key})
        losses = [jdistill.distill_loss(d, out.mean, out.logstd, jb["teacher_mean"],
                                        jb["teacher_logstd"], jb["teacher_action"])
                  for d in dcfgs]
        ratios = [jdistill.teacher_ratio(dcfgs[0], jnp.asarray(s, jnp.float64))
                  for s in (0.0, 2.5e4, 1e5, 3e5)]
        steps = []
        for d in dcfgs:
            opt = jdistill.make_distill_optimizer(d)
            batch = dict(jb)
            if d.loss_type != "standard":
                batch.pop("teacher_mean")
            p, _, m = jdistill.znet_distill_step(net, d, opt, tree, opt.init(tree), batch, key)
            steps.append((p, m))
        return out, jz_net.ar1_prior_loss(jcfg, out), losses, ratios, steps

    return b, tree, run(tree, b, key), dcfgs


def _net(tree):
    net = z_net.ZNet(z_net.ZNetConfig(**CFG), future_dim=FUT).double()
    return z_net.load_params(net, jax.tree.map(np.asarray, tree))


def test_znet_and_distill_match_reference():
    b, tree, (jout, jprior, jlosses, jratios, jsteps), dcfgs = _reference()
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    eps = (torch.as_tensor(np.array(jout.z)) - torch.as_tensor(np.array(jout.mu))) \
        / torch.exp(0.5 * torch.as_tensor(np.array(jout.logvar)))
    net = _net(tree)
    assert params.flax_tree(net).keys() == {"params"}
    with torch.no_grad():
        out = net(tb["obs"], tb["z_init"], tb["masks"], eps=eps)
    for name, got, want in zip(out._fields, out, jout):
        assert_close(got, want, **TOL)
    assert float(out.z_prev[1, 0].abs().max()) == 0.0  # masked at the episode start
    assert_close(z_net.ar1_prior_loss(net.cfg, out), jprior, **TOL)
    ports = [distill.DistillConfig(*d) for d in dcfgs]
    for d, want in zip(ports, jlosses):
        got = distill.distill_loss(d, out.mean, out.logstd, tb["teacher_mean"],
                                   tb["teacher_logstd"], tb["teacher_action"])
        assert_close(got, want, **TOL)
    for s, want in zip((0.0, 2.5e4, 1e5, 3e5), jratios):
        assert_close(distill.teacher_ratio(ports[0], torch.tensor(s, dtype=F64)), want, **TOL)
    with pytest.raises(ValueError):
        distill.distill_loss(ports[0], out.mean, out.logstd, tb["teacher_mean"])

    for d, (jp, jm) in zip(ports, jsteps):
        net = _net(tree)
        batch = dict(tb)
        if d.loss_type != "standard":
            batch.pop("teacher_mean")
        m = distill.znet_distill_step(net, d, distill.make_distill_optimizer(d, net), batch,
                                      eps=eps)
        for k, v in jm.items():
            assert_close(m[k], v, **TOL)
        want = _net(jp)
        for (k, p), q in zip(net.named_parameters(), want.parameters()):
            assert_close(p.detach(), q.detach(), rtol=1e-9, atol=1e-9)

    # the actor mixing: all teacher at ratio 1, all student at ratio 0, else
    # a Bernoulli draw per row from the generator
    g = torch.Generator().manual_seed(0)
    ta, sa = torch.ones((4000, 12)), torch.zeros((4000, 12))
    assert torch.equal(distill.mix_actions(g, ports[0], 0, ta, sa), ta)
    assert torch.equal(distill.mix_actions(g, ports[0], 10 ** 6, ta, sa), sa)
    mixed = distill.mix_actions(g, ports[0], 25_000, ta, sa)
    assert bool((mixed == mixed[:, :1]).all()) and abs(float(mixed[:, 0].mean()) - 0.75) < 0.03


def test_profiling_roofline_flops_latency_and_chip(tmp_path):
    spec = profiling.ChipSpec("fake", 1e12, 5e11, 1e11, 700.0)
    r = profiling.speed_of_light(flops=1e9, bytes_accessed=1e7, spec=spec, measured_s=2e-3)
    jr = jprofiling.speed_of_light(flops=1e9, bytes_accessed=1e7, measured_s=2e-3,
                                   spec=jprofiling.ChipSpec("fake", 1e12, 2e12, 1e11, 1 << 20))
    assert tuple(r) == tuple(jr)
    assert "50.0% of speed of light" in profiling.format_report(r)
    assert profiling.format_report(r) == jprofiling.format_report(jr)
    r64 = profiling.speed_of_light(flops=1e9, bytes_accessed=1e7, spec=spec, dtype_peak="f64")
    assert np.isclose(r64.t_compute_s, 2e-3) and r64.achieved_fraction is None

    a = torch.zeros((256, 128), dtype=torch.float32)
    w = torch.zeros((128, 64), dtype=torch.float32)
    assert profiling.cost_analysis(lambda x, y: x @ y, a, w)["flops"] == 2 * 256 * 128 * 64
    jca = jprofiling.cost_analysis(lambda x, y: x @ y, jnp.zeros((256, 128), jnp.float32),
                                   jnp.zeros((128, 64), jnp.float32))
    assert jca["flops"] == 2 * 256 * 128 * 64  # XLA counts the same
    r = profiling.speed_of_light(lambda x, y: x @ y, a, w, bytes_accessed=4 * (256 * 128 + 128 * 64
                                                                              + 256 * 64),
                                 spec=profiling.H100_SXM)
    assert r.flops == 2 * 256 * 128 * 64 and r.bound == "memory"
    with pytest.raises(ValueError):  # FlopCounterMode counts no bytes
        profiling.speed_of_light(lambda x, y: x @ y, a, w)

    s = torch.eye(256)
    dt = profiling.chained_latency(lambda x: x @ x * 0.999 + 1e-3, s, m_lo=2, m_hi=10, reps=3)
    assert 0.0 < dt < 1.0, dt

    if not torch.cuda.is_available():
        assert profiling.detect_chip().name == "unknown"
    h100 = profiling.H100_SXM
    assert (h100.peak_flops_f32, h100.peak_flops_f64, h100.hbm_bytes_per_s,
            h100.power_limit_w) == (67e12, 34e12, 3.35e12, 700.0)
    for name, want in (("NVIDIA H100 80GB HBM3", h100.name), ("NVIDIA H100 PCIe", None)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
            spec = profiling.detect_chip()
        assert spec.name == (want or name) and (want or spec.peak_flops_f32 == 1e12)

    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("unit-test-region"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert files and "unit-test-region" in open(files[0]).read()

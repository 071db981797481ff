"""The policy networks of lifelike_tpu_torch (models/) and their weights'
import (compat/tleague_import.py, learning/registry.py) vs the JAX
reference, on the CPU.

The first item holds PMCNet (both z priors), EPMCNet and SEPMCNet to the
JAX nets in float64 at 1e-9 on every output field: the parameter layout is
JAX's own (`jax.eval_shape` of `net.init`, filled with seeded numpy), one
jitted `apply` per net; the recurrent nets run 3 steps with a mask reset,
on the playground's 25 x 13 height maps and 128-ray lidar (the asymmetric
SAME padding of the stride-2 convolutions), with the sampled indices and
angles injected; the Gaussian prior's normals are recovered from JAX's
outputs and injected; PMCNet's decode_only / decode_index alike.

The second item holds the port's TLeague import of seeded flat variable
lists to JAX's (`import_pmc` / `import_epmc` / `import_sepmc`,
`extract_frozen_llc`, `import_llc_into`) array for array, the port's
unpickler refusing pickles that reduce through os.system or a dunder
getattr, and the repo's trained pool checkpoint read by the port's
ModelPool (no JAX) against JAX's PMCNet.apply on the same tree in float32.
"""
import filecmp
import os
import pickle
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.compat import tleague_import as JTI
from lifelike_tpu.models import epmc as jepmc
from lifelike_tpu.models import pmc as jpmc
from lifelike_tpu.models import sepmc as jsepmc
from lifelike_tpu_torch.compat import from_jax, tleague_import
from lifelike_tpu_torch.learning import registry
from lifelike_tpu_torch.models import params as P
from lifelike_tpu_torch.models import pmc, sepmc

from tests.torch_port_util import CPU, F64, np_of

POOL_MODEL = "runs/pmc_r5/pool/model_0009660.model"
PORT_POOL_MODEL = "lifelike_tpu_torch/data/pmc_r5/model_0009660.model"
HW = (25, 13)  # envs.playground percept height maps
POSITIVE = {"moving_std"}
Decoded = namedtuple("Decoded", "mean logstd")


def seeded_tree(shapes, rng, dtype):
    """A parameter tree of `shapes` (jax.eval_shape of net.init) filled with
    seeded numpy: kernels ~ N(0, 1 / fan_in), positive rms std, unit-ish
    layer-norm gains, small biases."""

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name in POSITIVE:
            a = 0.5 + rng.uniform(size=shape)
        elif name in ("kernel", "wx", "wh"):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("logstd", "hlc_logvar"):
            a = -1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.3 * rng.standard_normal(shape)
        return np.asarray(a, dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(shapes))


def layout(net, *args):
    rngs = {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1),
            "hlc": jax.random.PRNGKey(2)}
    return jax.eval_shape(lambda *a: net.init(rngs, *a), *args)


def close(got, want, label, rtol=1e-9, atol=1e-9):
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{label}: {name}")


def pmc_obs(rng, b, dtype=np.float64):
    return (rng.standard_normal((b, 99)).astype(dtype), rng.standard_normal((b, 36)).astype(dtype),
            rng.standard_normal((b, 72)).astype(dtype))


def playground_obs(rng, b):
    return dict(prop=rng.standard_normal((b, 99)), prop_a=rng.standard_normal((b, 36)),
                percep_2d=rng.uniform(0, 0.6, (b,) + HW), percep_1d=rng.uniform(0, 3, (b, 128)),
                percep_front=rng.uniform(0, 0.6, (b,) + HW), target=rng.standard_normal((b, 3)))


def chase_obs(rng, b):
    o = {k.replace("percep_", "percept_"): v for k, v in playground_obs(rng, b).items()
         if k != "target"}
    for k, n in (("percept_vec", 5), ("oppo_info", 15), ("oppo_info_cheat", 15),
                 ("flag_info", 7), ("flag_info_cheat", 7), ("with_flag", 2)):
        o[k] = rng.standard_normal((b, n))
    o["control_spd"] = rng.uniform(0.5, 3.0, (b, 1))
    return o


def torch_tree(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _check_pmc(rng):
    prop, prop_a, future = pmc_obs(rng, 8)
    t = [torch.as_tensor(x) for x in (prop, prop_a, future)]
    z = rng.standard_normal((8, 32))
    idx = rng.integers(0, 256, 8)
    for prior in ("VQ", "Gaussian"):
        cfg = jpmc.PMCConfig(z_prior_type=prior)
        jnet = jpmc.PMCNet(cfg)
        tree = seeded_tree(layout(jnet, prop, prop_a, future), rng, np.float64)

        @jax.jit
        def ref(p, prop, prop_a, future, z, idx):
            out, st = jnet.apply(p, prop, prop_a, future, rngs={"z": jax.random.PRNGKey(7)},
                                 capture_intermediates=True)
            dec = jnet.apply(p, prop, prop_a, z, method=jpmc.PMCNet.decode_only)
            dix = jnet.apply(p, prop, prop_a, idx, method=jpmc.PMCNet.decode_index)
            return out, st["intermediates"], dec, dix

        jout, inter, jdec, jdix = ref(tree, prop, prop_a, future, z, idx)
        net = from_jax.pmc_params(tree, pmc.PMCConfig(*cfg), device=CPU, dtype=F64)
        eps = None
        if prior == "Gaussian":  # JAX's normals, recovered from its latent
            mu, logvar = inter["z_mu"]["__call__"][0], inter["z_logvar"]["__call__"][0]
            eps = torch.as_tensor(np.array((jout.z - mu) / jnp.exp(0.5 * logvar)))
        out = net(*t, eps=eps)
        close(out, jout, f"PMCNet {prior}")
        assert np_of(out.z_idx).tolist() == np.asarray(jout.z_idx).tolist()
        close(Decoded(*net.decode_only(t[0], t[1], torch.as_tensor(z))), jdec,
              f"decode_only {prior}")
        close(Decoded(*net.decode_index(t[0], t[1], torch.as_tensor(idx))), jdix,
              f"decode_index {prior}")


def _check_recurrent(rng, jnet, port_from, make_obs, actions):
    """3 steps of a recurrent net from a random hidden state, mask reset on
    robot 0 at step 1, the sampled actions injected."""
    b = 2
    obs = [make_obs(rng, b) for _ in range(3)]
    hs = 0.5 * rng.standard_normal((b, jnet.cfg.hs_len))
    masks = [np.zeros(b), np.array([1.0, 0.0]), np.zeros(b)]
    acts = [actions(rng, b) for _ in range(3)]
    tree = seeded_tree(layout(jnet, obs[0], hs, masks[0], *acts[0]), rng, np.float64)
    ref = jax.jit(lambda p, o, h, m, a: jnet.apply(p, o, h, m, *a))
    net = port_from(tree, device=CPU, dtype=F64)
    jh, th = hs, torch.as_tensor(hs)
    for o, m, a in zip(obs, masks, acts):
        jout = ref(tree, o, jh, m, a)
        out = net(torch_tree(o), th, torch.as_tensor(m), *(torch.as_tensor(x) for x in a))
        close(out, jout, type(jnet).__name__)
        jh, th = jout.hs, out.hs


def test_networks_match_reference_float64():
    rng = np.random.default_rng(0)
    _check_pmc(rng)
    _check_recurrent(rng, jepmc.EPMCNet(), from_jax.epmc_params, playground_obs,
                     lambda r, b: (r.integers(0, 256, b),))
    _check_recurrent(rng, jsepmc.SEPMCNet(), from_jax.sepmc_params, chase_obs,
                     lambda r, b: (r.uniform(-np.pi, np.pi, (b, 1)), r.integers(0, 256, b)))


def _flat_list(paths, template, rng):
    """A seeded stand-in for a reference checkpoint's flat variable list."""
    return [rng.standard_normal(s).astype(np.float32)
            for s in tleague_import.flat_shapes(paths, template)]


def _leaves(tree):
    return dict(P._flatten(tree["params"] if "params" in tree else tree))


def _assert_trees_identical(got, want, label):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), label
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (label, k)


def _check_tleague_import(rng):
    jnets = {"pmc": (jpmc.PMCNet(), pmc_obs(rng, 2, np.float32)),
             "epmc": (jepmc.EPMCNet(), ({k: v.astype(np.float32) for k, v in
                                         playground_obs(rng, 2).items()},
                                        np.zeros((2, 192), np.float32), np.zeros(2, np.float32),
                                        np.zeros(2, np.int32))),
             "sepmc": (jsepmc.SEPMCNet(), ({k: v.astype(np.float32) for k, v in
                                           chase_obs(rng, 2).items()},
                                          np.zeros((2, 256), np.float32), np.zeros(2, np.float32),
                                          np.zeros((2, 1), np.float32), np.zeros(2, np.int32)))}
    paths = {"pmc": tleague_import.PMC_PATHS, "epmc": tleague_import.EPMC_PATHS,
             "sepmc": tleague_import.SEPMC_PATHS}
    lists = {}
    for kind, (jnet, args) in jnets.items():
        jtemplate = seeded_tree(layout(jnet, *args), rng, np.float32)
        arrays = lists[kind] = _flat_list(paths[kind], jtemplate, rng)
        want = getattr(JTI, f"import_{kind}")(arrays, jtemplate)
        got = getattr(tleague_import, f"import_{kind}")(arrays)  # the port's own template
        _assert_trees_identical(got, want, f"import_{kind}")
        _assert_trees_identical(tleague_import.extract_frozen_llc(arrays),
                                JTI.extract_frozen_llc(arrays), f"llc of {kind}")
        _assert_trees_identical(tleague_import.import_llc_into(jtemplate, arrays),
                                JTI.import_llc_into(jtemplate, arrays), f"llc into {kind}")
    # every port net loads its imported tree (strict: every leaf used once)
    for kind, load in (("pmc", from_jax.pmc_params), ("epmc", from_jax.epmc_params),
                       ("sepmc", from_jax.sepmc_params)):
        tree = getattr(tleague_import, f"import_{kind}")(lists[kind])
        net = load(tree, device=CPU)
        _assert_trees_identical(P.flax_tree(net), tree, f"{kind} round trip")
    for bad in ([np.zeros((32, 256))] * 30, lists["pmc"][:-1]):
        with pytest.raises(ValueError):
            tleague_import.extract_frozen_llc(bad)
        with pytest.raises(ValueError):
            tleague_import.import_pmc(bad)


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


class _DunderChain:
    def __reduce__(self):
        return (getattr, (int, "__class__"))


def _check_unpickler(tmp_path):
    for name, payload in (("evil", _Evil()), ("dunder", _DunderChain())):
        bad = tmp_path / f"{name}.model"
        bad.write_bytes(pickle.dumps({"model": payload}))
        with pytest.raises(pickle.UnpicklingError):
            tleague_import.load_tleague_model(str(bad))


def _check_pool_checkpoint(rng):
    assert filecmp.cmp(POOL_MODEL, PORT_POOL_MODEL, shallow=False)
    tree = registry.ModelPool().load_file("pool", PORT_POOL_MODEL)
    net = from_jax.pmc_params(tree, device=CPU)
    prop, prop_a, future = pmc_obs(rng, 8, np.float32)
    jout = jax.jit(jpmc.PMCNet().apply)(tree, prop, prop_a, future)
    out = net(*(torch.as_tensor(x) for x in (prop, prop_a, future)))
    assert out.mean.dtype == torch.float32
    for name in ("mean", "logstd", "value", "z"):
        w = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(np_of(getattr(out, name)), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert np_of(out.z_idx).tolist() == np.asarray(jout.z_idx).tolist()


def test_checkpoint_import_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    _check_tleague_import(rng)
    _check_unpickler(tmp_path)
    _check_pool_checkpoint(rng)

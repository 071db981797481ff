"""Import pretrained reference checkpoints (TLeague joblib ``.model`` files).

Port of lifelike_tpu.compat.tleague_import, with no JAX. Each reference
``.model`` file is a pickle of ``tleague.model_pools.model.Model`` whose
``model`` attribute is the flat list of TF1 trainable variables in
graph-creation order. This module unpickles those files WITHOUT TLeague
installed (a stub unpickler absorbs every ``tleague.*`` class and refuses
every other global outside a small numpy / joblib allowlist) and maps the
flat variable list onto a parameter tree in the Flax layout, which
models.params loads into the port's nets.

Variable order facts used by the mapping (creation order of the reference's
``tf.get_variable`` calls):

* ``rms`` creates (moving_mean, moving_std), each shaped (1, D).
* PMC (reference pmc_net/pmc_net.py:119-177): prop_rms, future_rms,
  vf (2x256 tanh -> 1), encoder (2x256 relu -> z 32), VQ codebook
  ``llc/embedding`` (32, 256), llc prop_embed (135->64), z_embed (32->32),
  decoder (96->256->256->12), logstd (1, 12) — 28 variables in all.
* TF dense kernels are (in, out), as in the Flax layout.

The EPMC / SEPMC checkpoints embed the same frozen LLC + codebook at their
tails; ``extract_frozen_llc`` takes that subtree for stage hand-off.

A template is a parameter tree in the Flax layout (nested dicts of arrays,
with or without the top "params" scope) that fixes shapes and dtypes; by
default it comes from the port's own net (models.params.flax_tree).
"""
import pickle
from typing import List, NamedTuple

import numpy as np


class TLeagueModel(NamedTuple):
    arrays: List[np.ndarray]  # flat trainable variables, creation order
    key: str
    createtime: str
    updatetime: str


# ---------------------------------------------------------------------------
# Stub unpickling (no tleague dependency)
# ---------------------------------------------------------------------------


def _stub_setstate(self, state):
    if isinstance(state, dict):
        self.__dict__.update(state)
    else:
        self._state = state


def _stub_init(self, *args, **kwargs):
    self._args = args
    self._kwargs = kwargs


class _StubMeta(type):
    """Class whose attribute access mints nested stub classes on demand
    (pickle resolves dotted names like ``Model.Blackboard`` via getattr)."""

    def __getattr__(cls, name):
        if name.startswith("__"):
            raise AttributeError(name)
        sub = _StubMeta(
            name, (object,), {"__setstate__": _stub_setstate, "__init__": _stub_init}
        )
        setattr(cls, name, sub)
        return sub


_STUB_CACHE = {}

# The only non-stubbed globals a TLeague ``Model`` pickle legitimately needs:
# numpy / joblib array reconstruction plus a couple of stdlib containers. The
# ``.model`` files come from an UNTRUSTED source, so anything outside this
# allowlist (and the tleague-family stubs) raises instead of importing —
# default ``find_class`` would resolve e.g. ``os.system``.
_ALLOWED_GLOBALS = frozenset(
    {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
        ("joblib.numpy_pickle", "NumpyArrayWrapper"),
        ("joblib.numpy_pickle", "NDArrayWrapper"),
        ("joblib.numpy_pickle", "ZNDArrayWrapper"),
        ("collections", "OrderedDict"),
        ("builtins", "bytearray"),
        ("copyreg", "_reconstructor"),
    }
)


def _stub_find_class(module, name):
    """Resolve tleague / tpolicies globals to on-demand stub classes, or None."""
    if not module.startswith(("tleague", "tpolicies", "tensorflow", "horovod")):
        return None
    if module not in _STUB_CACHE:
        _STUB_CACHE[module] = _StubMeta(
            module, (object,), {"__setstate__": _stub_setstate, "__init__": _stub_init}
        )
    cls = _STUB_CACHE[module]
    for part in name.split("."):
        cls = getattr(cls, part)
    return cls


def _safe_getattr(obj, name, *default):
    """getattr restricted to non-dunder names — pickle needs it to resolve
    nested stub attributes, but unrestricted it is a gadget (``__class__`` /
    ``__subclasses__`` chains)."""
    if name.startswith("__"):
        raise pickle.UnpicklingError(f"blocked dunder getattr({name!r})")
    return getattr(obj, name, *default)


def _check_allowed(module, name):
    if module == "builtins" and name == "getattr":
        return _safe_getattr
    if (module, name.split(".")[0]) not in _ALLOWED_GLOBALS:
        raise pickle.UnpicklingError(
            f"blocked global {module}.{name} in untrusted .model file "
            f"(allowlist: numpy/joblib array reconstruction only)"
        )
    return None


class _TLeagueUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        stub = _stub_find_class(module, name)
        if stub is not None:
            return stub
        override = _check_allowed(module, name)
        return override if override is not None else super().find_class(module, name)


def _load_joblib_stubbed(path: str):
    """joblib numpy-pickles store arrays out-of-band; reuse joblib's
    NumpyUnpickler with the tleague stub find_class grafted on."""
    import inspect

    import joblib.numpy_pickle as _jnp

    def _find_class(self, module, name):
        stub = _stub_find_class(module, name)
        if stub is not None:
            return stub
        override = _check_allowed(module, name)
        return (
            override
            if override is not None
            else _jnp.NumpyUnpickler.find_class(self, module, name)
        )

    cls = type(
        "_StubbedNumpyUnpickler", (_jnp.NumpyUnpickler,), {"find_class": _find_class}
    )
    kwargs = {}
    if "ensure_native_byte_order" in inspect.signature(
        _jnp.NumpyUnpickler.__init__
    ).parameters:
        kwargs["ensure_native_byte_order"] = False
    with open(path, "rb") as f:
        return cls(path, f, **kwargs).load()


def load_tleague_model(path: str) -> TLeagueModel:
    """Unpickle a reference ``.model`` file into its flat variable list."""
    try:
        with open(path, "rb") as f:
            obj = _TLeagueUnpickler(f).load()
    except Exception:
        obj = _load_joblib_stubbed(path)
    d = obj.__dict__
    arrays = d["model"]
    if not isinstance(arrays, (list, tuple)):
        raise ValueError(f"{path}: unexpected Model.model payload {type(arrays)}")
    return TLeagueModel(
        arrays=[np.asarray(a) for a in arrays],
        key=str(d.get("key", "")),
        createtime=str(d.get("createtime", "")),
        updatetime=str(d.get("updatetime", "")),
    )


# ---------------------------------------------------------------------------
# Variable layouts (Flax paths relative to the params root, creation order)
# ---------------------------------------------------------------------------


def _dense(path):
    return [path + ("kernel",), path + ("bias",)]


def _conv_stack(path):
    out = []
    for i in range(4):
        out += _dense(path + (f"Conv_{i}",))
    return out


def _usr_cmd(path, with_vec=True):
    # creation order: percep_2d convs, percep_1d convs, percep_front convs,
    # [vec fc,] bottleneck fc (reference epmc_net.py:117-131; the SEPMC
    # value / HLC encoders have no vec branch, sepmc_net.py:156-179)
    out = (
        _conv_stack(path + ("percep_2d",))
        + _conv_stack(path + ("percep_1d",))
        + _conv_stack(path + ("percep_front",))
    )
    if with_vec:
        out += _dense(path + ("vec_fc",))
    return out + _dense(path + ("bottleneck",))


def _lnlstm(path):
    # wx, wh, b, then LN(x-branch) beta/gamma, LN(h-branch) beta/gamma,
    # LN(cell) beta/gamma (models/epmc.py LayerNormLSTMCell)
    return [
        path + (n,)
        for n in (
            "wx", "wh", "b",
            "ln_x_beta", "ln_x_gamma",
            "ln_h_beta", "ln_h_gamma",
            "ln_c_beta", "ln_c_gamma",
        )
    ]


def _llc_paths(prefix=("llc",)):
    return (
        [prefix + ("embedding",)]
        + _dense(prefix + ("prop_embed",))
        + _dense(prefix + ("z_embed",))
        + _dense(prefix + ("decoder", "Dense_0"))
        + _dense(prefix + ("decoder", "Dense_1"))
        + _dense(prefix + ("head", "mean"))
        + [prefix + ("head", "logstd")]
    )


PMC_PATHS = (
    [("prop_rms", "moving_mean"), ("prop_rms", "moving_std"),
     ("future_rms", "moving_mean"), ("future_rms", "moving_std")]
    + _dense(("vf", "Dense_0"))
    + _dense(("vf", "Dense_1"))
    + _dense(("value_out",))
    + _dense(("encoder", "Dense_0"))
    + _dense(("encoder", "Dense_1"))
    + _dense(("z_out",))
    + _llc_paths()
)

EPMC_PATHS = (
    [("prop_rms", "moving_mean"), ("prop_rms", "moving_std")]
    + _dense(("vf_fc1",))
    + _usr_cmd(("vf_cmd",))
    + _dense(("vf_fc2",))
    + _dense(("vf_fc3",))
    + _lnlstm(("vf_lstm",))
    + _dense(("value_out",))
    + _dense(("pi_prop_embed",))
    + _usr_cmd(("pi_cmd",))
    + _dense(("pi_fc",))
    + _lnlstm(("pi_lstm",))
    + _dense(("z_out",))
    + _llc_paths()
)

SEPMC_PATHS = (
    [("prop_rms", "moving_mean"), ("prop_rms", "moving_std")]
    # value towers (cheat obs): prop fc1, percept encoder (no vec) -> fc2,
    # hlc cheat cmd (2 fc) -> fc3, concat -> fc4 -> LSTM -> value
    # (sepmc_net.py:271-289)
    + _dense(("vf_fc1",))
    + _usr_cmd(("vf_mlc_cmd",), with_vec=False)
    + _dense(("vf_fc2",))
    + _dense(("vf_hlc_cmd", "Dense_0"))
    + _dense(("vf_hlc_cmd", "Dense_1"))
    + _dense(("vf_fc3",))
    + _dense(("vf_fc4",))
    + _lnlstm(("vf_lstm",))
    + _dense(("value_out",))
    # HLC (sepmc_net.py:127-152): prop embed, percept encoder (no vec),
    # hlc cmd (2 fc), concat fc, LSTM, angle mean dense, logvar
    + _dense(("hlc_prop_embed",))
    + _usr_cmd(("hlc_mlc_cmd",), with_vec=False)
    + _dense(("hlc_cmd", "Dense_0"))
    + _dense(("hlc_cmd", "Dense_1"))
    + _dense(("hlc_fc",))
    + _lnlstm(("hlc_lstm",))
    + _dense(("hlc_mu",))
    + [("hlc_logvar",)]
    # frozen MLC (sepmc_net.py:179-208): prop embed, percept encoder WITH
    # the injected target_info vec (3 -> 32), concat fc, LSTM, z head
    + _dense(("mlc_prop_embed",))
    + _usr_cmd(("mlc_cmd",), with_vec=True)
    + _dense(("mlc_fc",))
    + _lnlstm(("mlc_lstm",))
    + _dense(("z_out",))
    # frozen LLC
    + _llc_paths()
)

PMC_NUM_VARS, EPMC_NUM_VARS, SEPMC_NUM_VARS = 28, 102, 152
assert (len(PMC_PATHS), len(EPMC_PATHS), len(SEPMC_PATHS)) == (
    PMC_NUM_VARS, EPMC_NUM_VARS, SEPMC_NUM_VARS)

# variables stored as (1, D) in TF but (D,) in the Flax layout
SQUEEZE_NAMES = {"moving_mean", "moving_std", "logstd", "hlc_logvar"}


def _as_arrays(source):
    if isinstance(source, str):
        return load_tleague_model(source).arrays
    if isinstance(source, TLeagueModel):
        return source.arrays
    return list(source)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _template(template, net_cls):
    if template is None:
        from lifelike_tpu_torch.models import params

        return params.flax_tree(net_cls())
    return _numpy_tree(template)


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    old = node[path[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"param {old.shape} vs checkpoint {value.shape}")
    node[path[-1]] = value.astype(np.asarray(old).dtype)


def _import(source, template, net_cls, paths, what):
    arrays = _as_arrays(source)
    if len(arrays) != len(paths):
        raise ValueError(f"expected {len(paths)} {what} variables, got {len(arrays)}")
    tree = _template(template, net_cls)
    params = tree["params"] if "params" in tree else tree
    for a, path in zip(arrays, paths):
        a = np.asarray(a)
        if path[-1] in SQUEEZE_NAMES and a.ndim > 1:
            a = a.reshape(a.shape[-1])
        _set_path(params, path, a)
    return tree


def import_pmc(source, template_params=None) -> dict:
    """Map a reference primitive_level checkpoint onto a PMCNet tree.

    source: path to a ``.model`` file, a TLeagueModel, or a raw array list.
    template_params: a Flax-layout tree of the net (shapes and dtypes);
    default the port's PMCNet(). Returns a new tree with every variable
    replaced."""
    from lifelike_tpu_torch.models.pmc import PMCNet

    return _import(source, template_params, PMCNet, PMC_PATHS,
                   "PMC (is this a primitive_level checkpoint?)")


def import_epmc(source, template_params=None) -> dict:
    """Map a reference environmental_level_* checkpoint onto an EPMCNet tree."""
    from lifelike_tpu_torch.models.epmc import EPMCNet

    return _import(source, template_params, EPMCNet, EPMC_PATHS,
                   "EPMC (is this an environmental_level checkpoint?)")


def import_sepmc(source, template_params=None) -> dict:
    """Map the reference strategic_level checkpoint onto a SEPMCNet tree."""
    from lifelike_tpu_torch.models.sepmc import SEPMCNet

    return _import(source, template_params, SEPMCNet, SEPMC_PATHS,
                   "SEPMC (is this a strategic_level checkpoint?)")


def flat_shapes(paths, template):
    """The TF shapes of a checkpoint's flat variable list for a Flax-layout
    template: the template's leaf shapes in `paths` order, (1, D) for the
    squeezed names. Builds seeded stand-ins for the reference files."""
    params = template["params"] if "params" in template else template
    out = []
    for path in paths:
        node = params
        for p in path:
            node = node[p]
        shape = tuple(np.shape(node))
        out.append((1,) + shape if path[-1] in SQUEEZE_NAMES else shape)
    return out


# ---------------------------------------------------------------------------
# Frozen-LLC extraction from EPMC / SEPMC checkpoints (stage hand-off)
# ---------------------------------------------------------------------------

# The frozen PMC subtree sits at the tail of the higher-level var lists:
# [..., codebook (32,256), prop_embed k/b, z_embed k/b, decoder k/b x2,
#  mean k/b, logstd (1,12)] — 12 variables (reference epmc_net.py:166-174,
# 251-256; sepmc_net.py:211-219, 312-319).
_LLC_TAIL = [p[1:] for p in _llc_paths()]


def extract_frozen_llc(source) -> dict:
    """LLC (codebook + decoder) subtree from any of the five checkpoints, as
    a dict matching the ``llc`` scope of PMCNet / EPMCNet / SEPMCNet.

    All three checkpoint families place the LLC at the tail of the flat
    variable list, so ``arrays[-12:]`` is right for each — but only for
    genuine checkpoints: the list length is validated against the three
    known layouts and every tail shape against the LLC architecture."""
    arrays = _as_arrays(source)
    known = {PMC_NUM_VARS, EPMC_NUM_VARS, SEPMC_NUM_VARS}
    if len(arrays) not in known:
        raise ValueError(
            f"unrecognized checkpoint: {len(arrays)} variables "
            f"(expected one of {sorted(known)} for PMC/EPMC/SEPMC)"
        )
    tail = arrays[-len(_LLC_TAIL):]
    # decoder architecture shapes (z 32, codebook 256, prop 135 -> 64, 2x256)
    expect = [
        (32, 256), (135, 64), (64,), (32, 32), (32,),
        (96, 256), (256,), (256, 256), (256,),
        (256, 12), (12,), None,  # logstd arrives as (1, 12) or (12,)
    ]
    for path, a, shp in zip(_LLC_TAIL, tail, expect):
        if shp is not None and tuple(np.shape(a)) != shp:
            raise ValueError(
                f"LLC tail mismatch at {'/'.join(path)}: "
                f"{np.shape(a)} != {shp} — not a reference checkpoint"
            )
    out = {}
    for path, a in zip(_LLC_TAIL, tail):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        v = np.asarray(a)
        if path[-1] == "logstd" and v.ndim > 1:
            v = v.reshape(v.shape[-1])
        node[path[-1]] = v
    return out


def import_llc_into(params_tree, source) -> dict:
    """Replace the ``llc`` subtree of a net's Flax-layout tree with the
    frozen LLC of a reference checkpoint (the functional analog of
    llc_param_type='freeze'). Returns a new tree."""
    tree = _numpy_tree(params_tree)
    root = tree["params"] if "params" in tree else tree
    _merge_checked(root["llc"], extract_frozen_llc(source), ("llc",))
    return tree


def _merge_checked(dst, src, where):
    for k, v in src.items():
        if k not in dst:
            raise KeyError(f"{'/'.join(where)} has no param {k}")
        if isinstance(v, dict):
            _merge_checked(dst[k], v, where + (k,))
        else:
            if tuple(dst[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch at {'/'.join(where + (k,))}: "
                    f"{dst[k].shape} vs {v.shape}"
                )
            dst[k] = v.astype(np.asarray(dst[k]).dtype)

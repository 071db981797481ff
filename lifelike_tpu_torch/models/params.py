"""Flax-layout parameter trees <-> the port's modules.

The JAX package keeps a net's weights as a nested dict in the Flax layout
(`{"params": {"vf": {"Dense_0": {"kernel": (in, out), "bias": (out,)}}}}`),
which its ModelPool files and `net.init` hold and its TLeague import fills.
The port's modules name their submodules and parameters after the same
scopes, so a Flax path maps onto a state_dict key by joining it with "."
and renaming `kernel` to `weight`. The layouts differ only for kernels:

  Dense  (in, out)            -> nn.Linear weight (out, in)
  Conv1D (k, in, out)         -> nn.Conv1d weight (out, in, k)
  Conv2D (kh, kw, in, out)    -> nn.Conv2d weight (out, in, kh, kw)

Every other leaf (biases, rms statistics, codebook, logstd, LSTM kernels,
which the LSTM multiplies as x @ wx) keeps its shape.
"""
import numpy as np
import torch

_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _key(path):
    return ".".join(path[:-1] + (("weight",) if path[-1] == "kernel" else path[-1:]))


def _is_kernel(key, state):
    return key.endswith(".weight") and state[key].ndim in _TO_FLAX


def load_flax_tree(module, tree, partial=False):
    """Copy a Flax-layout tree (numpy arrays or array-likes, with or without
    the top "params" scope) into `module`'s parameters, in place, cast to
    each parameter's dtype and device. Strict: every leaf of the tree is used
    once, every shape matches and, unless `partial` (a subtree hand-off),
    every parameter of the module is filled. Returns the module."""
    params = tree["params"] if "params" in tree else tree
    state = dict(module.named_parameters())
    filled = set()
    with torch.no_grad():
        for path, leaf in _flatten(params):
            key = _key(path)
            if key not in state:
                raise KeyError(f"{'/'.join(path)}: no parameter {key} in "
                               f"{type(module).__name__}")
            if key in filled:
                raise KeyError(f"{'/'.join(path)}: parameter {key} given twice")
            a = to_torch_layout(path, leaf)
            p = state[key]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch at {'/'.join(path)}: parameter "
                                 f"{tuple(p.shape)} vs tree {tuple(a.shape)}")
            p.copy_(a.to(p.dtype))
            filled.add(key)
    missing = sorted(set(state) - filled)
    if missing and not partial:
        raise KeyError(f"{type(module).__name__}: parameters not in the tree: {missing}")
    return module


def flax_path(key, param):
    """The Flax path (from the top "params" scope) of the module parameter
    `key` (a state_dict key) holding `param`."""
    parts = key.split(".")
    if parts[-1] == "weight" and param.ndim in _TO_FLAX:
        parts[-1] = "kernel"
    return ("params",) + tuple(parts)


def to_torch_layout(path, leaf):
    """A Flax-layout leaf at `path` as a tensor in the layout of the module
    parameter it maps onto (kernels permuted)."""
    a = torch.as_tensor(np.array(leaf))
    if path[-1] == "kernel" and a.ndim in _TO_TORCH:
        a = a.permute(_TO_TORCH[a.ndim])
    return a


def flax_tree(module):
    """`{"params": {...}}`: the module's parameters as numpy arrays in the
    Flax layout (the inverse of load_flax_tree)."""
    state = dict(module.named_parameters())
    root = {}
    for key, p in state.items():
        parts = key.split(".")
        a = p.detach().cpu().numpy()
        if _is_kernel(key, state):
            parts[-1] = "kernel"
            a = np.ascontiguousarray(a.transpose(_TO_FLAX[a.ndim]))
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return {"params": root}

"""Frozen-subtree loading and gradient masking: the stage hand-off mechanism.

Port of lifelike_tpu.learning.freeze. The reference freezes lower levels by
variable-scope naming (reference epmc_net.py:166-174, epmc_net_data.py:54);
the JAX package copies a parameter subtree from the donor checkpoint into
the student's tree (load_subtree) and masks it out of the optimizer with
optax.multi_transform + set_to_zero (frozen_optimizer). Here a subtree is
named by its Flax path (("params", "llc"), as the JAX package names it) and
mapped onto the module's parameters through models/params.py; a frozen
parameter gets requires_grad=False and is left out of the optimizer, so it
takes no update and no part in the gradient clip's global norm (optax's
multi_transform clips the trainable leaves alone).

A hand-off entry may also be a pair (dst, src) of paths: the donor's
subtree at `src` is loaded at `dst` (run_learner's "dst=src" form), for
donors whose scopes are named otherwise, e.g. an EPMC model's policy tower
(`pi_fc`) as a SEPMC net's frozen MLC (`mlc_fc`). A plain path means
dst == src, as in the JAX package.
"""
from typing import Sequence

from lifelike_tpu_torch.models import params as P


def _pair(entry):
    if isinstance(entry[0], str):
        return tuple(entry), tuple(entry)
    dst, src = entry
    return tuple(dst), tuple(src)


def dst_paths(paths):
    """The destination path of each hand-off entry."""
    return [_pair(e)[0] for e in paths]


def load_subtree(net, donor_params, paths: Sequence):
    """Copy subtrees (e.g. [("params", "llc")]) of the Flax-layout donor tree
    into `net`'s parameters, in place. Every leaf of each subtree must map
    onto a parameter of matching shape. Returns the net."""
    for entry in paths:
        dst, src = _pair(entry)
        node = donor_params
        for k in src:
            node = node[k]
        for k in reversed(dst):
            node = {k: node}
        P.load_flax_tree(net, node, partial=True)
    return net


def under(path, prefixes) -> bool:
    return any(tuple(path[: len(pre)]) == tuple(pre) for pre in prefixes)


def frozen_names(net, frozen_prefixes: Sequence[Sequence[str]]):
    """The state_dict keys of the parameters under any frozen prefix."""
    return [k for k, p in net.named_parameters()
            if under(P.flax_path(k, p), frozen_prefixes)]


def freeze(net, frozen_prefixes: Sequence[Sequence[str]]):
    """requires_grad=False for the parameters under the prefixes; returns
    their keys."""
    names = frozen_names(net, frozen_prefixes)
    params = dict(net.named_parameters())
    for k in names:
        params[k].requires_grad_(False)
    return names


def frozen_optimizer(cfg, net, frozen_prefixes):
    """learner.make_optimizer over the trainable parameters only: the
    parameters under `frozen_prefixes` are frozen and take no update."""
    from lifelike_tpu_torch.learning import learner

    return learner.make_optimizer(cfg, net, frozen=frozen_prefixes)

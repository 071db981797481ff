"""Device-resident replay memory of rollout windows.

Port of lifelike_tpu.learning.replay. The reference learner stages actor
unrolls in a host replay memory (rm_size=1024 unrolls, reference
run_pg_learner.py:36) and samples rollout_len=8 windows into batches of
256 for several optimizer steps per unroll. Here the same stage is a
fixed-shape circular buffer of window slots on the learner's device:
writes are index copies into the buffers, sampling is a gather.

Works for any tree of unroll tensors with (T, B, ...) leaves — a tensor, a
NamedTuple, a dict, a tuple or a list of trees; recurrent rollouts stage
per-step hidden states as just another leaf. The cursor and the fill count
are host integers (the JAX package keeps them as device scalars inside its
jitted step).
"""
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`):
    NamedTuples, dicts, tuples and lists are walked and keep their type,
    None stays None, anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def tree_stack(trees):
    """A list of trees with equal structure -> one tree of stacked leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class Replay(NamedTuple):
    data: Any  # tree, leaves (S, W, ...) — S slots of W-step windows
    cursor: int  # next write position
    filled: int  # number of valid slots


def windows_from_unroll(rollout, window: int):
    """Split (T, B, ...) unroll leaves into (T//W * B, W, ...) window slots."""

    def split(x):
        T, B = x.shape[0], x.shape[1]
        if T % window:
            raise ValueError(f"unroll length {T} is not a multiple of the window {window}")
        x = x.reshape((T // window, window, B) + tuple(x.shape[2:]))
        x = torch.movedim(x, 2, 1)  # (T//W, B, W, ...)
        return x.reshape((T // window * B, window) + tuple(x.shape[3:]))

    return tree_map(split, rollout)


def windows_overlapping(rollout, window: int, stride: int):
    """Split (T, B, ...) unroll leaves into overlapping (N*B, window, ...)
    slots with the given stride — for burn-in staging, where each
    rollout_len training window carries its `burn_in` predecessor steps
    (window = burn_in + rollout_len, stride = rollout_len)."""
    T = tree_leaves(rollout)[0].shape[0]
    starts = np.arange(0, T - window + 1, stride)
    idx_np = starts[:, None] + np.arange(window)[None, :]  # (N, W)

    def split(x):
        B = x.shape[1]
        w = x[torch.as_tensor(idx_np, device=x.device)]  # (N, W, B, ...)
        w = torch.movedim(w, 2, 1)  # (N, B, W, ...)
        return w.reshape((len(starts) * B, window) + tuple(w.shape[3:]))

    return tree_map(split, rollout)


def replay_init(example_window, size: int) -> Replay:
    """Empty buffer shaped after one window slot (leaves (W, ...)), on the
    example's device and dtypes."""
    data = tree_map(lambda x: torch.zeros((size,) + tuple(x.shape), dtype=x.dtype,
                                          device=x.device), example_window)
    return Replay(data=data, cursor=0, filled=0)


def replay_add(rep: Replay, windows) -> Replay:
    """Circular write of (N, W, ...) window slots at the cursor (in place
    into the buffers; returns the replay with its new cursor and fill)."""
    size = tree_leaves(rep.data)[0].shape[0]
    n = tree_leaves(windows)[0].shape[0]
    idx = torch.remainder(rep.cursor + torch.arange(n), size)

    def write(buf, w):
        buf[idx.to(buf.device)] = w.to(buf.dtype)
        return buf

    data = tree_map(write, rep.data, windows)
    return Replay(data=data, cursor=(rep.cursor + n) % size, filled=min(rep.filled + n, size))


def replay_sample(rep: Replay, generator, batch: int, idx: Optional[torch.Tensor] = None):
    """Uniform sample of `batch` slots -> leaves (batch, W, ...). The
    indices are drawn from `generator` (a torch.Generator on the buffers'
    device), or taken from `idx` when given."""
    dev = tree_leaves(rep.data)[0].device
    if idx is None:
        idx = torch.randint(0, max(rep.filled, 1), (batch,), generator=generator, device=dev)
    idx = torch.as_tensor(idx, device=dev).long()
    return tree_map(lambda buf: buf[idx], rep.data)


def as_time_major(batch_windows):
    """(batch, W, ...) sampled slots -> (W, batch, ...) for the loss loops."""
    return tree_map(lambda x: torch.swapaxes(x, 0, 1), batch_windows)

"""The batch mesh of a multi-process run: one rank per device.

Port of lifelike_tpu.parallel.mesh onto torch.distributed. The JAX package's
one mesh axis 'batch' shards scenarios, MPPI candidates and environments
over devices and replicates the (small) parameters. Here the axis is a
process group: each rank drives one device and holds its local shard of
the batch as an ordinary tensor there; there are no global arrays.

  * `Mesh` — the record every sharded function takes: the process group
    (None for one process without a group), this rank, the world size,
    the rank's device and the group's backend.
  * `shard_rows` / `shard_batch` — rank r's rows [r B / W, (r + 1) B / W)
    of a global batch of B (a batch that does not divide raises, as the
    JAX package asserts).
  * `replicate` — a tree broadcast from rank 0, the counterpart of placing
    it replicated on the mesh.

The collectives themselves (sum, min, max, mean, gather, broadcast) are in
parallel/distributed.py.
"""
from typing import NamedTuple, Optional

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.learning.replay import tree_map

BATCH_AXIS = "batch"


class Mesh(NamedTuple):
    group: Optional[object]  # torch.distributed process group; None: one process
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]  # "nccl" or "gloo"; None without a group


def make_mesh(device="cuda") -> Mesh:
    """The mesh of one process without a process group: every collective
    is the identity on it (no CPU fallback for device="cuda")."""
    return Mesh(group=None, rank=0, world=1, device=_device.resolve_device(device), backend=None)


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of n (ValueError unless the world
    size divides n)."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not divide over {mesh.world} ranks")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's slice of every leaf of a global-batch tree along `axis`
    (a view of the leaf)."""
    def cut(x):
        rows = shard_rows(mesh, x.shape[axis])
        return x.narrow(axis, rows.start, rows.stop - rows.start)

    return tree_map(cut, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of `tree` as rank 0 holds it (a broadcast), on each
    rank's own device."""
    from lifelike_tpu_torch.parallel import distributed

    return tree_map(lambda x: distributed.broadcast(x, mesh) if torch.is_tensor(x) else x, tree)

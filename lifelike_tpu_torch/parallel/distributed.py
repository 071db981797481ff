"""Multi-process execution on torch.distributed.

Port of lifelike_tpu.parallel.distributed. The JAX package joins processes
into one SPMD program (jax.distributed) over a global mesh; the port runs
one rank per device, each with its own shard of the batch, and replaces the
JAX primitives by explicit collectives over the process group:

    lax.psum -> all_sum          lax.pmin -> all_min
    lax.pmean -> all_mean (a sum, then / world)
    lax.all_gather -> all_gather lax.axis_index -> mesh.rank

Environment contract (the JAX package's, set by tools/launch_multihost.py):
LIFELIKE_COORDINATOR host:port of rank 0, LIFELIKE_NUM_PROCESSES,
LIFELIKE_PROCESS_ID; LIFELIKE_BACKEND may name the backend.
LIFELIKE_LOCAL_DEVICES has no meaning here: one rank is one device.

Backend and device are explicit, with no fallback:
  * the backend defaults to "nccl" for a CUDA device and "gloo" for the
    CPU; "gloo" may be asked for on CUDA tensors (--backend or
    LIFELIKE_BACKEND), which is how several ranks share one card;
  * a rank's device is cuda:{rank % torch.cuda.device_count()} unless the
    caller passes one; "cuda" without a card raises;
  * NCCL refuses two ranks on one device, so under NCCL every rank posts
    its (host name, device index) to the coordinator's store, and every
    rank raises before creating the group, naming --backend=gloo, when two
    ranks post the same pair: on one host or across several.

Gloo's CUDA paths differ between PyTorch builds and collectives. So every
gloo collective on a CUDA tensor is staged through host memory, written
out in `_reduce` / `all_gather` / `broadcast`: the tensor is copied to
the CPU, reduced there and copied back. NCCL and CPU tensors take the
collective directly. Nothing switches backend, device or collective on a
failure.

Generators are per rank: rank_seed(seed, rank) = seed + rank * 0x9E3779B9,
so rank 0 draws what a single process seeded with `seed` draws, and the
ranks' seeds differ in their low 32 bits (the CPU generator keeps only
those; the step is odd, so ranks below 2**32 never collide).
"""
import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.learning.replay import tree_map
from lifelike_tpu_torch.parallel import mesh as meshlib
from lifelike_tpu_torch.parallel.mesh import Mesh

DEFAULT_TIMEOUT_S = 600.0
_MESH: Optional[Mesh] = None  # set by initialize() when a group exists


def _env_int(name, default):
    v = os.environ.get(name, "")
    return int(v) if v else default


def rank_device(process_id: int, device=None) -> torch.device:
    """The device of rank `process_id`: `device` when given, else
    cuda:{rank % device_count} (raises without a card)."""
    if device is not None:
        dev = _device.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        return dev
    _device.resolve_device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize(coordinator=None, num_processes=None, process_id=None, backend=None,
               device=None, timeout_s=DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a multi-process run.

    Arguments default from the LIFELIKE_* environment. Returns False and
    creates no group when the world is one process and no backend is
    asked for; True when a group was created (then global_mesh() is this
    rank's mesh). timeout_s bounds every collective (a rank whose peer
    died raises instead of hanging).
    """
    global _MESH
    coordinator = coordinator or os.environ.get("LIFELIKE_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("LIFELIKE_NUM_PROCESSES", 1)
    if process_id is None:
        process_id = _env_int("LIFELIKE_PROCESS_ID", 0)
    backend = backend or os.environ.get("LIFELIKE_BACKEND") or None
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    dev = rank_device(process_id, device)
    if num_processes <= 1 and backend is None:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    if not coordinator:
        raise ValueError("a process group needs a coordinator address host:port "
                         "(--coordinator or LIFELIKE_COORDINATOR)")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, got {dev}")
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    if backend == "nccl":
        _refuse_shared_devices(store, num_processes, process_id, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _MESH = Mesh(group=dist.group.WORLD, rank=process_id, world=num_processes, device=dev,
                 backend=backend)
    return True


def _refuse_shared_devices(store, num_processes: int, process_id: int, dev: torch.device):
    """Post this rank's (host name, device index) to the store, read every
    rank's, and raise on every rank when two ranks share a device."""
    key = "lifelike/device/{}".format
    store.set(key(process_id), f"{socket.gethostname()}/cuda:{dev.index}")
    keys = [key(r) for r in range(num_processes)]
    store.wait(keys)
    ranks = {}
    for r, k in enumerate(keys):
        ranks.setdefault(store.get(k).decode(), []).append(r)
    shared = {d: rs for d, rs in ranks.items() if len(rs) > 1}
    if shared:
        raise ValueError(f"backend nccl: ranks {shared} share a device, which NCCL refuses; "
                         "run them with --backend=gloo")


def destroy():
    """Leave the process group (no-op without one)."""
    global _MESH
    if _MESH is not None:
        dist.destroy_process_group()
        _MESH = None


def global_mesh(device=None) -> Mesh:
    """This rank's mesh after initialize(); without a group, the mesh of
    one process on `device` (default the card)."""
    if _MESH is not None:
        if device is not None:
            want = _device.resolve_device(device)
            if want.type != _MESH.device.type or want.index not in (None, _MESH.device.index):
                raise ValueError(f"device {device} is not this rank's {_MESH.device}")
        return _MESH
    return meshlib.make_mesh("cuda" if device is None else device)


def is_main(mesh: Optional[Mesh] = None) -> bool:
    """Whether this is rank 0 (of `mesh`, else of the initialized group;
    True for one process)."""
    mesh = mesh if mesh is not None else _MESH
    return mesh is None or mesh.rank == 0


RANK_SEED_STEP = 0x9E3779B9  # odd, so rank * step differs mod 2**32 for every rank


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generators: seed + rank * RANK_SEED_STEP
    (rank 0's is `seed`)."""
    return int(seed) + int(rank) * RANK_SEED_STEP


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """A generator on this rank's device seeded by rank_seed(seed, rank)."""
    return torch.Generator(device=mesh.device).manual_seed(rank_seed(seed, mesh.rank))


# ---------------------------------------------------------------------------
# collectives (the identity on a mesh without a group)
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh, x) -> bool:
    """Whether a collective on x goes through host memory (gloo on CUDA)."""
    return mesh.backend == "gloo" and x.is_cuda


def _work(mesh: Mesh, x):
    """The buffer a collective runs on: a copy of x, on the host where
    staged."""
    x = x.detach()
    return x.to("cpu", copy=True) if _staged(mesh, x) else x.clone()


def _reduce(x, mesh: Mesh, op):
    if mesh.group is None:
        return x
    is_bool = x.dtype == torch.bool
    t = _work(mesh, x.to(torch.int32) if is_bool else x)
    dist.all_reduce(t, op=op, group=mesh.group)
    t = t.to(x.device)
    return t.bool() if is_bool else t


def all_sum(x, mesh: Mesh):
    """Sum over ranks (lax.psum); every rank gets the same bits."""
    return _reduce(x, mesh, dist.ReduceOp.SUM)


def all_min(x, mesh: Mesh):
    return _reduce(x, mesh, dist.ReduceOp.MIN)


def all_mean(x, mesh: Mesh):
    """Mean over ranks (lax.pmean): the sum, then / world."""
    if mesh.group is None:
        return x
    return all_sum(x, mesh) / mesh.world


def all_gather(x, mesh: Mesh):
    """(world, *x.shape): every rank's x, in rank order (lax.all_gather)."""
    if mesh.group is None:
        return x[None]
    t = _work(mesh, x).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).to(x.device)


def broadcast(x, mesh: Mesh, src: int = 0):
    """Rank `src`'s x on every rank (a new tensor on x's device)."""
    if mesh.group is None:
        return x
    t = _work(mesh, x).contiguous()
    dist.broadcast(t, src=src, group=mesh.group)
    return t.to(x.device)


def barrier(mesh: Mesh):
    """Wait until every rank has got here (a one-element sum read on the
    host, so it also orders the device's queue)."""
    if mesh.group is not None:
        all_sum(torch.ones(1, device=mesh.device), mesh).item()


def mean_tree(tree, mesh: Mesh):
    """all_mean of every floating-point leaf of a tree of tensors, in one
    collective (the leaves are packed into one buffer)."""
    if mesh.group is None:
        return tree
    leaves = []
    tree_map(lambda x: leaves.append(x), tree)
    flat = torch.cat([x.detach().reshape(-1).to(leaves[0].dtype) for x in leaves])
    flat = all_mean(flat, mesh)
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
        at += x.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def sum_tree(tree, mesh: Mesh):
    """all_sum of every leaf of a tree of tensors (one collective per leaf)."""
    return tree_map(lambda x: all_sum(x, mesh), tree)


# ---------------------------------------------------------------------------
# the JAX package's host <-> global helpers, per rank
# ---------------------------------------------------------------------------


def host_local_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's slice of a global batch (rank r takes rows
    [r B / W, (r + 1) B / W) of every leaf along `axis`); ValueError when
    the world size does not divide B. The JAX package assembles a global
    array from the local slices instead; the port keeps the slice."""
    return meshlib.shard_batch(mesh, tree, axis)


def host_local_axis(mesh: Mesh, tree, axis_idx: int):
    """host_local_batch along a non-leading axis; leaves with no more than
    `axis_idx` dimensions (scalars, cursors) stay whole, as replicated."""
    def cut(x):
        if not torch.is_tensor(x) or x.dim() <= axis_idx:
            return x
        return meshlib.shard_batch(mesh, x, axis_idx)

    return tree_map(cut, tree)


replicate = meshlib.replicate  # every tensor leaf as rank 0 holds it


def fetch(x, mesh: Mesh):
    """Host (numpy) value of a replicated tensor; raises ValueError when
    the ranks disagree on it (the JAX package's "fully replicated" guard):
    rank 0's value is broadcast and the count of elements that differ from
    it bitwise (NaN equal to NaN) is summed over ranks."""
    if mesh.group is not None:
        x0 = broadcast(x, mesh)
        differ = (x != x0)
        if x.is_floating_point():
            differ &= ~(torch.isnan(x) & torch.isnan(x0))
        n = int(all_sum(differ.sum().reshape(1), mesh).item())
        if n:
            raise ValueError(f"fetch: {n} element(s) differ across the {mesh.world} ranks "
                             "(not a replicated value)")
    return np.asarray(x.detach().cpu())

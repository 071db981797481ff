"""Entry points: the flagship PMC policy's forward step and a multi-rank
dry run.

Port of the JAX package's `__graft_entry__`: `entry` is a PMCNet (random
weights from seed 0) and a zero batch of B 8 observations on `device`
(default the card; no silent CPU fallback); `dryrun_multichip` runs one
data-parallel PPO step over n ranks.
"""
import os
import re
import sys
import tempfile

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.models import pmc

B = 8


def entry(device="cuda"):
    """(fn, example_args): fn(net, prop, prop_a, future) -> (mean, value)."""
    dev = _device.resolve_device(device)
    net = pmc.PMCNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    prop = torch.zeros((B, pmc.PROP_DIM), device=dev)
    prop_a = torch.zeros((B, pmc.PROP_A_DIM), device=dev)
    future = torch.zeros((B, pmc.FUTURE_DIM), device=dev)

    def fn(net, prop, prop_a, future):
        with torch.no_grad():
            out = net(prop, prop_a, future)
        return out.mean, out.value

    return fn, (net, prop, prop_a, future)


def dryrun_multichip(n_ranks: int, device="cuda", backend=None, timeout=600.0):
    """One full data-parallel PPO step (collection and update) over n_ranks
    processes, after one sharded MPPI solve: tools/multihost_worker.py
    started by tools/launch_multihost.py. device "cuda" puts rank r on
    cuda:{r % cards}; more ranks than cards need backend="gloo" (NCCL
    refuses two ranks on one card, and nothing switches the backend).
    Raises unless every rank exits 0 with the same finite loss; returns
    that loss."""
    from lifelike_tpu_torch.tools import launch_multihost

    _device.resolve_device(device)
    cmd = [sys.executable, "-m", "lifelike_tpu_torch.tools.multihost_worker",
           f"--device={device}"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as logs:
        rcs = launch_multihost.launch(cmd, n_ranks, backend=backend,
                                      cpu=torch.device(device).type == "cpu", log_dir=logs,
                                      timeout=timeout, cwd=root)
        text = [open(os.path.join(logs, f"rank{r}.log")).read() for r in range(n_ranks)]
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n_ranks}): rank exit codes {rcs}\n"
                           + "\n".join(t[-2000:] for t in text))
    losses = {float(m) for t in text for m in re.findall(r"sharded train step ok; loss=(\S+)", t)}
    if len(losses) != 1:  # every rank prints the same (fetched, replicated) loss
        raise RuntimeError(f"dryrun_multichip({n_ranks}): losses {losses}")
    loss = losses.pop()
    print(f"dryrun_multichip({n_ranks}) ok; loss={loss:.4f}")
    return loss

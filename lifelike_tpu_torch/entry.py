"""Entry point: the flagship PMC policy's forward step.

Port of the JAX package's `__graft_entry__.entry`: a PMCNet (random
weights from seed 0) and a zero batch of B 8 observations on `device`
(default the card; no silent CPU fallback).
"""
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

"""Shared set-up and timing of the measurement tools (sol_report,
probe_sweep, epmc_sweep, scaling_bench, multihost_worker --bench).

  * `standing_state` / `standing_tl` — the robot standing at 0.33 m, as the
    reference's bench.py `_stand_state`;
  * `time_ms` — milliseconds of calls of a function, each timed alone with
    CUDA events on the card (the host clock on the CPU), after a warm-up
    call whose output it returns too.
"""
import time

import torch

from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics.dynamics import RobotState

STAND_Q = (-0.028, -0.779, 1.687) * 4


def standing_state(dtype, device) -> RobotState:
    """The robot standing at 0.33 m, at rest (unbatched)."""
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return RobotState(base_pos=torch.tensor([0.0, 0.0, 0.33], dtype=dtype, device=device),
                      base_orn=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device),
                      base_lin_vel=z3, base_ang_vel=z3.clone(),
                      joint_pos=torch.tensor(STAND_Q, dtype=dtype, device=device),
                      joint_vel=torch.zeros(12, dtype=dtype, device=device))


def standing_tl(dtype, device) -> B.TLState:
    """standing_state as a TLState with batch (1, 1)."""
    return B.tl_from_state(B.map_state(lambda x: x[None], standing_state(dtype, device)))


def time_ms(fn, warm, args, device):
    """([ms of fn(a)] for each a in `args`, the output of fn(warm), a
    warm-up call before them): CUDA events around each call on the card,
    the host clock (after a synchronize) on the CPU."""
    cuda = torch.device(device).type == "cuda"
    first = fn(warm)
    if cuda:
        torch.cuda.synchronize(device)
    out = []
    for a in args:
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(a)
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn(a)
            out.append(1e3 * (time.perf_counter() - t0))
    return out, first

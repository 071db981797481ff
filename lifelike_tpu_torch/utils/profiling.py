"""Tracing, latency measurement and speed-of-light accounting on the card.

Port of lifelike_tpu.utils.profiling:

- `trace(logdir)`: a torch.profiler trace (CPU, and CUDA where a card is
  present) written as a Chrome trace, logdir/trace.json.
- `annotate(name)`: a named region on that trace (record_function).
- `cost_analysis(fn, *args)`: the FLOPs PyTorch's FlopCounterMode counts for
  one call (2mnk for a matmul). It counts no bytes, so `speed_of_light`
  given `fn` needs `bytes_accessed=`.
- `speed_of_light(...)`: roofline accounting — the card's peak FLOP/s and
  HBM bandwidth give the least possible time and which resource bounds it;
  with a measured time, the fraction of it achieved.
- `chained_latency(step, state)`: per-call latency as the slope over m_lo
  and m_hi chained data-dependent calls (CUDA events on the card, the host
  clock on the CPU), which cancels the fixed cost of a timed region;
  `chained_calls` counts the calls it makes.
- `card_label(device)`: the card's name and power limit as nvidia-smi
  reports them, the label every measured number stands beside.

The card table holds NVIDIA's published peaks (data sheet, SXM part, at its
700 W power limit); a card set below that limit runs slower under load, so
a report names the card and its limit beside every share.
"""
import contextlib
import os
import subprocess
import time
from typing import NamedTuple, Optional

import torch


class ChipSpec(NamedTuple):
    name: str
    peak_flops_f32: float  # FLOP/s, float32 outside the tensor cores
    peak_flops_f64: float  # FLOP/s, float64 outside the tensor cores
    hbm_bytes_per_s: float
    power_limit_w: float  # the power limit the peaks hold at


H100_SXM = ChipSpec("NVIDIA H100 80GB HBM3", 67e12, 34e12, 3.35e12, 700.0)
CHIP_SPECS = {H100_SXM.name: H100_SXM}
_FALLBACK = ChipSpec("unknown", 1e12, 5e11, 1e11, 0.0)


def detect_chip(device=None) -> ChipSpec:
    """The ChipSpec of the CUDA card `device` (default: the current one) by
    torch.cuda.get_device_name, exact or by the SXM part's name; otherwise
    the fallback under the card's name, or "unknown" where there is none."""
    kind = torch.cuda.get_device_name(device) if torch.cuda.is_available() else ""
    if kind in CHIP_SPECS:
        return CHIP_SPECS[kind]
    if "H100" in kind and ("HBM3" in kind or "SXM" in kind):
        return H100_SXM
    return _FALLBACK._replace(name=kind or "unknown")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler; writes logdir/trace.json."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region on the trace timeline."""
    return torch.profiler.record_function(name)


def cost_analysis(fn, *args, **kwargs) -> dict:
    """{'flops': ...} of one call fn(*args, **kwargs), as
    torch.utils.flop_counter.FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


class SolReport(NamedTuple):
    flops: float
    bytes_accessed: float
    t_compute_s: float  # FLOP-bound lower bound
    t_memory_s: float  # HBM-bound lower bound
    sol_s: float  # max of the two: the speed-of-light runtime
    bound: str  # 'compute' | 'memory'
    arithmetic_intensity: float  # FLOP / byte
    measured_s: Optional[float]
    achieved_fraction: Optional[float]  # sol_s / measured_s (1.0 = at SoL)
    chip: str


def speed_of_light(fn=None, *args, flops: Optional[float] = None,
                   bytes_accessed: Optional[float] = None, spec: Optional[ChipSpec] = None,
                   measured_s: Optional[float] = None, dtype_peak: str = "f32") -> SolReport:
    """Roofline report for a callable (`fn, *args`: its FLOPs from
    cost_analysis, its bytes from `bytes_accessed=`) or for explicit
    `flops=` / `bytes_accessed=` from an analytic count. dtype_peak: "f32"
    or "f64"."""
    if fn is not None and flops is None:
        flops = cost_analysis(fn, *args)["flops"]
    if flops is None or bytes_accessed is None:
        raise ValueError("speed_of_light needs flops= (or fn) and bytes_accessed=: "
                         "FlopCounterMode counts no bytes")
    spec = spec or detect_chip()
    peak = {"f32": spec.peak_flops_f32, "f64": spec.peak_flops_f64}[dtype_peak]
    t_c = flops / peak
    t_m = bytes_accessed / spec.hbm_bytes_per_s
    sol = max(t_c, t_m)
    return SolReport(
        flops=flops,
        bytes_accessed=bytes_accessed,
        t_compute_s=t_c,
        t_memory_s=t_m,
        sol_s=sol,
        bound="compute" if t_c >= t_m else "memory",
        arithmetic_intensity=flops / max(bytes_accessed, 1.0),
        measured_s=measured_s,
        achieved_fraction=(sol / measured_s) if measured_s else None,
        chip=spec.name,
    )


def _device_of(state):
    if torch.is_tensor(state):
        return state.device
    for x in state if isinstance(state, (tuple, list)) else ():
        d = _device_of(x)
        if d is not None:
            return d
    return None


def chained_latency(step, state, m_lo: int = 2, m_hi: int = 8, reps: int = 3):
    """Per-call latency (seconds) of `state -> state`: the best of `reps`
    timings of m chained calls for m = m_lo and m_hi, and the slope
    (t_hi - t_lo) / (m_hi - m_lo). CUDA events where the state is on the
    card, the host clock otherwise. `step` must be data-dependent from call
    to call (the state flows through). Where noise leaves the slope at or
    below 0, it returns t_hi / m_hi, an upper bound (bench.py's last
    resort), so a latency is always positive."""
    dev = _device_of(state)
    cuda = dev is not None and dev.type == "cuda"

    def chain(m):
        s = state
        for _ in range(m):
            s = step(s)
        return s

    def runner(m):
        chain(m)  # warm
        best = float("inf")
        for _ in range(reps):
            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                chain(m)
                ev1.record()
                ev1.synchronize()
                t = ev0.elapsed_time(ev1) / 1e3
            else:
                t0 = time.perf_counter()
                chain(m)
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    t_lo, t_hi = runner(m_lo), runner(m_hi)
    slope = (t_hi - t_lo) / (m_hi - m_lo)
    return slope if slope > 0.0 else t_hi / m_hi


def chained_calls(m_lo: int = 2, m_hi: int = 8, reps: int = 3) -> int:
    """The calls of `step` that chained_latency makes: a warm chain and
    `reps` timed chains at m_lo and at m_hi."""
    return (1 + reps) * (m_lo + m_hi)


def card_label(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    CUDA card `device` (its name and power limit), or "cpu" for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def format_report(r: SolReport) -> str:
    lines = [
        f"chip {r.chip}: {r.flops:.3e} FLOP, {r.bytes_accessed:.3e} B "
        f"(AI {r.arithmetic_intensity:.1f} FLOP/B)",
        f"speed of light {r.sol_s * 1e3:.3f} ms ({r.bound}-bound; "
        f"compute {r.t_compute_s * 1e3:.3f} ms / memory {r.t_memory_s * 1e3:.3f} ms)",
    ]
    if r.measured_s is not None:
        lines.append(
            f"measured {r.measured_s * 1e3:.3f} ms = "
            f"{100.0 * r.achieved_fraction:.1f}% of speed of light"
        )
    return "\n".join(lines)

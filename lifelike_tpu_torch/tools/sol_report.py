"""Roofline (speed-of-light) report of the PMC solve on K1.

Port of tools/sol_report.py. Builds the bench-shaped PMC solve (population
SOL_POP, horizon SOL_HORIZON, SOL_SUBSTEPS substeps with mass_freeze =
substeps, one MPPI iteration, the synthetic clip, the robot standing):
solver.mppi_tl.mppi_step, whose candidates K1
(ops.rollout_cuda.rollout_tracking_fused) rolls out. It times the solve as
the slope over chained solves (utils.profiling.chained_latency: CUDA events
on the card; the host clock on the CPU, where K1's plain version runs) and
prints

  * the cost_analysis roofline. FlopCounterMode counts PyTorch's own
    operators; K1, a hand-written kernel launched through ctypes, is none of
    them, so the solve reads as ~0 FLOPs, as the reference's XLA cost
    analysis reads its Pallas custom call. The bytes are K1's own (its
    inputs read once, its costs written once);
  * M physics substeps/s;
  * the arithmetic model: K1's operations per candidate per control step
    (utils.op_counts, the reference's scalar physics traced) x population
    x H over the measured time, as a share of the card's FP32 peak outside
    the tensor cores (utils.profiling.detect_chip), beside the card's name
    and power limit. The physics is scalar FP32 work with no matrix
    product, so that peak, not a tensor-core one, is its roofline.

    python -m lifelike_tpu_torch.tools.sol_report [--device cpu]
    SOL_POP=512 SOL_HORIZON=10 python -m lifelike_tpu_torch.tools.sol_report

Ends with one JSON line of its numbers.
"""
import argparse
import json
import os

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mppi_tl, rollout_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools.bench_common import standing_tl
from lifelike_tpu_torch.utils import op_counts
from lifelike_tpu_torch.utils import profiling as P

M_LO, M_HI, REPS = 2, 6, 2  # the chained-latency slope, as the reference times it


def expected_launches(argv=None):
    """K1-K4 launches of one run on the card: one solve under
    FlopCounterMode, then the chained solves; one K1 launch per solve."""
    return {"K1": 1 + P.chained_calls(M_LO, M_HI, REPS), "K2": 0, "K3": 0, "K4": 0}


def make_solve(dev, pop, horizon, substeps, seed=0):
    """(solve: u (H, 4, 3) -> u', K1's bytes per solve) of the bench-shaped
    PMC solve on `dev`."""
    model = build_max_model()
    frames = motion_lib.make_synthetic_clip(int(120 * (horizon / 50.0 + 3)))
    clips = motion_lib.pack_clips([frames], frame_step=1.0 / 120.0, device=dev)
    params = engine.PhysicsParams(substeps=substeps, mass_freeze=substeps)
    cfg = MPPIConfig(horizon=horizon, population=pop, iterations=1)
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    tl = standing_tl(torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = torch.tensor(0.0, dtype=torch.float32, device=dev)

    def solve(u):
        ref = rollout_tl.precompute_reference(model, clips, 0, t0, horizon,
                                              params.dt * params.substeps)
        return mppi_tl.mppi_step(c, params, cfg, gen, tl, u, ref)[0]

    # K1 reads the candidates, the start state (37), the reference rows
    # (H x 64) and the packed model once, and writes one cost per candidate
    nbytes = 4 * (horizon * 12 * pop + 37 + horizon * 64 + rollout_cuda.pack_model(c).numel()
                  + pop)
    return solve, nbytes


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu (no fallback)")
    args = ap.parse_args(argv)
    pop = int(os.environ.get("SOL_POP", 4096))
    horizon = int(os.environ.get("SOL_HORIZON", 50))
    substeps = int(os.environ.get("SOL_SUBSTEPS", 10))
    dev = _device.resolve_device(args.device)

    solve, nbytes = make_solve(dev, pop, horizon, substeps)
    u0 = torch.zeros((horizon, 4, 3), dtype=torch.float32, device=dev)
    ca = P.cost_analysis(solve, u0)
    dt = P.chained_latency(solve, u0, m_lo=M_LO, m_hi=M_HI, reps=REPS)
    r = P.speed_of_light(flops=ca["flops"], bytes_accessed=float(nbytes), measured_s=dt)
    card = P.card_label(dev)
    log(f"solve pop={pop} H={horizon} sub={substeps} on {dev} [{card}]")
    log("-- cost_analysis roofline (FlopCounterMode counts PyTorch's own operators: K1, a")
    log("   hand-written kernel, reads as ~0 FLOPs, so the bound below is that of K1's")
    log("   bytes and of the solve's few matrix products) --")
    log(P.format_report(r))
    subs = pop * horizon * substeps
    log(f"{subs / dt / 1e6:.0f} M physics substeps/s")

    # the FP32 arithmetic model: K1's scalar operations per candidate per
    # control step, as the reference's scalar physics traces (utils.op_counts)
    ops_lane = op_counts.k1_ops(substeps, substeps)
    kernel_ops = ops_lane * pop * horizon
    spec = P.detect_chip(dev if dev.type == "cuda" else None)
    share = kernel_ops / dt / spec.peak_flops_f32
    log("-- FP32 arithmetic model (utils.op_counts: the reference's scalar physics traced) --")
    log(f"   {ops_lane:,} scalar ops/lane/control-step; {kernel_ops / 1e9:.1f} GFLOP per solve")
    log(f"   achieved {kernel_ops / dt / 1e12:.2f} TFLOP/s over {dt * 1e3:.2f} ms on {spec.name} "
        f"[{card}]")
    log(f"   = {share:.1%} of the {spec.peak_flops_f32 / 1e12:.0f} TFLOP/s FP32 peak outside the "
        "tensor cores (the scalar physics has no matrix product for them)")
    out = {"pop": pop, "horizon": horizon, "substeps": substeps, "device": str(dev),
           "card": card, "ms_per_solve": dt * 1e3, "flops_counted": ca["flops"],
           "bytes": nbytes, "sol_ms": r.sol_s * 1e3, "msubsteps_per_s": subs / dt / 1e6,
           "ops_per_lane_step": ops_lane, "gflop_per_solve": kernel_ops / 1e9,
           "tflops": kernel_ops / dt / 1e12, "fp32_peak_share": share,
           "peak_tflops": spec.peak_flops_f32 / 1e12}
    log(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the lifelike_tpu_torch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before the
result line:
  1. the device (torch name, nvidia-smi name and power limit);
  2. the CUDA rollout kernel build (nvcc wall time, ptxas registers/spills,
     runtime registers, local bytes and resident blocks per SM);
  3. kernel vs its plain PyTorch version, float32, at the JAX kernel test's
     shape (H 3, substeps 2, mass_freeze 1), population 4096, rtol=atol=2e-4;
  4. kernel vs plain version, float64, rtol=atol=1e-6, at the headline
     solve shape (population 4096, H 50, substeps 10, mass_freeze 10) and at
     the closed loop's own (the same with mass_freeze 1, the default plant);
  5. the closed loop through bin/run_mpc (PMC tracking, population 4096,
     H 50, 1 MPPI iteration, default plant) for STEPS control steps, with
     the kernel's launch count checked against solves x iterations;
  6. timings at the headline solve shape (float32, mass_freeze 10): kernel,
     plain version and the kernel's bound on this card, and the kernel at
     mass_freeze 1 (the closed loop's setting);
then one JSON line per kernel, the nvidia-smi line, and last the result line
{"ok": true, "device": {...}}. Needs one card; builds the kernel from the
sources in lifelike_tpu_torch/csrc/ with nvcc. Exits non-zero without a
result when no card (or no lifelike_tpu_torch beside this file) is present.
"""
import json
import math
import statistics
import subprocess
import sys
import time

STEPS = 20  # closed-loop control steps
POP, HORIZON, SUBSTEPS = 4096, 50, 10  # headline solve shape (bench.py bench_pmc)
# Scalar operations per candidate per control step of the physics at
# substeps 10 / mass_freeze 10: tools/sol_report.py::_lane_flops_per_control_step
# on lifelike_tpu.ops.scalar_phys.control_step, counted on the CPU.
OPS_PER_LANE_STEP = 52286
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
SOURCE = "lifelike_tpu_torch/csrc/rollout_tracking.cu"
REPLACES = "lifelike_tpu/ops/rollout_pallas.py:202"


def say(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def solve_inputs(dtype, horizon, substeps, mass_freeze, pop, seed, noise="ar1",
                 device="cuda"):
    """Standing start, synthetic clip, candidates as the MPPI solver makes
    them (sigma 0.08, AR(1) beta 0.7) or plain 0.05 N(0, 1) deltas."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.motion import motion_lib
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics import engine
    from lifelike_tpu_torch.physics.dynamics import RobotState
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.solver import mppi, mppi_tl, rollout_tl

    dev = torch.device(device)
    model = build_max_model()
    clips = motion_lib.pack_clips(
        [motion_lib.make_synthetic_clip(int(120 * (horizon / 50.0 + 3)))],
        frame_step=1.0 / 120.0, device=dev)
    params = engine.PhysicsParams(substeps=substeps, mass_freeze=mass_freeze)
    c = B.tl_constants(model, dtype=dtype, device=dev)
    rng = np.random.default_rng(seed)
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    stand = np.array([-0.028, -0.779, 1.687] * 4)
    state = RobotState(
        base_pos=T([[0.0, 0.0, 0.33]]), base_orn=T([[0.0, 0.0, 0.0, 1.0]]),
        base_lin_vel=T(np.zeros((1, 3))), base_ang_vel=T(np.zeros((1, 3))),
        joint_pos=T(stand[None] + 0.02 * rng.standard_normal((1, 12))),
        joint_vel=T(np.zeros((1, 12))),
    )
    tl = B.tl_from_state(state)
    ref = rollout_tl.precompute_reference(model, clips, 0, T(0.2), horizon,
                                          params.dt * params.substeps)
    lanes = 128
    eps = T(rng.standard_normal((horizon, 4, 3, pop // lanes, lanes)))
    if noise == "ar1":
        cfg = mppi.MPPIConfig()
        u = cfg.sigma * mppi_tl._smooth_noise_tl(None, eps.shape, cfg.beta, dtype, dev, eps=eps)
    else:
        u = 0.05 * eps
    return c, params, tl, u.contiguous(), ref


def compare(label, dtype, horizon, substeps, mass_freeze, tol, seed):
    import torch

    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.solver import rollout_tl

    c, params, tl, u, ref = solve_inputs(dtype, horizon, substeps, mass_freeze, POP, seed,
                                         noise="ar1" if horizon > 3 else "normal")
    got = rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref)
    torch.cuda.synchronize()
    want, _ = rollout_tl.rollout_tracking(c, params, tl, u, ref)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise SystemExit(f"{label}: non-finite costs")
    err = (got - want).abs()
    max_abs = float(err.max())
    bad = int((err > tol + tol * want.abs()).sum())
    say(f"{label}: pop {POP} H {horizon} substeps {substeps} mass_freeze {mass_freeze} "
        f"{str(dtype).replace('torch.', '')}: max|kernel-plain| {max_abs:.3e} "
        f"(rtol=atol={tol:g}, {bad} outside) | cost mean {float(want.mean()):.6f} "
        f"min {float(want.min()):.6f} max {float(want.max()):.6f}")
    if bad:
        raise SystemExit(f"{label}: kernel disagrees with its plain version")
    return max_abs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.bin import run_mpc
    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.solver import rollout_tl

    t_start = time.perf_counter()
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvidia-smi: {smi}")

    # 2. build
    info = rollout_cuda.build()
    ptx = rollout_cuda.ptxas_summary(info.ptxas)
    say(f"build: nvcc {info.seconds:.1f} s -> {info.path}")
    for sym, v in sorted(ptx.items()):
        tname = "f64" if "IdEE" in sym else "f32"
        say(f"ptxas {tname}: {v}")
    for dt in (torch.float32, torch.float64):
        a = rollout_cuda.kernel_attributes(dt, HORIZON)
        say(f"runtime {str(dt).replace('torch.', '')}: {a} | candidates/SM at pop {POP}: "
            f"{POP / 132:.1f} of {a['blocks_per_sm'] * a['block']} resident")

    # 3. / 4. kernel vs plain version
    err32 = compare("check f32", torch.float32, 3, 2, 1, 2e-4, seed=1)
    compare("check f64", torch.float64, HORIZON, SUBSTEPS, SUBSTEPS, 1e-6, seed=2)
    compare("check f64 closed-loop setting", torch.float64, HORIZON, SUBSTEPS, 1, 1e-6,
            seed=4)

    # 5. the main path: closed loop through bin/run_mpc on the kernel
    rollout_cuda.rollout_tracking_fused.launches = 0
    out = run_mpc.run_pmc(run_mpc.parse_args([
        "--task=pmc", f"--steps={STEPS}", f"--population={POP}",
        f"--horizon={HORIZON}", "--iterations=1", "--device=cuda", "--seed=0",
    ]), log=lambda m: say("run_mpc: " + m))
    launches = rollout_cuda.rollout_tracking_fused.launches
    rewards = out["step_rewards"]
    say("closed loop rewards: " + " ".join(f"{r:.4f}" for r in rewards))
    t_ms = [1e3 * t for t in out["t_solve"][1:]]
    p50 = statistics.median(t_ms)
    say(f"closed loop: {len(rewards)} steps, episode ends at {out['episode_ends']}, "
        f"solve latency after warm-up p50 {p50:.3f} ms max {max(t_ms):.3f} ms "
        f"(CUDA events) | kernel launches {launches} (solves x iterations = {STEPS})")
    if len(rewards) != STEPS or not all(math.isfinite(r) for r in rewards):
        raise SystemExit("closed loop: missing or non-finite rewards")
    if launches != STEPS * 1:
        raise SystemExit(f"closed loop: {launches} kernel launches, expected {STEPS}")

    # 6. timings at the headline solve shape
    c, params, tl, u, ref = solve_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 3)
    kernel_ms = cuda_ms(lambda: rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref),
                        reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: rollout_tl.rollout_tracking(c, params, tl, u, ref),
                       reps=1, warmup=1)
    # the closed loop's solver runs the default plant parameters (mass_freeze 1)
    c1, params1, tl1, u1, ref1 = solve_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 3)
    exact_ms = cuda_ms(lambda: rollout_cuda.rollout_tracking_fused(c1, params1, tl1, u1, ref1),
                       reps=20, warmup=3)
    ops = OPS_PER_LANE_STEP * POP * HORIZON
    nbytes = 4 * (u.numel() + 37 + HORIZON * 64 + rollout_cuda.pack_model(c).numel() + POP)
    ops_ms, bytes_ms = 1e3 * ops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
    bound_ms = max(ops_ms, bytes_ms)
    say(f"timing f32 pop {POP} H {HORIZON} substeps {SUBSTEPS} mass_freeze {SUBSTEPS}: "
        f"kernel {kernel_ms:.4f} ms | plain {plain_ms:.1f} ms | bound {bound_ms:.4f} ms "
        f"({ops:.4e} ops / 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes} B / 3.35 TB/s = "
        f"{bytes_ms:.5f} ms) | kernel at {100 * bound_ms / kernel_ms:.2f}% of bound | "
        f"library: none | kernel at mass_freeze 1 (closed-loop setting) {exact_ms:.4f} ms")

    say(json.dumps({"kernels": [{
        "name": "rollout_tracking_fused (K1 with K0 inlined)",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the lifelike_tpu_torch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before the
result line:
  1. the device (torch name, nvidia-smi name, power limit and maximum SM
     clock);
  2. the build of the six CUDA kernels (one nvcc per source, started
     together; wall time, ptxas registers/spills, runtime registers, local
     bytes and resident blocks per SM; for K1-K4 also the lanes per
     candidate / plan, the candidates per block and the warps per SM at the
     solves' widths): K1 the PMC tracking rollout, K2 the EPMC traversal
     rollout with box contact, K3 the SEPMC opponent plan rollout and K4 the
     SEPMC chase rollout (each candidate / plan on a group of lanes of one
     warp), K5 the hard-contact plant's PGS sweep (float32 and float64, 60
     and 129 rows; each robot on a group of lanes of a one-warp block: the
     lanes per robot, robots per block, dynamic shared memory and the SMs
     bench_impulse's B 256 occupies), K6 the iLQR Riccati backward sweep
     (float32 and float64, its dynamic shared memory);
  3. K1 vs its plain PyTorch version, float32, at the JAX kernel test's
     shape (H 3, substeps 2, mass_freeze 1), population 4096, rtol=atol=2e-4;
  4. K1 vs plain version, float64, rtol=atol=1e-6, at the headline solve
     shape (population 4096, H 50, substeps 10, mass_freeze 10) and at the
     closed loop's own (the same with mass_freeze 1, the default plant);
  5. K2 vs its plain version on a hurdle course with a foot on a hurdle:
     float32 at population 4096, H 3, substeps 2, rtol=atol=2e-4, for both
     reward types, gait_weight 1 and 0, default and crawl_gap weights;
     float64 at population 4096, H 50, substeps 10, 8 boxes, 1e-6, at
     mass_freeze 10 (gait prior) and at the closed loop's mass_freeze 1
     (constant reference, gait_weight 0) — over the candidates whose plain
     cost does not itself move beyond 1e-6 when the start state shifts by
     1e-10 m (the others, which tumble over the hurdle chaotically, are
     counted and reported); four scenario blocks (S = 4);
  6. K3 vs its plain version on an arena with a hurdle and cubes, the robot's
     front feet on the hurdle: float32 at H 3, substeps 2, rtol=atol=2e-4;
     float64 at H 50, substeps 20, mass_freeze 1 (the chase plant), 1e-6,
     screened as in 5; each for one plan (S = 1) and for S = 16 plans with
     their own start states, box tables and reference rows;
  7. K4 vs its plain version on the same arena: float32 at population
     2048, H 3, substeps 2, 2e-4, for both roles, gait_weight 0.8 and 0;
     float64 at H 50, 1e-6, screened, at substeps 10 / mass_freeze 10 (gait
     prior, chaser) and at the closed loop's substeps 20 / mass_freeze 1
     (constant reference, gait_weight 0, escapee); four scenario blocks
     (S = 4) with their own opponent trajectories, flags and roles;
  8a. K5 vs its plain version on the card: the reference Pallas test's
     random system (B 128, 60 rows, 4 iterations), its walking substep
     (B 128, 3 iterations) and the 129-row hurdle system with a per-element
     mu at B 256 and B 1 (10 iterations); float64 at 1e-9, float32 at
     1e-5 (on the hurdle system at B 256, whose own rounding moves the
     plain sweep by more, at twice the plain version's distance from the
     float64 sweep plus 1e-5); then the random and the B 256 hurdle system
     cut to batches that are not a multiple of K5's robots per block (B 5,
     and B 257 with robot i the system's robot i mod B), to two leading
     batch axes ((2, 3)) and with a non-contiguous J, each at its system's
     gate;
  8b. the port's impulse.control_step through K5 against the golden traces
     (lifelike_tpu_torch/data/oracle_traces, H 50): float64 max |dq| < 1e-5
     on walk, run, stand and hurdle; float32 over 64 starts per trace 1e-6
     rad apart (the trace's own first), the first step < 1e-5 and the median
     H 50 error under the JAX tests' ceilings (walk, run 1e-2, stand 2e-2,
     hurdle 6e-3);
  8c. K6 vs its plain version on random LQR systems shaped as the reference
     test's (S 3 and S 8 scenarios, H 50, reg 1e-3 and 0; S 1, S 13 and H 1
     at reg 1e-3): float32 at 2e-5 (x max(|k|, 1) for the feedforward
     gains), float64 at 1e-9; and a stiff system (S 2, H 50: Cuu 3e-3 I
     beside B'VB ~1e6) at 10d's gates;
  8. the PMC closed loop through bin/run_mpc (population 4096, H 50, 1 MPPI
     iteration, default plant) for STEPS control steps, with K1's launch
     count checked against solves x iterations;
  9. the EPMC closed loop through bin/run_mpc --task=epmc (hurdles,
     population 4096, H 50, 1 iteration, 8-box corridor prune, default
     playground plant) for STEPS control steps, K2's launches likewise;
 10. the SEPMC closed loop through bin/run_mpc --task=sepmc (population 2048
     per robot, H 50, 1 iteration, 1 best-response round, default V4 arena
     and ChaseTagConfig plant) for CHASE_STEPS control steps, K3's launches
     checked against solves x rounds x 2 robots and K4's against that x
     iterations;
 10b. the EPMC closed loop of 9 on the hard-contact plant
     (PlaygroundConfig(hard_contact=True)): K2's launches = STEPS, K5's =
     STEPS x 10 substeps; the plant's time per control step;
 10c. the MPPI->iLQR hybrid closed loops through bin/run_mpc --hybrid: PMC at
     bench.py bench_hybrid's width (population 1024, H 50, default plant,
     n_refine 7 so S = 8, 2 iLQR iterations) for HYB_STEPS control steps, K1's
     launches = solves and K6's = solves x iterations, the refined cost <=
     the best seed's + 1e-5 at every step; EPMC and SEPMC at H
     HYB_TASK_HORIZON for HYB_TASK_STEPS steps with 1 iteration (K2 / K3 /
     K4 / K6 launches checked);
 10d. K6 vs its plain version on the PMC hybrid loop's own first
     linearization (captured from its first solve): float32 at 8c's gate
     where it holds, else at twice the plain sweep's own float32-to-float64
     distance plus 2e-5 (both printed); float64 at 1e-9 of each block's
     scale;
 11. timings at the headline solve shapes (float32, mass_freeze 10; the
     chase kernels at substeps 10 on the 4-wall arena as bench.py's
     bench_sepmc): each kernel, its plain version and its bound on this
     card, K3 at S = 1 and S = 16; then each kernel at the closed loops'
     setting (mass_freeze 1; the chase kernels at substeps 20), K1-K4 at
     both settings beside their chain floor (the dependency depth of a
     control step x H x 4 cycles at the card's maximum SM clock); K5 (device
     time from torch.profiler, and the wrapper call) at bench.py
     bench_impulse's shape (B 256 standing robots, 60 rows, 10 iterations)
     and for one robot on the 129-row hurdle system, beside its chain floor
     (the dependency depth of a sweep x iterations x 4 cycles at the card's
     maximum SM clock), the kernels one wrapper call runs on the plant's
     tensors (only K5: a copy kernel fails the run), and the whole
     hard-contact control step at bench_impulse's shape; K6 (device time
     from torch.profiler, the wrapper call, the plain sweep, the bound, the
     chain floor: the depth of a step x H x 4 cycles) at the hybrid's S 8 /
     H 50 in float32 and float64 and at S 1; where one hybrid PMC solve's
     time goes (MPPI stage, seed rollout, linearize, sweeps, line search);
then one JSON line listing the six kernels, the nvidia-smi line, and last
the result line {"ok": true, "device": {...}}. Needs one card; builds the
kernels from the sources in lifelike_tpu_torch/csrc/ with nvcc. Exits
non-zero without a result when no card (or no lifelike_tpu_torch beside
this file) is present.

  python3 chip_smoke.py --timing [--root DIR] [--only Kn ...] [--group Kn=G ...]
                                [--loop TASK ...]

runs only phase 11's kernel timing (K1, K2 and K4 at the headline and
closed-loop settings, K3 at S = 1 and 16; K5 at bench_impulse's shape and
for one robot on 129 rows, device time beside the wrapper call; K6 at S 8
/ H 50 for float32 and float64 I/O and at S 1; plain versions, bounds,
chain floors) of the checkout DIR (default: this one), importing DIR's
chip_smoke.py and lifelike_tpu_torch, so an older commit unpacked with
`git archive` into a directory that .gitignore lists is timed by its own
code; two commits are compared by one such run per checkout in one command
on one card, in turns (parent, change, change, parent). --only Kn (n 1 to
6, repeatable) times those kernels alone (default: all six). --group Kn=G
builds that kernel with its lane group kGroup set to G (K1-K4: 4 or 8; K5:
8, 16 or 32 lanes per robot) in a copy of DIR's csrc/ with that constant
rewritten, built under its own hash. --loop TASK (pmc, epmc or sepmc) adds
that closed loop of phases 8-10 and its solve latency. Ends with one JSON
line of the times.
"""
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time

STEPS = 20  # closed-loop control steps of the PMC and EPMC tasks
CHASE_STEPS = 20  # closed-loop control steps of the SEPMC task
POP, HORIZON, SUBSTEPS = 4096, 50, 10  # headline solve shape (bench.py bench_pmc)
CONTACT_K = 8  # boxes per EPMC solve (solver/mpc_tasks.py CONTACT_K)
CHASE_POP = 2048  # candidates per robot (bench.py bench_sepmc: pop // 2)
CHASE_SUBSTEPS = 20  # the chase plant (envs/chase_tag.py ChaseTagConfig)
SWEEP_S = 16  # scenarios of bench.py's bench_sweep
# Scalar operations per candidate (K3: per plan) per control step, printed
# by tools/kernel_op_counts.py (the arithmetic primitives of one
# lifelike_tpu.ops.scalar_phys.control_step traced at (1, 1) tiles, with
# boxes of shape (K, 1, 1), plus the stage cost of ops/traversal_pallas.py).
# Headline (substeps 10, mass_freeze 10): K1 the plane-contact step; K2 8
# boxes (155,546) + the traversal stage cost (312); K3 the 4-wall arena
# (105,146); K4 the same + the chase stage cost (235). At the chase plant
# (substeps 20, mass_freeze 1): K3 297,160, K4 297,395.
OPS_PER_LANE_STEP = {"K1": 52286, "K2": 155546 + 312, "K3": 105146, "K4": 105146 + 235}
OPS_PER_LANE_STEP_CHASE_PLANT = {"K3": 297160, "K4": 297160 + 235}
# K5: operations of one PGS sweep (one iteration) of one element, printed
# by tools/kernel_op_counts.py (the arithmetic of
# lifelike_tpu.physics.impulse._pgs, a length-18 dot as 35 operations).
OPS_PER_SWEEP = {60: 4728, 129: 10248}
# ... and the dependency depth of that sweep (tools/kernel_op_counts.py: its
# rows' updates in order, a dot one level): the chain floor of K5 is depth x
# iterations x CHAIN_CYCLES cycles
SWEEP_DEPTH = {60: 540, 129: 1161}
IMPULSE_B, IMPULSE_SUBSTEPS = 256, 10  # bench.py bench_impulse's shape
# K6: the MPPI->iLQR hybrid at bench.py bench_hybrid's width (population
# pop // 4 = 1024, H 50, n_refine 7: S = 8 scenarios) with run_mpc's default
# 2 iLQR iterations; its PMC loop runs HYB_STEPS control steps, the EPMC and
# SEPMC hybrid loops HYB_TASK_STEPS at horizon HYB_TASK_HORIZON, 1 iteration.
HYB_POP, HYB_REFINE, HYB_ITERS, HYB_STEPS = 1024, 7, 2, 3
HYB_TASK_HORIZON, HYB_TASK_STEPS = 10, 2
RICCATI_N, RICCATI_M, RICCATI_S = 37, 12, HYB_REFINE + 1
# operations and float32 bytes of one Riccati step of one scenario, printed
# by tools/kernel_op_counts.py (the Pallas kernel's _backward_step traced at
# n 37, m 12: a length-K dot as K multiplies and K - 1 adds; the six input
# blocks read once, the two gains written once)
RICCATI_OPS_PER_STEP, RICCATI_BYTES_PER_STEP = 383995, 15324
# ... and the dependency depth of one step (a dot one level, the 12
# Gauss-Jordan rounds among it): K6's chain floor is depth x H x CHAIN_CYCLES
RICCATI_DEPTH_PER_STEP = 75
# Dependency depth of one control step, printed by tools/kernel_op_counts.py
# (physics_depth: the longest chain of dependent arithmetic primitives of
# the traced control_step, the box axis once), keyed by (kernel, substeps,
# mass_freeze): K1 plane contact, K2 8 boxes, K3 / K4 the 4-wall arena. A
# rollout of H strictly sequential control steps takes at least depth x H x
# CHAIN_CYCLES cycles.
CHAIN_DEPTH = {("K1", 10, 10): 1228, ("K1", 10, 1): 1390, ("K2", 10, 10): 1410,
               ("K2", 10, 1): 1410, ("K3", 10, 10): 1410, ("K3", 20, 1): 2820,
               ("K4", 10, 10): 1410, ("K4", 20, 1): 2820}
CHAIN_CYCLES = 4  # latency of a dependent FP32 / FP64 operation on the H100
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_FP64_FLOPS = 34e12  # H100 SXM, FP64 outside the tensor cores (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNELS = {
    "K1": dict(name="rollout_tracking_fused (K1, eight lanes per candidate, K0 inlined)",
               source="lifelike_tpu_torch/csrc/rollout_tracking.cu",
               replaces="lifelike_tpu/ops/rollout_pallas.py:202"),
    "K2": dict(name="rollout_traversal_fused (K2, eight lanes per candidate, K0 and box contact "
                    "inlined)",
               source="lifelike_tpu_torch/csrc/rollout_traversal.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:626"),
    "K3": dict(name="rollout_plan_fused (K3, eight lanes per plan, K0 and box contact inlined)",
               source="lifelike_tpu_torch/csrc/rollout_plan.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:287"),
    "K4": dict(name="rollout_chase_fused (K4, four lanes per candidate, K0 and box contact "
                    "inlined)",
               source="lifelike_tpu_torch/csrc/rollout_chase.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:486"),
    "K5": dict(name="pgs_sweep (K5, the hard-contact plant's PGS sweep, a lane group per robot, "
                    "rows in shared memory)",
               source="lifelike_tpu_torch/csrc/pgs_sweep.cu",
               replaces="lifelike_tpu/ops/pgs_pallas.py:65"),
    "K6": dict(name="riccati_sweep (K6, the iLQR Riccati backward sweep, FP64 tensor-core tiles, "
                    "a one-warp solve)",
               source="lifelike_tpu_torch/csrc/riccati_sweep.cu",
               replaces="lifelike_tpu/solver/riccati_pallas.py:92"),
}


def say(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def chain_floor(kernel, substeps, mass_freeze, kernel_ms, label=None):
    """Print and return the chain floor (ms) of one of K1-K4 at one setting."""
    depth, mhz = CHAIN_DEPTH[(kernel, substeps, mass_freeze)], sm_clock_mhz()
    floor_ms = depth * HORIZON * CHAIN_CYCLES / (mhz * 1e3)
    say(f"chain floor {label or kernel} substeps {substeps} mass_freeze {mass_freeze}: {depth} "
        f"levels x H "
        f"{HORIZON} x {CHAIN_CYCLES} cycles / {mhz:g} MHz = {floor_ms:.4f} ms | kernel "
        f"{kernel_ms:.4f} ms, {kernel_ms / floor_ms:.2f}x the floor")
    return floor_ms


def group_geometry(key, attrs):
    """A rollout kernel's launch at its solve's widths (K1, K2: POP
    candidates; K3: S 1 and SWEEP_S plans; K4: CHASE_POP candidates): lanes
    per candidate / plan, blocks, warps and SMs used, beside the warps an SM
    can hold."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = attrs["blocks_per_sm"] * attrs["block"] // 32
    parts = []
    for n in {"K1": (POP,), "K2": (POP,), "K3": (1, SWEEP_S), "K4": (CHASE_POP,)}[key]:
        blocks = -(-n // attrs["per_block"])
        warps = blocks * attrs["block"] // 32
        parts.append(f"at {n}: {blocks} blocks = {warps} warps on {min(blocks, sms)} of "
                     f"{sms} SMs, {warps / sms:.2f} warps/SM of {resident} resident")
    what = "plan" if key == "K3" else "candidate"
    return (f"{attrs['group']} lanes per {what}, {attrs['per_block']} {what}s per "
            f"{attrs['block']}-thread block | " + "; ".join(parts))


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


def report_diff(label, got, want, tol, shifted=None):
    """Max |kernel - plain| and the count outside rtol = atol = tol; exits
    on a non-finite cost or a disagreement.

    shifted: the plain version's costs from a start state shifted by 1e-10 m.
    Candidates whose plain cost itself moves beyond the tolerance under that
    shift (ill-conditioned: contact chaos amplifies the shift, and rounding
    differences alike) are reported and not gated."""
    import torch

    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise SystemExit(f"{label}: non-finite costs")
    err = (got - want).abs()
    limit = tol + tol * want.abs()
    gated = torch.ones_like(err, dtype=torch.bool)
    note = ""
    if shifted is not None:
        moved = (shifted - want).abs()
        gated = moved <= limit
        n_ill = int((~gated).sum())
        note = (f" | {n_ill} ill-conditioned (plain moves > tol under a 1e-10 m start shift; "
                f"max plain shift {float(moved.max()):.3e}"
                + (f", max|kernel-plain| over them {float(err[~gated].max()):.3e})" if n_ill
                   else ")"))
    bad = int(((err > limit) & gated).sum())
    max_err = float(err[gated].max()) if bool(gated.any()) else 0.0
    say(f"{label}: max|kernel-plain| {max_err:.3e} over {int(gated.sum())} of {err.numel()} "
        f"(rtol=atol={tol:g}, {bad} outside){note} | values mean {float(want.mean()):.6f} min "
        f"{float(want.min()):.6f} max {float(want.max()):.6f}")
    if bad:
        raise SystemExit(f"{label}: kernel disagrees with its plain version")
    if not bool(gated.any()):
        raise SystemExit(f"{label}: every value is ill-conditioned; nothing was compared")
    return max_err


def compare(label, dtype, horizon, substeps, mass_freeze, tol, seed):
    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.solver import rollout_tl

    c, params, tl, u, ref = solve_inputs(dtype, horizon, substeps, mass_freeze, POP, seed,
                                         noise="ar1" if horizon > 3 else "normal")
    got = rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref)
    want, _ = rollout_tl.rollout_tracking(c, params, tl, u, ref)
    return report_diff(f"{label}: pop {POP} H {horizon} substeps {substeps} mass_freeze "
                       f"{mass_freeze} {str(dtype).replace('torch.', '')}", got, want, tol)


def traversal_inputs(dtype, horizon, substeps, mass_freeze, pop, seed, gait=True,
                     device="cuda"):
    """A hurdle course (playground element 1, a seeded generator) pruned to
    the CONTACT_K boxes nearest the robot, which stands with its front feet
    4 mm into the first hurdle's top; EPMC candidates (sigma 0.15, AR(1)
    beta 0.7) as deltas on the synthetic clip's joints (gait=True) or on
    the current joints (a constant reference); the course's target, speed
    1.5. Returns (c, params, tl, u, box table, ref, target, speed)."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.motion import motion_lib
    from lifelike_tpu_torch.ops import traversal_cuda
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics import engine
    from lifelike_tpu_torch.physics.dynamics import RobotState
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.scene import boxes, playground_gen
    from lifelike_tpu_torch.solver import mppi_tl, rollout_tl

    dev = torch.device(device)
    model = build_max_model()
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps,
                                  mass_freeze=mass_freeze)
    c = B.tl_constants(model, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scene = playground_gen.generate(gen, playground_gen.PlaygroundConfig(element_id=1), dtype)
    hurdle_x, top = float(scene.center[2, 0]), float(scene.center[2, 2] + scene.half[2, 2])
    rng = np.random.default_rng(seed)
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    stand = np.array([-0.0278, -0.7790, 1.6873, -0.0276, -0.7777, 1.6838,
                      -0.0278, -0.7334, 1.5669, -0.0276, -0.7319, 1.5632])
    # at base height 0.33 the front feet's centers sit 0.2356 m ahead of the
    # base and their bottoms 0.0095 m above the ground
    pos = [hurdle_x - 0.2356, 0.0, 0.33 + top - 0.004 - 0.0095]
    state = RobotState(
        base_pos=T([pos]), base_orn=T([[0.0, 0.0, 0.0, 1.0]]),
        base_lin_vel=T([[0.5, 0.0, 0.0]]), base_ang_vel=T(np.zeros((1, 3))),
        joint_pos=T(stand[None] + 0.02 * rng.standard_normal((1, 12))),
        joint_vel=T(np.zeros((1, 12))),
    )
    tl = B.tl_from_state(state)
    table = traversal_cuda.pack_boxes(boxes.nearest_boxes(scene, T(pos), CONTACT_K))
    if gait:
        clips = motion_lib.pack_clips(
            [motion_lib.make_synthetic_clip(int(120 * (horizon / 50.0 + 3)))],
            frame_step=1.0 / 120.0, device=dev)
        ref = rollout_tl.precompute_reference(model, clips, 0, T(0.2), horizon,
                                              params.dt * params.substeps)
    else:
        ref = traversal_cuda.constant_reference(state.joint_pos, horizon)
    eps = T(rng.standard_normal((horizon, 4, 3, pop // 128, 128)))
    u = 0.15 * mppi_tl._smooth_noise_tl(None, eps.shape, 0.7, dtype, dev, eps=eps)
    return c, params, tl, u.contiguous(), table, ref, scene.target_pos, 1.5


def compare_traversal(label, dtype, horizon, substeps, mass_freeze, tol, seed, reward_type,
                      gait_weight, crawl=False, conditioning=False):
    from lifelike_tpu_torch.costs.traversal import TraversalWeights
    from lifelike_tpu_torch.ops import traversal_cuda

    c, params, tl, u, table, ref, tp, spd = traversal_inputs(
        dtype, horizon, substeps, mass_freeze, POP, seed, gait=gait_weight != 0.0)
    w = (TraversalWeights(height_min=0.08, pose=0.0, crawl_gap=0.18, ceiling=0.3) if crawl
         else TraversalWeights())
    args = (c, params, tl, u, table, ref, tp, spd, reward_type, 1000, w, gait_weight)
    got = traversal_cuda.rollout_traversal_fused(*args)
    want = traversal_cuda.rollout_traversal_plain(*args)
    shifted = None
    if conditioning:
        x = tl.base_pos.new_tensor([1e-10, 0.0, 0.0]).reshape(3, 1, 1)
        shifted = traversal_cuda.rollout_traversal_plain(
            c, params, tl._replace(base_pos=tl.base_pos + x), *args[3:])
    # the same candidates without the boxes: box contact must change costs
    free = table.clone()
    free[:, 6] = 0.0
    moved = int((traversal_cuda.rollout_traversal_fused(
        c, params, tl, u, free, *args[5:]) != got).sum())
    return report_diff(
        f"{label}: pop {POP} H {horizon} substeps {substeps} mass_freeze {mass_freeze} "
        f"{str(dtype).replace('torch.', '')} K {table.shape[0]} {reward_type} gait {gait_weight}"
        f"{' crawl_gap' if crawl else ''} (box contact changes {moved} costs)", got, want, tol,
        shifted)


def compare_scenarios(tol):
    """Four scenario blocks of POP/4 candidates, each with its own box table,
    reference rows and target, against the plain version."""
    import torch

    from lifelike_tpu_torch.ops import rollout_cuda, traversal_cuda

    c, params, tl, u, table, ref, tp, spd = traversal_inputs(torch.float64, 3, 2, 1, POP, 7)
    rows = rollout_cuda.pack_reference(ref).to(torch.float64)
    shift = torch.arange(4, dtype=torch.float64, device=u.device)
    tables = torch.stack([table] * 4)
    tables[:, :, 0] += 0.03 * shift[:, None]
    rows = torch.stack([rows * (1.0 + 0.01 * k) for k in range(4)])
    tps = tp[None] + shift[:, None]
    spds = 1.0 + 0.25 * shift
    args = (c, params, tl, u, tables, rows, tps, spds, "average_speed")
    got = traversal_cuda.rollout_traversal_fused(*args)
    want = traversal_cuda.rollout_traversal_plain(*args)
    return report_diff(f"check f64 S=4: pop {POP} H 3 substeps 2, 4 scenario blocks of "
                       f"{POP // 4}", got, want, tol)


def chase_arena(dtype, seed, device="cuda", contact=True):
    """A V4 arena from a seeded generator: with a hurdle and cubes (contact)
    or the default four walls. Returns (scene, box table, hurdle x, hurdle
    top, a y at which the robot's footprint beside the hurdle meets no
    cube); with cubes over every such spot, the next arena of the
    generator is drawn."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda
    from lifelike_tpu_torch.scene import arena_gen, boxes

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cfg = arena_gen.ArenaConfig(rand_cube=True, hurdle=True) if contact else arena_gen.ArenaConfig()
    gx, gy = torch.meshgrid(torch.linspace(-0.7, 0.3, 11), torch.linspace(-0.4, 0.4, 9),
                            indexing="ij")
    for _ in range(20):
        scene = arena_gen.generate(gen, cfg, dtype)
        table = traversal_cuda.pack_boxes(scene)
        if not contact:
            return scene, table, None, None, 0.0
        h = arena_gen.capacity(cfg) - 1  # the hurdle row
        hx, top = float(scene.center[h, 0]), float(scene.center[h, 2] + scene.half[h, 2])
        cubes = scene._replace(active=scene.active.clone())
        cubes.active[h] = False
        for y in torch.linspace(-1.8, 1.8, 37).tolist():
            pts = torch.stack([gx.reshape(-1) + hx, gy.reshape(-1) + y], -1)
            if float(boxes.heightmap_at(cubes, pts.to(device=device, dtype=dtype)).max()) == 0.0:
                return scene, table, hx, top, y
    raise SystemExit("chase arena: no cube-free spot beside the hurdle in 20 arenas")


def chase_state(dtype, hurdle_x, top, y, seed, n=1, device="cuda"):
    """n standing start states (TLState, batch (n, 1)) with the front feet 4
    mm into the hurdle's top at (hurdle_x, y) (at base height 0.33 the front
    feet sit 0.2356 m ahead of the base and 0.0095 m above the ground); the
    n states step back by 0.02 m each; with hurdle_x None, standing at x -1
    on the ground."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics.dynamics import RobotState

    rng = np.random.default_rng(seed)
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    stand = np.array([-0.0278, -0.7790, 1.6873, -0.0276, -0.7777, 1.6838,
                      -0.0278, -0.7334, 1.5669, -0.0276, -0.7319, 1.5632])
    if hurdle_x is None:
        pos = np.tile([-1.0, 0.0, 0.33], (n, 1))
    else:
        pos = np.tile([hurdle_x - 0.2356, y, 0.33 + top - 0.004 - 0.0095], (n, 1))
        pos[:, 0] -= 0.02 * np.arange(n)
    state = RobotState(
        base_pos=T(pos), base_orn=T(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))),
        base_lin_vel=T(np.tile([0.3, 0.0, 0.0], (n, 1))), base_ang_vel=T(np.zeros((n, 3))),
        joint_pos=T(stand[None] + 0.02 * rng.standard_normal((n, 12))),
        joint_vel=T(np.zeros((n, 12))),
    )
    return B.tl_from_state(state), state


def chase_reference(dtype, horizon, substeps, t0=0.2, device="cuda"):
    """The synthetic walk clip's packed reference rows (H, 64) from t0."""
    import torch

    from lifelike_tpu_torch.motion import motion_lib
    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.solver import rollout_tl

    dev = torch.device(device)
    clips = motion_lib.pack_clips(
        [motion_lib.make_synthetic_clip(int(120 * (horizon * substeps / 500.0 + 3)))],
        frame_step=1.0 / 120.0, device=dev)
    ref = rollout_tl.precompute_reference(build_max_model(), clips, 0,
                                          torch.tensor(t0, dtype=dtype, device=dev), horizon,
                                          0.002 * substeps)
    return rollout_cuda.pack_reference(ref).to(dtype)


def _plant(dtype, substeps, mass_freeze, device="cuda"):
    import torch

    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics import engine
    from lifelike_tpu_torch.robot.model import build_max_model

    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps,
                                  mass_freeze=mass_freeze)
    return B.tl_constants(build_max_model(), dtype=dtype, device=torch.device(device)), params


def _noise(shape, sigma, seed, dtype, device="cuda"):
    """sigma x AR(1)-smoothed (beta 0.7) normals along the horizon axis 0."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.solver import mppi_tl

    eps = torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), dtype=dtype,
                          device=device)
    return (sigma * mppi_tl._smooth_noise_tl(None, eps.shape, 0.7, dtype, eps.device, eps=eps)
            ).contiguous()


def compare_plan(label, dtype, horizon, substeps, mass_freeze, tol, seed, n_scen,
                 conditioning=False):
    """K3 vs rollout_plan_plain: one plan (S = 1) or S plans with their own
    start states, box tables (shifted along x) and reference rows (the clip
    from its own time); plans are 0.05 AR(1) deltas on the clip's joints."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda

    c, params = _plant(dtype, substeps, mass_freeze)
    _, table, hx, top, y = chase_arena(dtype, seed)
    tl, _ = chase_state(dtype, hx, top, y, seed, n_scen)
    if n_scen == 1:
        tables = table
        rows = chase_reference(dtype, horizon, substeps)
        plan = _noise((horizon, 4, 3), 0.05, seed, dtype)
    else:
        tables = torch.stack([table] * n_scen)
        tables[:, :, 0] += 0.01 * torch.arange(n_scen, dtype=dtype, device=table.device)[:, None]
        rows = torch.stack([chase_reference(dtype, horizon, substeps, 0.2 + 0.05 * k)
                            for k in range(n_scen)])
        plan = _noise((horizon, n_scen, 4, 3), 0.05, seed, dtype).permute(1, 0, 2, 3).contiguous()
    got = traversal_cuda.rollout_plan_fused(c, params, tl, plan, tables, rows)
    want = traversal_cuda.rollout_plan_plain(c, params, tl, plan, tables, rows)
    shifted = None
    if conditioning:
        x = tl.base_pos.new_tensor([1e-10, 0.0, 0.0]).reshape(3, 1, 1)
        shifted = traversal_cuda.rollout_plan_plain(
            c, params, tl._replace(base_pos=tl.base_pos + x), plan, tables, rows)
    free = tables.clone()
    free[..., 6] = 0.0
    moved = int((traversal_cuda.rollout_plan_fused(c, params, tl, plan, free, rows) != got)
                .sum())
    return report_diff(
        f"{label}: S {n_scen} H {horizon} substeps {substeps} mass_freeze {mass_freeze} "
        f"{str(dtype).replace('torch.', '')} K {table.shape[0]} base trajectory (H, 3, S) "
        f"(box contact changes {moved} of {got.numel()} positions)", got, want, tol, shifted)


def chase_kernel_inputs(dtype, horizon, substeps, mass_freeze, pop, seed, gait, contact=True):
    """One robot's chase candidates (sigma 0.15 AR(1) deltas) from its start
    state beside the hurdle (contact) or at x -1 on the 4-wall arena, on the
    synthetic clip's joints (gait) or on its current joints (a constant
    reference); the opponent walks from (1.0, 0.2) to (1.5, 0.0), the flag
    stands at (2.0, -1.0). Returns (c, params, tl, u, table, rows, opp, flag)."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda

    c, params = _plant(dtype, substeps, mass_freeze)
    _, table, hx, top, y = chase_arena(dtype, seed, contact=contact)
    tl, state = chase_state(dtype, hx, top, y, seed)
    rows = (chase_reference(dtype, horizon, substeps) if gait
            else traversal_cuda.constant_reference(state.joint_pos[0], horizon))
    u = _noise((horizon, 4, 3, pop // 128, 128), 0.15, seed, dtype)
    s = torch.linspace(0.0, 1.0, horizon, dtype=dtype, device=u.device)
    opp = torch.stack([1.0 + 0.5 * s, 0.2 - 0.2 * s, torch.full_like(s, 0.3)], -1)[..., None, None]
    flag = torch.tensor([2.0, -1.0, 0.3], dtype=dtype, device=u.device)
    return c, params, tl, u, table, rows, opp, flag


def compare_chase(label, dtype, horizon, substeps, mass_freeze, tol, seed, chaser, gait_weight,
                  conditioning=False):
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda

    c, params, tl, u, table, rows, opp, flag = chase_kernel_inputs(
        dtype, horizon, substeps, mass_freeze, CHASE_POP, seed, gait=gait_weight != 0.0)
    role = torch.tensor(chaser, device=u.device)
    args = (c, params, tl, u, table, rows, opp, flag, role)
    got = traversal_cuda.rollout_chase_fused(*args, gait_weight=gait_weight)
    want = traversal_cuda.rollout_chase_plain(*args, gait_weight=gait_weight)
    shifted = None
    if conditioning:
        x = tl.base_pos.new_tensor([1e-10, 0.0, 0.0]).reshape(3, 1, 1)
        shifted = traversal_cuda.rollout_chase_plain(
            c, params, tl._replace(base_pos=tl.base_pos + x), *args[3:], gait_weight=gait_weight)
    free = table.clone()
    free[:, 6] = 0.0
    moved = int((traversal_cuda.rollout_chase_fused(c, params, tl, u, free, *args[5:],
                                                    gait_weight=gait_weight) != got).sum())
    return report_diff(
        f"{label}: pop {CHASE_POP} H {horizon} substeps {substeps} mass_freeze {mass_freeze} "
        f"{str(dtype).replace('torch.', '')} K {table.shape[0]} "
        f"{'chaser' if chaser else 'escapee'} gait {gait_weight} (box contact changes {moved} "
        f"costs)", got, want, tol, shifted)


def compare_chase_scenarios(tol):
    """Four scenario blocks of CHASE_POP/4 candidates, each with its own box
    table, reference rows, opponent trajectory, flag and role, against the
    plain version."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda

    c, params, tl, u, table, rows, opp, flag = chase_kernel_inputs(
        torch.float64, 3, 2, 1, CHASE_POP, 21, gait=True)
    shift = torch.arange(4, dtype=torch.float64, device=u.device)
    tables = torch.stack([table] * 4)
    tables[:, :, 0] += 0.03 * shift[:, None]
    rows = torch.stack([rows * (1.0 + 0.01 * k) for k in range(4)])
    opps = torch.stack([opp.reshape(3, 3) + 0.1 * k for k in range(4)])  # (S, H, 3)
    flags = flag[None] + shift[:, None]
    roles = torch.tensor([True, False, True, False], device=u.device)
    args = (c, params, tl, u, tables, rows, opps, flags, roles)
    got = traversal_cuda.rollout_chase_fused(*args, gait_weight=0.8)
    want = traversal_cuda.rollout_chase_plain(*args, gait_weight=0.8)
    return report_diff(f"check K4 f64 S=4: pop {CHASE_POP} H 3 substeps 2, 4 scenario blocks of "
                       f"{CHASE_POP // 4}", got, want, tol)


def pgs_random_system(dtype, device="cuda"):
    """The reference Pallas test's random system (tests/test_impulse_contact.py
    test_pallas_pgs_matches_xla_sweep: seed 0, B 128, 60 rows, SPD M^-1,
    30 % of the rows inactive, scalar mu 0.5, 4 iterations)."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.physics import impulse

    rng = np.random.default_rng(0)
    n, R, NV = 128, impulse.N_ROWS, impulse.NV
    A = rng.normal(size=(NV, NV)) * 0.3
    Minv = A @ A.T + np.eye(NV)
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    J = T(rng.normal(size=(n, R, NV)) * 0.5)
    MinvJT = J @ T(Minv)
    d = (J * MinvJT).sum(-1)
    v = T(rng.normal(size=(n, NV)))
    b = T(rng.normal(size=(n, R)) * 0.1)
    active = T(rng.uniform(size=(n, R)) > 0.3) > 0
    hi = torch.where(active, float("inf"), 0.0).to(dtype)
    return [v, torch.zeros_like(b), J, MinvJT, d, b, torch.zeros_like(b), hi, 0.5], \
        impulse.friction_map(False, device).mu_idx, 4


def impulse_state(name, dtype, batch=None, seed=0, device="cuda"):
    """A golden trace's start state (and scene, targets) for the impulse
    plant; with `batch`, that many copies, perturbed (1 mm base, 0.01 rad
    joints, 0.1 rad/s joint velocities) from a seeded generator."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.physics import oracle_traces

    tr = oracle_traces.load(name, dtype=dtype, device=device)
    if batch is None:
        return tr.init, tr.scene, tr.targets
    rng = np.random.default_rng(seed)
    T = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    s = type(tr.init)(*(x.expand((batch,) + tuple(x.shape)).clone() for x in tr.init))
    s = s._replace(base_pos=s.base_pos + T(1e-3 * rng.standard_normal((batch, 3))),
                   joint_pos=s.joint_pos + T(0.01 * rng.standard_normal((batch, 12))),
                   joint_vel=s.joint_vel + T(0.1 * rng.standard_normal((batch, 12))))
    return s, tr.scene, tr.targets


def pgs_systems(dtype, seed=0):
    """(label, sweep arguments, mu_idx, iterations, batch) of phase 8a: the
    random system; the walking substep of test_pallas_pgs_full_substep_parity
    (the walk trace's start x 128, zero warm start, its first target, 3
    iterations); the 129-row hurdle system (the hurdle trace's start, box
    rows active) with a per-element mu at B 256 and for one robot (10
    iterations, warm-started by one control step)."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.physics import impulse
    from lifelike_tpu_torch.robot.model import build_max_model

    model = build_max_model()
    args, idx, iters = pgs_random_system(dtype)
    out = [("random SPD system B 128 rows 60", args, idx, iters, 128)]
    walk, _, tgt = impulse_state("walk", dtype)
    walk = type(walk)(*(x.expand((128,) + tuple(x.shape)) for x in walk))
    p = impulse.ImpulseParams(iterations=3, substeps=1)
    *system, idx = impulse.sweep_system(
        model, p, walk, impulse.init_lam((128,), dtype, device="cuda"), tgt[0])
    out.append(("walking substep B 128 rows 60", system + [p.mu], idx, 3, 128))
    rng = np.random.default_rng(seed)
    for n in (256, None):
        s, scene, tgt = impulse_state("hurdle", dtype, n, seed)
        batch = (n,) if n else ()
        mu = torch.as_tensor(rng.uniform(0.4, 3.0, batch), dtype=dtype, device="cuda")
        p = impulse.ImpulseParams(mu=mu)
        lam = impulse.init_lam(batch, dtype, scene=scene, device="cuda")
        s, lam = impulse.control_step(model, p, s, lam, tgt[0], scene=scene)
        *system, idx = impulse.sweep_system(model, p, s, lam, tgt[1], scene=scene)
        n_box = int(torch.isinf(system[7][..., 24:93:3]).sum())
        out.append((f"hurdle system B {n or 1} rows 129, per-element mu, {n_box} box contacts "
                    "active", system + [mu], idx, 10, n or 1))
    return out


def batch_variants(label, args, batch):
    """A sweep system (arguments as pgs_sweep's) cut to batches that K5's
    one-warp blocks do not divide (B 5; B 257, robot i of the new batch
    being robot i mod B), to two leading batch axes ((2, 3)) and with a
    non-contiguous J (the same values): (label, arguments, batch) each."""
    import torch

    def cut(f):
        return [f(x) if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == batch else x
                for x in args]

    noncontig = list(args)
    noncontig[2] = args[2].transpose(-1, -2).contiguous().transpose(-1, -2)
    return [(f"{label}, cut to B 5", cut(lambda x: x[:5]), 5),
            (f"{label}, cut to B 257",
             cut(lambda x: x[torch.arange(257, device=x.device) % batch]), 257),
            (f"{label}, cut to batch (2, 3)",
             cut(lambda x: x[:6].reshape((2, 3) + tuple(x.shape[1:]))), 6),
            (f"{label}, non-contiguous J", noncontig, batch)]


def check_pgs_system(dtype, tol, label, args, idx, iters, batch):
    """K5 vs pgs_sweep_plain on one system (see compare_pgs); returns the
    largest |kernel - plain| over v and lam."""
    import torch

    from lifelike_tpu_torch.ops import pgs_cuda

    got = pgs_cuda.pgs_sweep(*args, idx, iterations=iters)
    want = pgs_cuda.pgs_sweep_plain(*args, idx, iterations=iters)
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(x).all()) for x in got + want)
    shapes = all(g.shape == w.shape for g, w in zip(got, want))
    note, ok = "", max(errs) <= tol
    if dtype == torch.float32 and "hurdle" in label:
        exact = pgs_cuda.pgs_sweep_plain(
            *(x.double() if torch.is_tensor(x) else x for x in args), idx, iterations=iters)
        floor = max(float((w.double() - e).abs().max()) for w, e in zip(want, exact))
        k_err = max(float((g.double() - e).abs().max()) for g, e in zip(got, exact))
        note = f" | vs the float64 sweep: kernel {k_err:.3e}, plain {floor:.3e}"
        if batch > 1:
            ok = k_err <= 2.0 * floor + tol
            note += f" (gate: kernel <= 2 x plain + {tol:g})"
    say(f"check K5 {str(dtype).replace('torch.', '')} {label}, {iters} iterations: "
        f"max|kernel-plain| v {errs[0]:.3e} lam {errs[1]:.3e} (tol {tol:g}){note} | "
        f"max|v| {float(want[0].abs().max()):.4f} max|lam| {float(want[1].abs().max()):.4f}")
    if not finite or not shapes:
        raise SystemExit(f"K5 {label}: non-finite output or wrong shape")
    if not ok:
        raise SystemExit(f"K5 {label}: kernel disagrees with its plain version")
    return max(errs)


def compare_pgs(dtype, tol):
    """Phase 8a: K5 vs pgs_sweep_plain on every system of pgs_systems, then
    on the random and the B 256 hurdle system's batch_variants; returns the
    largest |kernel - plain| over v and lam.

    Every system: |kernel - plain| <= tol, with one exception. On the
    float32 hurdle system at B 256 (1024 box contacts, 10 sweeps of 129
    rows) the plain version itself moves by far more than 1e-5 when its
    rounding changes, so there (and on its cuts of more than one robot) the
    kernel is held to that rounding floor: its distance from the float64
    sweep of the same inputs may be at most twice the plain version's, plus
    tol. The one-robot hurdle system, the shape the hard-contact closed loop
    launches, keeps the plain gate; its plain version's distance from
    float64 is printed beside it."""
    worst, cut = 0.0, []
    for label, args, idx, iters, batch in pgs_systems(dtype):
        worst = max(worst, check_pgs_system(dtype, tol, label, args, idx, iters, batch))
        if batch > 1 and "walking" not in label:
            cut += [(v, idx, iters) for v in batch_variants(label, args, batch)]
    for (label, args, batch), idx, iters in cut:
        worst = max(worst, check_pgs_system(dtype, tol, label, args, idx, iters, batch))
    return worst


TRACE_F32_LIMITS = {"walk": 1e-2, "run": 1e-2, "stand": 2e-2, "hurdle": 6e-3}
TRACE_MEMBERS = 64  # float32: starts per trace (the trace's own + perturbed)


def trace_errors(dtype, members=1, noise=1e-6, seed=0):
    """Phase 8b: the port's impulse.control_step (K5 on the card) over the
    golden traces' H 50 control steps, walk, run and stand batched with
    their own targets, hurdle with its scene. members > 1: each trace from
    its own start (member 0) and members - 1 starts whose joint positions
    are moved by `noise` rad N(0, 1) draws (oracle_traces.start_shifts, the
    starts tools/trace_f32_spread.py steps through the JAX reference).
    Returns {name: max |joint_pos - trace| per step and member, (H,
    members)} as numpy."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.physics import impulse, oracle_traces
    from lifelike_tpu_torch.robot.model import build_max_model

    model = build_max_model()
    p = impulse.ImpulseParams()
    shifts = oracle_traces.start_shifts(members, noise, seed)
    out = {}
    for names in oracle_traces.GROUPS:
        trs = [oracle_traces.load(n, dtype=dtype, device="cuda") for n in names]
        s = type(trs[0].init)(*(torch.stack(x).repeat_interleave(members, 0)
                                for x in zip(*(t.init for t in trs))))
        shift = np.concatenate([shifts[n] for n in names])
        s = s._replace(joint_pos=(s.joint_pos.double() + torch.as_tensor(
            shift, device="cuda")).to(dtype))
        targets = torch.stack([t.targets for t in trs], dim=1).repeat_interleave(members, 1)
        want = np.stack([t.joint_pos for t in trs], axis=1).repeat(members, 1)
        scene = trs[0].scene
        lam = impulse.init_lam(s.base_pos.shape[:-1], dtype, scene=scene, device="cuda")
        errs = []
        for t in range(targets.shape[0]):
            s, lam = impulse.control_step(model, p, s, lam, targets[t], scene=scene)
            errs.append(np.abs(s.joint_pos.double().cpu().numpy() - want[t]).max(-1))
        errs = np.stack(errs).reshape(-1, len(names), members)
        out.update({n: errs[:, k] for k, n in enumerate(names)})
    return out


def check_traces():
    """Phase 8b's criteria. float64, each trace from its own start: max
    error < 1e-5 over H 50. float32, TRACE_MEMBERS starts per trace: the
    trace's own start within 1e-5 after the first step, and the median over
    the starts of the H 50 max error under the JAX tests' ceiling. (Over 50
    steps float32 rounding is amplified chaotically through contact: starts
    1e-6 rad apart end up 2e-3 to 2e-2 rad from the walk trace, so one run's
    error is one draw from that spread; its own value is printed. The JAX
    reference spreads alike from the same starts: tools/trace_f32_spread.py
    measures it on the CPU, e.g. walk median 8.786e-03 with 12 of 64 starts
    at or over its 1e-2 ceiling.)"""
    import numpy as np
    import torch

    for dtype, members in ((torch.float64, 1), (torch.float32, TRACE_MEMBERS)):
        name = str(dtype).replace("torch.", "")
        for trace, e in trace_errors(dtype, members).items():
            own, peak = e[:, 0], e.max(0)
            med = float(np.median(peak))
            limit = 1e-5 if members == 1 else TRACE_F32_LIMITS[trace]
            line = (f"trace {trace} {name} H {len(own)}: max|dq| at steps 1/10/25/50 "
                    f"{own[0]:.3e} {own[9]:.3e} {own[24]:.3e} {own[49]:.3e} | max {own.max():.3e}")
            if members > 1:
                q = np.quantile(peak, [0.0, 0.25, 0.5, 0.75, 1.0])
                line += (f" | {members} starts (1e-6 rad apart): H 50 max quantiles 0/25/50/75/100 "
                         + " ".join(f"{x:.3e}" for x in q)
                         + f", {int((peak >= limit).sum())} at or over {limit:g} | gate: median "
                         f"< {limit:g}, first step < 1e-05")
                ok = med < limit and own[0] < 1e-5
            else:
                line += f" (limit {limit:g})"
                ok = own.max() < limit
            say(line)
            if not np.isfinite(e).all() or not ok:
                raise SystemExit(f"trace {trace} {name}: the plant misses the criterion")


def device_ms(fn, kernel_name, reps=20):
    """Device time per launch of the kernels whose name holds `kernel_name`
    (torch.profiler's CUDA activity), fn called `reps` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # the profiler now and then drops most of a run's events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel_name in e.key]
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                 for e in events)
        count = sum(e.count for e in events)
        if count >= reps // 2:
            break
    if us <= 0.0 or count == 0:
        raise SystemExit(f"torch.profiler recorded no device time for {kernel_name}")
    return us / 1e3 / count


def call_kernels(fn, reps=5):
    """{name: count per call} of the device kernels and copies that calls of
    fn run (torch.profiler's CUDA activity over `reps` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / reps for e in prof.key_averages()
            if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) > 0.0}


def time_pgs():
    """Phase 11 for K5: the kernel, its plain version and its bound at
    bench.py bench_impulse's shape (B 256 standing robots, 60 rows, 10
    iterations, float32, the system of a warm-started substep) and for one
    robot on the 129-row hurdle system; then the whole hard-contact control
    step at bench_impulse's shape and K5's share of it. Returns the K5 row
    of the kernels line."""
    import torch

    from lifelike_tpu_torch.ops import pgs_cuda
    from lifelike_tpu_torch.physics import impulse
    from lifelike_tpu_torch.physics.dynamics import RobotState
    from lifelike_tpu_torch.robot.model import build_max_model

    dtype, n = torch.float32, IMPULSE_B
    model = build_max_model()
    T = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")
    stand = T([-0.028, -0.779, 1.687] * 4)
    s = RobotState(base_pos=T([0.0, 0.0, 0.33]).expand(n, 3),
                   base_orn=T([0.0, 0.0, 0.0, 1.0]).expand(n, 4),
                   base_lin_vel=T([0.0] * 3).expand(n, 3), base_ang_vel=T([0.0] * 3).expand(n, 3),
                   joint_pos=stand.expand(n, 12), joint_vel=T([0.0] * 12).expand(n, 12))
    p = impulse.ImpulseParams(substeps=IMPULSE_SUBSTEPS)
    lam = impulse.init_lam((n,), dtype, device="cuda")
    s1, lam1 = impulse.control_step(model, p, s, lam, stand)
    hurdle, scene, tgt = impulse_state("hurdle", dtype)
    lam_h = impulse.init_lam((), dtype, scene=scene, device="cuda")
    cases = [(f"B {n} rows 60 (bench_impulse, standing)",
              impulse.sweep_system(model, p, s1, lam1, stand), n),
             ("B 1 rows 129 (the hurdle trace's start)",
              impulse.sweep_system(model, p, hurdle, lam_h, tgt[0], scene=scene), 1)]
    rows = {}
    for label, (*system, idx), lanes in cases:
        r, it = len(idx), p.iterations
        call = lambda: pgs_cuda.pgs_sweep(*system, p.mu, idx, iterations=it)
        wrapper_ms = cuda_ms(call, reps=20, warmup=3)
        kernel_ms = device_ms(call, "pgs_sweep_kernel")
        plain_ms = cuda_ms(lambda: pgs_cuda.pgs_sweep_plain(*system, p.mu, idx, iterations=it),
                           reps=1, warmup=1)
        ran = call_kernels(call)
        if [k for k in ran if "pgs_sweep_kernel" not in k] or not ran:
            raise SystemExit(f"K5 wrapper: a call on the plant's tensors ran {ran} per call")
        floor_ms = SWEEP_DEPTH[r] * it * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
        ops = OPS_PER_SWEEP[r] * it * lanes
        # each input read once, each output written once: v, lam0, J, MinvJT,
        # d, b, lo, hi, mu; mu_idx (int32); v and lam out
        nbytes = 4 * lanes * (2 * (18 + r) + 2 * r * 18 + 4 * r + 1) + 4 * r
        bound_ms, by, ops_ms, bytes_ms = bound(ops, nbytes)
        say(f"timing K5 f32 {label}, {it} iterations: kernel {kernel_ms:.4f} ms (device time, "
            f"torch.profiler) | wrapper call {wrapper_ms:.4f} ms (CUDA events) | plain "
            f"{plain_ms:.1f} ms | bound {bound_ms:.6f} ms ({ops:.4e} ops / 67 TFLOP/s = "
            f"{ops_ms:.6f} ms; {nbytes} B / 3.35 TB/s = {bytes_ms:.6f} ms, bound by {by}) | "
            f"kernel at {100 * bound_ms / kernel_ms:.4f}% of bound | chain floor "
            f"{SWEEP_DEPTH[r]} levels x {it} iterations x {CHAIN_CYCLES} cycles = {floor_ms:.4f} ms, "
            f"kernel {kernel_ms / floor_ms:.2f}x | library: none")
        say(f"timing K5 wrapper call, {label}: device work per call {ran} (no copy kernel)")
        rows[lanes] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None)
    step_ms = cuda_ms(lambda: impulse.control_step(model, p, s, lam, stand), reps=5, warmup=1)
    share = IMPULSE_SUBSTEPS * rows[n]["ms"] / step_ms
    say(f"timing hard-contact control step f32 B {n} substeps {IMPULSE_SUBSTEPS} (bench_impulse, "
        f"standing): {step_ms:.3f} ms per control step (CUDA events) | K5 device time "
        f"{IMPULSE_SUBSTEPS} x {rows[n]['ms']:.4f} ms = {100 * share:.1f}% of it")
    return rows[n]


def riccati_system(S, H, dtype, seed, stiff=False):
    """An LQR system shaped as the reference test's _rand_lqr
    (tests/test_riccati_pallas.py, tests/test_torch_riccati.py): A near
    identity, SPD cost Hessians; numpy from `seed`, on the card. stiff: B's
    columns scaled from 1e-3 to 10**2.8 and Cuu = 3e-3 I, so that B'VB
    reaches ~1e6 beside the damping, as in the hybrid loop's linearizations
    through contact."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, m = RICCATI_N, RICCATI_M
    A = 0.1 * rng.standard_normal((S, H, n, n)) + np.eye(n)
    Bm = 0.1 * rng.standard_normal((S, H, n, m))
    cx = rng.standard_normal((S, H, n))
    cu = rng.standard_normal((S, H, m))
    W = 0.1 * rng.standard_normal((S, H, n, n))
    Cxx = W @ np.swapaxes(W, -1, -2) + 0.1 * np.eye(n)
    V = 0.1 * rng.standard_normal((S, H, m, m))
    Cuu = V @ np.swapaxes(V, -1, -2) + 0.1 * np.eye(m)
    if stiff:
        Bm = Bm * np.logspace(-3.0, 2.8, m)
        Cuu = np.broadcast_to(3e-3 * np.eye(m), Cuu.shape).copy()
    return [torch.as_tensor(x, dtype=dtype, device="cuda") for x in (A, Bm, cx, cu, Cxx, Cuu)]


def gain_errors(got, want):
    """(max|dk| / max(max|k|, 1), max|dK| / max(max|K|, 1), max|dk|, max|dK|)
    of two (k, K) pairs, against the scale of `want`."""
    (k1, K1), (k2, K2) = got, want
    dk, dK = float((k1 - k2).abs().max()), float((K1 - K2).abs().max())
    sk, sK = max(float(k2.abs().max()), 1.0), max(float(K2.abs().max()), 1.0)
    return dk / sk, dK / sK, dk, dK


def compare_riccati(label, args, reg, tol):
    """K6 vs riccati_sweep_plain on `args` at the reference kernel test's
    gate: k within tol x max(|k|, 1), K within tol. Returns the largest
    absolute difference over k and K."""
    import torch

    from lifelike_tpu_torch.solver import riccati_cuda

    got = riccati_cuda.riccati_sweep(*args, reg=reg)
    want = riccati_cuda.riccati_sweep_plain(*args, reg=reg)
    torch.cuda.synchronize()
    rk, _, dk, dK = gain_errors(got, want)
    finite = all(bool(torch.isfinite(x).all()) for x in got + want)
    S, H = args[0].shape[:2]
    say(f"check K6 {str(args[0].dtype).replace('torch.', '')} {label} S {S} H {H} reg {reg:g}: "
        f"max|kernel-plain| k {dk:.3e} ({rk:.3e} of max(|k|, 1)) K {dK:.3e} (tol {tol:g}) | "
        f"max|k| {float(want[0].abs().max()):.4f} max|K| {float(want[1].abs().max()):.4f}")
    if not finite:
        raise SystemExit(f"K6 {label}: non-finite gains")
    if rk > tol or dK > tol:
        raise SystemExit(f"K6 {label}: kernel disagrees with its plain version")
    return max(dk, dK)


def compare_riccati_random():
    """Phase 8c: K6 vs its plain version on random systems at the loop's
    horizon, S 3 and S 8 (reg 1e-3 and 0), S 1, S 13 and at H 1: float32
    2e-5, float64 1e-9; then a stiff system at phase 10d's gates. Returns
    the float32 max |kernel - plain| of the random systems."""
    import torch

    worst = 0.0
    cases = [(3, HORIZON, 61, reg) for reg in (1e-3, 0.0)]
    cases += [(RICCATI_S, HORIZON, 62, reg) for reg in (1e-3, 0.0)]
    cases += [(1, HORIZON, 63, 1e-3), (13, HORIZON, 64, 1e-3), (3, 1, 65, 1e-3)]
    for S, H, seed, reg in cases:
        worst = max(worst, compare_riccati("random system", riccati_system(
            S, H, torch.float32, seed), reg, 2e-5))
        compare_riccati("random system", riccati_system(S, H, torch.float64, seed), reg, 1e-9)
    compare_riccati_loop(riccati_system(2, HORIZON, torch.float32, 66, stiff=True),
                         "stiff random system", "Cuu 3e-3 I, B columns 1e-3 .. 6e2 x 0.1")
    return worst


def compare_riccati_loop(args, label="loop linearization", source="PMC hybrid, first solve"):
    """Phase 10d: K6 vs its plain version on the hybrid PMC loop's own first
    linearization (the sweep's float32 inputs, LM damping folded into Cuu,
    captured from the loop's first solve); phase 8c's stiff system alike.
    Float32: the random systems' gate
    where it holds; where the plain sweep's own float32-to-float64 distance
    exceeds it (stiff contact makes Quu poorly conditioned, and Gauss-Jordan
    without pivoting and LU with pivoting round apart), the kernel's
    distance from the float64 sweep may be at most twice the plain's, plus
    2e-5. Float64: 1e-9 of each block's scale. Every number is printed."""
    import torch

    from lifelike_tpu_torch.solver import riccati_cuda

    tol = 2e-5
    a64 = [x.double() for x in args]
    k32 = riccati_cuda.riccati_sweep(*args, reg=0.0)
    p32 = riccati_cuda.riccati_sweep_plain(*args, reg=0.0)
    k64 = riccati_cuda.riccati_sweep(*a64, reg=0.0)
    p64 = riccati_cuda.riccati_sweep_plain(*a64, reg=0.0)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in k32 + p32 + k64 + p64):
        raise SystemExit(f"K6 {label}: non-finite gains")
    up = lambda g: tuple(x.double() for x in g)
    rk, rK, dk, dK = gain_errors(k32, p32)
    floor = gain_errors(up(p32), p64)
    kern = gain_errors(up(k32), p64)
    r64 = gain_errors(k64, p64)
    quu = args[5][:, :, range(RICCATI_M), range(RICCATI_M)]
    S, H = args[0].shape[:2]
    say(f"check K6 {label} S {S} H {H} ({source}; Cuu diagonal "
        f"{float(quu.min()):.3e} .. {float(quu.max()):.3e}, max|A| "
        f"{float(args[0].abs().max()):.3e}) | max|k|, max|K| {float(p64[0].abs().max()):.4e}, "
        f"{float(p64[1].abs().max()):.4e}")
    say(f"check K6 float32 {label}: |kernel-plain| k {dk:.3e} ({rk:.3e} of max(|k|, "
        f"1)) K {dK:.3e} ({rK:.3e}) | vs the float64 sweep (relative to scale): plain k "
        f"{floor[0]:.3e} K {floor[1]:.3e}, kernel k {kern[0]:.3e} K {kern[1]:.3e}")
    if rk <= tol and dK <= tol:
        gate = f"the random systems' gate ({tol:g})"
    elif max(floor[0], floor[1]) > tol and kern[0] <= 2 * floor[0] + tol \
            and kern[1] <= 2 * floor[1] + tol:
        gate = f"the plain sweep's rounding floor (kernel <= 2 x plain + {tol:g} vs float64)"
    else:
        raise SystemExit(f"K6 {label} float32: kernel disagrees with its plain version")
    say(f"check K6 float32 {label}: passes {gate}")
    say(f"check K6 float64 {label}: |kernel-plain| k {r64[2]:.3e} ({r64[0]:.3e} of "
        f"max(|k|, 1)) K {r64[3]:.3e} ({r64[1]:.3e} of max(|K|, 1)) (tol 1e-9 of scale)")
    if r64[0] > 1e-9 or r64[1] > 1e-9:
        raise SystemExit(f"K6 {label} float64: kernel disagrees with its plain version")


class SweepCapture:
    """Within the block, solver.ilqr reaches riccati_sweep through a stand-in
    for its `riccati_cuda` module whose hook keeps the first call's inputs
    (clones) and calls riccati_sweep unchanged: riccati_sweep itself, and so
    its launch count, is untouched."""

    def __enter__(self):
        import types

        from lifelike_tpu_torch.solver import ilqr

        self.args, self._ilqr = None, ilqr
        sweep = ilqr.riccati_cuda.riccati_sweep

        def hook(*args, **kw):
            if self.args is None:
                self.args = [x.detach().clone() for x in args[:6]]
            return sweep(*args, **kw)

        self._module, ilqr.riccati_cuda = ilqr.riccati_cuda, types.SimpleNamespace(
            riccati_sweep=hook)
        return self

    def __exit__(self, *exc):
        self._ilqr.riccati_cuda = self._module


def time_riccati():
    """Phase 11 for K6: device time (torch.profiler), the wrapper call, the
    plain sweep and the bound at the hybrid loop's shape (S 8, H 50) in
    float32 and float64, and at S 1. Returns the K6 row of the kernels line
    (float32, S 8)."""
    import torch

    from lifelike_tpu_torch.solver import riccati_cuda

    rows = {}
    for S, dtype in ((RICCATI_S, torch.float32), (RICCATI_S, torch.float64),
                     (1, torch.float32)):
        args = riccati_system(S, HORIZON, dtype, 70 + S)
        call = lambda: riccati_cuda.riccati_sweep(*args, reg=1e-3)
        wrapper_ms = cuda_ms(call, reps=20, warmup=3)
        kernel_ms = device_ms(call, "riccati_sweep_kernel")
        plain_ms = cuda_ms(lambda: riccati_cuda.riccati_sweep_plain(*args, reg=1e-3), reps=1)
        ops = RICCATI_OPS_PER_STEP * S * HORIZON
        nbytes = RICCATI_BYTES_PER_STEP * S * HORIZON * (dtype.itemsize // 4)
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_FP64_FLOPS
        ops_ms, bytes_ms = 1e3 * ops / peak, 1e3 * nbytes / PEAK_HBM_BYTES
        bound_ms, by = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
        name = str(dtype).replace("torch.", "")
        floor_ms = RICCATI_DEPTH_PER_STEP * HORIZON * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
        say(f"chain floor K6 {name} S {S}: {RICCATI_DEPTH_PER_STEP} levels x H {HORIZON} x "
            f"{CHAIN_CYCLES} cycles = {floor_ms:.4f} ms | kernel {kernel_ms:.4f} ms, "
            f"{kernel_ms / floor_ms:.2f}x the floor")
        say(f"timing K6 {name} S {S} H {HORIZON}: kernel {kernel_ms:.4f} ms (device time, "
            f"torch.profiler) | wrapper call {wrapper_ms:.4f} ms (CUDA events) | plain "
            f"{plain_ms:.2f} ms | bound {bound_ms:.6f} ms ({ops:.4e} ops / {peak / 1e12:g} "
            f"TFLOP/s = {ops_ms:.6f} ms; {nbytes} B / 3.35 TB/s = {bytes_ms:.6f} ms, bound by "
            f"{by}) | kernel at {100 * bound_ms / kernel_ms:.4f}% of bound | {S} of 132 SMs | "
            f"library: none (no single PyTorch call computes the sweep)")
        rows[(S, name)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                               library_ms=None)
    return rows[(RICCATI_S, "float32")]


def hybrid_breakdown(k6_ms):
    """Phase 11: where one hybrid PMC solve's time goes, at the loop's
    widths: the host clock (card synchronized) around each stage of one
    solve from the loop's start state (the MPPI stage, the rollout of the
    seeds, the linearizations, the sweeps, the line-search rollouts), K6's
    device time beside it. Runs after phase 10c's loop, whose first solve
    warmed up the same path."""
    import types

    import torch

    from lifelike_tpu_torch.bin import run_mpc
    from lifelike_tpu_torch.solver import ilqr, mppi_tl, riccati_cuda

    args = run_mpc.parse_args([
        "--task=pmc", f"--population={HYB_POP}", f"--horizon={HORIZON}", "--device=cuda",
        "--hybrid", f"--ilqr_iterations={HYB_ITERS}", f"--n_refine={HYB_REFINE}", "--seed=0"])
    dev, model, clips, cfg, ctrl, gen, env, u = run_mpc.setup_pmc(args)
    # solver.ilqr reaches the sweep through a stand-in for its riccati_cuda
    # module, so that riccati_sweep (and its launch count) stays untouched
    sweep_ns = types.SimpleNamespace(riccati_sweep=riccati_cuda.riccati_sweep)
    stages = {"MPPI stage (K1)": (mppi_tl, "mppi_step"), "seed rollout": (ilqr, "_rollout"),
              "linearize": (ilqr, "linearize"), "Riccati sweep (K6 call)":
              (sweep_ns, "riccati_sweep"), "line search": (ilqr, "_feedback_rollout")}
    spent = {k: 0.0 for k in stages}
    saved = {k: getattr(mod, fn) for k, (mod, fn) in stages.items()}

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    for k, (mod, fn) in stages.items():
        setattr(mod, fn, timed(k, saved[k]))
    ilqr.riccati_cuda = sweep_ns
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl(gen, env.robot, env.clip_idx, env.t, u)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ilqr.riccati_cuda = riccati_cuda
        for k, (mod, fn) in stages.items():
            setattr(mod, fn, saved[k])
    parts = " | ".join(f"{k} {1e3 * v:.1f} ms ({100 * v / total:.1f}%)" for k, v in spent.items())
    say(f"timing hybrid PMC solve breakdown (pop {HYB_POP} H {HORIZON} S {RICCATI_S}, "
        f"{HYB_ITERS} iLQR iterations; host clock, card synchronized around each stage): total "
        f"{1e3 * total:.1f} ms | {parts} | other {1e3 * (total - sum(spent.values())):.1f} ms | "
        f"K6 device time {HYB_ITERS} x {k6_ms:.4f} ms = {100 * HYB_ITERS * k6_ms / 1e3 / total:.4f}"
        f"% of the solve")


def closed_loop(task, launches_of, log_prefix, hard_contact=False, hybrid=None):
    """The control steps of run_mpc --task=<task> at the headline widths
    (STEPS; CHASE_STEPS at population CHASE_POP per robot for sepmc), with
    every kernel count set to 0 first; returns (run_mpc's dict, launches per
    kernel in this run). hard_contact (epmc): the playground steps on the
    impulse (PGS) plant, PlaygroundConfig(hard_contact=True). hybrid: a dict
    (steps, population, horizon, ilqr_iterations) for run_mpc --hybrid
    (n_refine HYB_REFINE)."""
    from lifelike_tpu_torch.bin import run_mpc
    from lifelike_tpu_torch.envs import playground
    from lifelike_tpu_torch.scene import playground_gen

    steps, pop = (CHASE_STEPS, CHASE_POP) if task == "sepmc" else (STEPS, POP)
    horizon = HORIZON
    flags = []
    if hybrid:
        steps, pop, horizon = hybrid["steps"], hybrid["population"], hybrid["horizon"]
        flags = ["--hybrid", f"--ilqr_iterations={hybrid['ilqr_iterations']}",
                 f"--n_refine={HYB_REFINE}"]
    argv = [f"--task={task}", f"--steps={steps}", f"--population={pop}",
            f"--horizon={horizon}", "--iterations=1", "--device=cuda", "--seed=0"] + flags
    if task == "epmc":
        argv.append("--element_id=1")
    if task == "sepmc":
        argv.append("--best_response=1")
    args = run_mpc.parse_args(argv)
    run = {"pmc": run_mpc.run_pmc, "epmc": run_mpc.run_epmc, "sepmc": run_mpc.run_sepmc}[task]
    kw = {}
    if hard_contact:
        kw["env_cfg"] = playground.PlaygroundConfig(
            scene=playground_gen.PlaygroundConfig(element_id=args.element_id), hard_contact=True)
    for k in launches_of:
        k.launches = 0
    out = run(args, log=lambda m: say(f"{log_prefix}: " + m), **kw)
    launches = [k.launches for k in launches_of]
    rewards = out["step_rewards"]
    flat = [x for r in rewards for x in (r if isinstance(r, list) else [r])]
    say(f"{log_prefix} rewards: " + " ".join(
        "/".join(f"{x:.6f}" for x in r) if isinstance(r, list) else f"{r:.6f}" for r in rewards))
    t_ms = [1e3 * t for t in out["t_solve"][1:]]
    extra = ""
    if task == "epmc":
        extra = (f" | fall at steps {[i for i, f in enumerate(out['falls']) if f]}, reached at "
                 f"steps {[i for i, r in enumerate(out['reached']) if r]}")
        p_ms = [1e3 * t for t in out["t_plant"][1:]]
        extra += (f" | plant step after warm-up p50 {statistics.median(p_ms):.3f} ms max "
                  f"{max(p_ms):.3f} ms")
    if task == "sepmc":
        extra = f" | games {out['games']}, final distance {out['final_dist']:.3f} m"
    if hybrid:
        extra += f" | refined cost per step {out['refined_cost']} | seed costs {out['seed_costs']}"
    say(f"{log_prefix}: {len(rewards)} steps, episode ends at {out['episode_ends']}{extra}, "
        f"solve latency after warm-up p50 {statistics.median(t_ms):.3f} ms max {max(t_ms):.3f} ms "
        f"(CUDA events) | kernel launches {launches}")
    if len(rewards) != steps or not all(math.isfinite(r) for r in flat):
        raise SystemExit(f"{log_prefix}: missing or non-finite rewards")
    return out, launches


def bound(ops, nbytes):
    """(bound ms, what bounds it, ops ms, bytes ms) on this card's peaks."""
    ops_ms, bytes_ms = 1e3 * ops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops_ms, \
        bytes_ms


def time_kernel(key, kernel_fn, plain_fn, exact_fn, nbytes, lanes=POP, label=None,
                exact_label="mass_freeze 1 (closed-loop setting)", reps=20):
    """Kernel, plain version and bound at the headline shape; the kernel at
    the closed loop's setting (exact_fn). lanes: candidates (K3: plans) of
    the launch."""
    kernel_ms = cuda_ms(kernel_fn, reps=reps, warmup=3)
    plain_ms = cuda_ms(plain_fn, reps=1, warmup=1)
    exact_ms = cuda_ms(exact_fn, reps=reps, warmup=3)
    ops = OPS_PER_LANE_STEP[key] * lanes * HORIZON
    bound_ms, by, ops_ms, bytes_ms = bound(ops, nbytes)
    label = label or f"pop {POP} H {HORIZON} substeps {SUBSTEPS} mass_freeze {SUBSTEPS}"
    say(f"timing {key} f32 {label}: "
        f"kernel {kernel_ms:.4f} ms | plain {plain_ms:.1f} ms | bound {bound_ms:.6f} ms "
        f"({ops:.4e} ops / 67 TFLOP/s = {ops_ms:.6f} ms; {nbytes} B / 3.35 TB/s = "
        f"{bytes_ms:.6f} ms) | kernel at {100 * bound_ms / kernel_ms:.4f}% of bound | "
        f"library: none | kernel at {exact_label} {exact_ms:.4f} ms")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None), exact_ms


def model_len():
    """Values of the packed float32 model constants (the kernels' model read)."""
    import torch

    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.robot.model import build_max_model

    c = B.tl_constants(build_max_model(), dtype=torch.float32, device=torch.device("cuda"))
    return rollout_cuda.pack_model(c).numel()


def time_rollouts(smoke):
    """K1 and K2 at the headline shape (PMC; the EPMC solve's kernel call:
    joystick, gait_weight 0, constant reference, as bench.py bench_epmc's
    fused row) and at the closed loops' mass_freeze 1, each beside its chain
    floor at both, built from `smoke`'s input makers and timer: this module,
    or an older checkout's chip_smoke.py in the --timing mode (which has the
    same solve_inputs, traversal_inputs and time_kernel). Returns ({key:
    kernels-line timing}, {key: ms at mass_freeze 1})."""
    import torch

    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.solver import rollout_tl

    model_n = model_len()
    c, params, tl, u, ref = smoke.solve_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 3)
    c1, params1, tl1, u1, ref1 = smoke.solve_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 3)
    rows, exact = {}, {}
    rows["K1"], exact["K1"] = smoke.time_kernel(
        "K1", lambda: rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref),
        lambda: rollout_tl.rollout_tracking(c, params, tl, u, ref),
        lambda: rollout_cuda.rollout_tracking_fused(c1, params1, tl1, u1, ref1),
        4 * (u.numel() + 37 + HORIZON * 64 + model_n + POP))
    targs = smoke.traversal_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 14,
                                   gait=False)
    targs1 = smoke.traversal_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 14, gait=False)
    rest, kw = ("joystick", 1000), dict(gait_weight=0.0)
    u, table = targs[3], targs[4]
    rows["K2"], exact["K2"] = smoke.time_kernel(
        "K2", lambda: tc.rollout_traversal_fused(*targs, *rest, **kw),
        lambda: tc.rollout_traversal_plain(*targs, *rest, **kw),
        lambda: tc.rollout_traversal_fused(*targs1, *rest, **kw),
        4 * (u.numel() + 37 + HORIZON * 64 + tc.TASK_WIDTH + table.numel() + model_n + POP))
    for key in rows:
        chain_floor(key, SUBSTEPS, SUBSTEPS, rows[key]["ms"])
        chain_floor(key, SUBSTEPS, 1, exact[key])
    return rows, exact


def time_chase(model_n):
    """K3 (S = 1 and SWEEP_S plans) and K4 at the chase solve's kernel calls
    (bench.py bench_sepmc's fused row): the 4-wall arena, constant
    references at the current joints, gait_weight 0; headline substeps 10 /
    mass_freeze 10, then the chase plant's substeps 20 / mass_freeze 1."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda as tc

    timing = {}
    c, params, tl, u, table, rows, opp, flag = chase_kernel_inputs(
        torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, CHASE_POP, 44, gait=False, contact=False)
    c1, params1, tl1, u1, table1, rows1, opp1, flag1 = chase_kernel_inputs(
        torch.float32, HORIZON, CHASE_SUBSTEPS, 1, CHASE_POP, 44, gait=False, contact=False)
    K = table.shape[0]
    plant = f"substeps {CHASE_SUBSTEPS} mass_freeze 1 (chase plant)"
    for n in (1, SWEEP_S):
        plan = u[:, :, :, 0, :n].permute(3, 0, 1, 2).contiguous()  # (S, H, 4, 3)
        plan = plan if n > 1 else plan[0]
        tls = type(tl)(*(x.expand(x.shape[:-2] + (n, 1)).contiguous() for x in tl))
        t, exact_ms = time_kernel(
            "K3", lambda: tc.rollout_plan_fused(c, params, tls, plan, table, rows),
            lambda: tc.rollout_plan_plain(c, params, tls, plan, table, rows),
            lambda: tc.rollout_plan_fused(c1, params1, tls, plan, table1, rows1),
            4 * n * (HORIZON * 12 + 37 + K * 8 + HORIZON * 64 + HORIZON * 3) + 4 * model_n,
            lanes=n, label=f"S {n} H {HORIZON} substeps {SUBSTEPS} mass_freeze {SUBSTEPS} K {K}",
            exact_label=plant, reps=5)
        b1 = bound(OPS_PER_LANE_STEP_CHASE_PLANT["K3"] * n * HORIZON, 1)[0]
        say(f"bound K3 S={n} at the chase plant: {b1:.6f} ms (operations) | kernel at "
            f"{100 * b1 / exact_ms:.4f}% of it")
        chain_floor("K3", SUBSTEPS, SUBSTEPS, t["ms"], f"K3 S={n}")
        chain_floor("K3", CHASE_SUBSTEPS, 1, exact_ms, f"K3 S={n}")
        timing["K3" if n == 1 else f"K3 S={n}"] = t
    role = torch.tensor(True, device=u.device)
    t, exact_ms = time_kernel(
        "K4", lambda: tc.rollout_chase_fused(c, params, tl, u, table, rows, opp, flag, role,
                                             gait_weight=0.0),
        lambda: tc.rollout_chase_plain(c, params, tl, u, table, rows, opp, flag, role,
                                       gait_weight=0.0),
        lambda: tc.rollout_chase_fused(c1, params1, tl1, u1, table1, rows1, opp1, flag1, role,
                                       gait_weight=0.0),
        4 * (u.numel() + 37 + HORIZON * 64 + tc.TASK_WIDTH + table.numel() + model_n
             + CHASE_POP), lanes=CHASE_POP,
        label=f"pop {CHASE_POP} H {HORIZON} substeps {SUBSTEPS} mass_freeze {SUBSTEPS} K {K}",
        exact_label=plant)
    b1 = bound(OPS_PER_LANE_STEP_CHASE_PLANT["K4"] * CHASE_POP * HORIZON, 1)[0]
    say(f"bound K4 at the chase plant: {b1:.6f} ms (operations) | kernel at "
        f"{100 * b1 / exact_ms:.4f}% of it")
    chain_floor("K4", SUBSTEPS, SUBSTEPS, t["ms"])
    chain_floor("K4", CHASE_SUBSTEPS, 1, exact_ms)
    timing["K4"] = t
    return timing


def main():
    if importlib.util.find_spec("lifelike_tpu_torch") is None:
        print("chip_smoke: no lifelike_tpu_torch package beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import cuda_build, pgs_cuda, rollout_cuda, traversal_cuda
    from lifelike_tpu_torch.solver import riccati_cuda

    t_start = time.perf_counter()
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvidia-smi: {smi} | max SM clock {sm_clock_mhz():g} MHz")

    # 2. build: one nvcc per kernel source, all started together
    tc = traversal_cuda
    kernels = {"K1": (rollout_cuda.KERNEL, CONTACT_K), "K2": (tc.KERNEL, CONTACT_K),
               "K3": (tc.PLAN_KERNEL, 4), "K4": (tc.CHASE_KERNEL, 4),
               "K5": (pgs_cuda.KERNEL, None), "K6": (riccati_cuda.KERNEL, None)}
    t0 = time.perf_counter()
    infos = dict(zip(kernels, cuda_build.build_all([k for k, _ in kernels.values()])))
    say(f"build: {len(infos)} kernels in {time.perf_counter() - t0:.1f} s wall "
        f"(nvcc {', '.join(f'{k} {i.seconds:.1f} s' for k, i in infos.items())})")
    for key, (kernel, n_boxes) in kernels.items():
        info = infos[key]
        say(f"{key} library: {info.path}")
        if key == "K5":
            pgs_cuda.build()
            for sym, v in sorted(pgs_cuda.ptxas_summary(info.ptxas).items()):
                say(f"ptxas K5 {'f64' if 'IdLi' in sym else 'f32'} rows "
                    f"{sym.split('Li')[1].split('E')[0]}: {v}")
            for dt in (torch.float32, torch.float64):
                for rows in pgs_cuda.ROW_COUNTS:
                    a = pgs_cuda.kernel_attributes(dt, rows)
                    blocks = -(-IMPULSE_B // a["per_block"])
                    say(f"runtime K5 {str(dt).replace('torch.', '')} rows {rows}: {a} | "
                        f"{a['group']} lanes per robot, {a['per_block']} robots per one-warp "
                        f"block: B {IMPULSE_B} in {blocks} blocks on {min(blocks, 132)} of 132 "
                        f"SMs, {a['blocks_per_sm']} blocks resident per SM")
            continue
        if key == "K6":
            riccati_cuda.build()
            for sym, v in sorted(riccati_cuda.ptxas_summary(info.ptxas).items()):
                say(f"ptxas K6 {'f32' if 'IfE' in sym else 'f64'} I/O: {v}")
            for dt in (torch.float32, torch.float64):
                a = riccati_cuda.kernel_attributes(dt)
                say(f"runtime K6 {str(dt).replace('torch.', '')}: {a} | blocks (scenarios) at "
                    f"the hybrid's S {RICCATI_S}: {RICCATI_S} of 132 SMs, "
                    f"{a['blocks_per_sm']} resident per SM")
            continue
        if key == "K1":
            rollout_cuda.build()
            ptxas = rollout_cuda.ptxas_summary(info.ptxas)
        else:
            tc.build(kernel)
            ptxas = tc.ptxas_summary(info.ptxas, kernel)
        for sym, v in sorted(ptxas.items()):
            say(f"ptxas {key} {'f64' if 'IdEE' in sym else 'f32'}: {v}")
        for dt in (torch.float32, torch.float64):
            a = (rollout_cuda.kernel_attributes(dt, HORIZON) if key == "K1"
                 else tc.kernel_attributes(dt, HORIZON, n_boxes, kernel))
            say(f"runtime {key} {str(dt).replace('torch.', '')}: {a} | " + group_geometry(key, a))

    # 3. / 4. K1 vs its plain version
    err = {"K1": compare("check K1 f32", torch.float32, 3, 2, 1, 2e-4, seed=1)}
    compare("check K1 f64", torch.float64, HORIZON, SUBSTEPS, SUBSTEPS, 1e-6, seed=2)
    compare("check K1 f64 closed-loop setting", torch.float64, HORIZON, SUBSTEPS, 1, 1e-6,
            seed=4)

    # 5. K2 vs its plain version
    err["K2"] = max(
        compare_traversal("check K2 f32", torch.float32, 3, 2, 1, 2e-4, 11, rt, gw, crawl)
        for rt, gw, crawl in (("joystick", 1.0, False), ("average_speed", 0.0, False),
                              ("joystick", 0.0, True), ("average_speed", 1.0, True)))
    compare_traversal("check K2 f64", torch.float64, HORIZON, SUBSTEPS, SUBSTEPS, 1e-6, 12,
                      "joystick", 1.0, conditioning=True)
    compare_traversal("check K2 f64 closed-loop setting", torch.float64, HORIZON, SUBSTEPS, 1,
                      1e-6, 13, "average_speed", 0.0, conditioning=True)
    compare_scenarios(1e-6)

    # 6. K3 vs its plain version
    err["K3"] = max(compare_plan("check K3 f32", torch.float32, 3, 2, 1, 2e-4, 31, n)
                    for n in (1, SWEEP_S))
    for n in (1, SWEEP_S):
        compare_plan("check K3 f64 chase plant", torch.float64, HORIZON, CHASE_SUBSTEPS, 1, 1e-6,
                     32, n, conditioning=True)

    # 7. K4 vs its plain version
    err["K4"] = max(
        compare_chase("check K4 f32", torch.float32, 3, 2, 1, 2e-4, 41, chaser, gw)
        for chaser, gw in ((True, 0.8), (False, 0.8), (True, 0.0), (False, 0.0)))
    compare_chase("check K4 f64", torch.float64, HORIZON, SUBSTEPS, SUBSTEPS, 1e-6, 42, True, 0.8,
                  conditioning=True)
    compare_chase("check K4 f64 closed-loop setting", torch.float64, HORIZON, CHASE_SUBSTEPS, 1,
                  1e-6, 43, False, 0.0, conditioning=True)
    compare_chase_scenarios(1e-6)

    # 8a. K5 vs its plain version; 8b. the impulse plant through K5 vs the
    # golden traces
    err["K5"] = compare_pgs(torch.float32, 1e-5)
    compare_pgs(torch.float64, 1e-9)
    check_traces()

    # 8c. K6 vs its plain version on random systems
    err["K6"] = compare_riccati_random()

    # 8. - 10. the main paths: each closed loop through bin/run_mpc on its kernels
    # 10b. the EPMC closed loop on the hard-contact plant (K2 plans, K5 steps)
    fns = (rollout_cuda.rollout_tracking_fused, tc.rollout_traversal_fused,
           tc.rollout_plan_fused, tc.rollout_chase_fused, pgs_cuda.pgs_sweep,
           riccati_cuda.riccati_sweep)
    _, pmc = closed_loop("pmc", fns, "closed loop pmc")
    _, epmc = closed_loop("epmc", fns, "closed loop epmc")
    _, sepmc = closed_loop("sepmc", fns, "closed loop sepmc")
    _, hard = closed_loop("epmc", fns, "closed loop epmc hard-contact", hard_contact=True)
    rounds, robots = 1, 2
    # 10c. the hybrid closed loops: PMC at bench_hybrid's width, its first
    # linearization captured for 10d; EPMC and SEPMC at a smaller depth
    with SweepCapture() as cap:
        out, hyb = closed_loop("pmc", fns, "closed loop pmc hybrid", hybrid=dict(
            steps=HYB_STEPS, population=HYB_POP, horizon=HORIZON, ilqr_iterations=HYB_ITERS))
    for i, (refined, seeds) in enumerate(zip(out["refined_cost"], out["seed_costs"])):
        if not refined <= min(seeds) + 1e-5:
            raise SystemExit(f"hybrid pmc step {i}: refined cost {refined} above the best seed's "
                             f"{min(seeds)}")
    t_hyb = [1e3 * t for t in out["t_solve"]]
    say(f"closed loop pmc hybrid: refined <= best seed + 1e-5 at every step | solve times "
        f"{', '.join(f'{t:.1f}' for t in t_hyb)} ms (the first includes warm-up)")
    task_hybrid = dict(steps=HYB_TASK_STEPS, horizon=HYB_TASK_HORIZON, ilqr_iterations=1)
    _, hyb_epmc = closed_loop("epmc", fns, "closed loop epmc hybrid",
                              hybrid=dict(task_hybrid, population=POP))
    _, hyb_sepmc = closed_loop("sepmc", fns, "closed loop sepmc hybrid",
                               hybrid=dict(task_hybrid, population=CHASE_POP))
    n = HYB_TASK_STEPS * rounds * robots
    expected = {"pmc": [STEPS, 0, 0, 0, 0, 0], "epmc": [0, STEPS, 0, 0, 0, 0],
                "sepmc": [0, 0, CHASE_STEPS * rounds * robots, CHASE_STEPS * rounds * robots, 0,
                          0],
                "epmc hard-contact": [0, STEPS, 0, 0, STEPS * IMPULSE_SUBSTEPS, 0],
                "pmc hybrid": [HYB_STEPS, 0, 0, 0, 0, HYB_STEPS * HYB_ITERS],
                "epmc hybrid": [0, HYB_TASK_STEPS, 0, 0, 0, HYB_TASK_STEPS],
                "sepmc hybrid": [0, 0, n, n, 0, n]}
    for task, got in (("pmc", pmc), ("epmc", epmc), ("sepmc", sepmc),
                      ("epmc hard-contact", hard), ("pmc hybrid", hyb),
                      ("epmc hybrid", hyb_epmc), ("sepmc hybrid", hyb_sepmc)):
        if got != expected[task]:
            raise SystemExit(f"kernel launches of the {task} loop (K1-K6): {got}, expected "
                             f"{expected[task]}")
    launches = {"K1": pmc[0], "K2": epmc[1], "K3": sepmc[2], "K4": sepmc[3], "K5": hard[4],
                "K6": hyb[5]}
    # 10d. K6 vs its plain version on the PMC hybrid loop's own linearization
    compare_riccati_loop(cap.args)

    # 11. timings at the headline solve shapes
    timing, _ = time_rollouts(sys.modules[__name__])
    timing.update(time_chase(model_len()))
    timing["K5"] = time_pgs()
    timing["K6"] = time_riccati()
    hybrid_breakdown(timing["K6"]["ms"])

    say(json.dumps({"kernels": [
        dict(name=KERNELS[k]["name"], route="cuda", source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=launches[k], max_abs_err=err[k],
             **timing[k])
        for k in KERNELS]}))
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def timing_mode(argv):
    """The --timing mode (see the module's docstring)."""
    import argparse
    import os
    import re
    import shutil

    ap = argparse.ArgumentParser(prog="chip_smoke.py --timing")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--only", action="append", default=[],
                    choices=[f"K{i}" for i in range(1, 7)])
    ap.add_argument("--group", action="append", default=[], metavar="Kn=G")
    ap.add_argument("--loop", action="append", default=[], choices=("pmc", "epmc", "sepmc"))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke_of_root",
                                                  os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import cuda_build, pgs_cuda, rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.solver import riccati_cuda

    if not os.path.dirname(os.path.abspath(tc.__file__)).startswith(root):
        raise SystemExit(f"lifelike_tpu_torch imported from {tc.__file__}, not from {root}")
    smi = nvidia_smi()
    say(f"timing: {root} | {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | max SM clock "
        f"{sm_clock_mhz():g} MHz")
    kernels = {"K1": rollout_cuda.KERNEL, "K2": tc.KERNEL, "K3": tc.PLAN_KERNEL,
               "K4": tc.CHASE_KERNEL, "K5": pgs_cuda.KERNEL, "K6": riccati_cuda.KERNEL}
    keys = sorted(set(args.only)) or sorted(kernels)
    groups = {k: int(g) for k, g in (a.split("=") for a in args.group)}
    lane_groups = {"K1": (4, 8), "K2": (4, 8), "K3": (4, 8), "K4": (4, 8), "K5": (8, 16, 32)}
    for key, g in groups.items():
        if g not in lane_groups.get(key, ()):
            raise SystemExit(f"--group {key}={g}: no such lane group")
    if groups:
        variant = os.path.join(cuda_build.BUILD_DIR, "csrc_" + "_".join(
            f"{k}g{g}" for k, g in sorted(groups.items())))
        shutil.rmtree(variant, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, variant)
        for key, g in groups.items():
            path = os.path.join(variant, kernels[key].source)
            with open(path) as f:
                text, n = re.subn(r"constexpr int kGroup = \d+;", f"constexpr int kGroup = {g};",
                                  f.read())
            if n != 1:
                raise SystemExit(f"{path}: no single `constexpr int kGroup = ...;` to rewrite")
            with open(path, "w") as f:
                f.write(text)
            if key == "K1":
                rollout_cuda.GROUP = g
            elif key != "K5":  # K5's launch takes its geometry from the library
                spec = tc._LIB_SPECS[kernels[key]]
                tc._LIB_SPECS[kernels[key]] = spec._replace(
                    group=g, per_block=spec.per_block if key == "K3" else tc.BLOCK // g)
        cuda_build.CSRC_DIR = variant
    for key, info in zip(keys, cuda_build.build_all([kernels[k] for k in keys])):
        if key == "K1":
            rollout_cuda.build()
            ptxas = rollout_cuda.ptxas_summary(info.ptxas)
        elif key == "K5":
            pgs_cuda.build()
            ptxas = pgs_cuda.ptxas_summary(info.ptxas)
        elif key == "K6":
            riccati_cuda.build()
            ptxas = riccati_cuda.ptxas_summary(info.ptxas)
        else:
            tc.build(kernels[key])
            ptxas = tc.ptxas_summary(info.ptxas, kernels[key])
        for sym, v in sorted(ptxas.items()):
            say(f"ptxas {key} {sym}: {v}")
    rows, exact = {}, {}
    if {"K1", "K2"} & set(keys):
        rows, exact = time_rollouts(smoke)
    if {"K3", "K4"} & set(keys):
        rows.update(smoke.time_chase(model_len()))
    if "K5" in keys:
        rows["K5"] = smoke.time_pgs()
    if "K6" in keys:
        rows["K6"] = smoke.time_riccati()
    out = {"root": root, "groups": groups, "smi": smi,
           "timing": {k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms")}
                      for k, v in rows.items()},
           "closed_loop_setting_ms": exact}
    fns = {"pmc": (rollout_cuda.rollout_tracking_fused,), "epmc": (tc.rollout_traversal_fused,),
           "sepmc": (tc.rollout_plan_fused, tc.rollout_chase_fused)}
    for task in args.loop:
        run, launches = smoke.closed_loop(task, fns[task], f"closed loop {task}")
        t_ms = [1e3 * t for t in run["t_solve"][1:]]
        out[task] = {"solve_p50_ms": statistics.median(t_ms), "solve_max_ms": max(t_ms),
                     "launches": launches}
    say(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--timing"]:
        sys.exit(timing_mode(sys.argv[2:]))
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the lifelike_tpu_torch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before the
result line:
  1. the device (torch name, nvidia-smi name and power limit);
  2. the build of both CUDA kernels (one nvcc per source, started together;
     wall time, ptxas registers/spills, runtime registers, local bytes and
     resident blocks per SM): K1 the PMC tracking rollout, K2 the EPMC
     traversal rollout with box contact;
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
  6. the PMC closed loop through bin/run_mpc (population 4096, H 50, 1 MPPI
     iteration, default plant) for STEPS control steps, with K1's launch
     count checked against solves x iterations;
  7. the EPMC closed loop through bin/run_mpc --task=epmc (hurdles,
     population 4096, H 50, 1 iteration, 8-box corridor prune, default
     playground plant) for STEPS control steps, K2's launches likewise;
  8. timings at the headline solve shapes (float32, mass_freeze 10): each
     kernel, its plain version and its bound on this card, and each kernel
     at mass_freeze 1 (the closed loops' setting);
then one JSON line listing both kernels, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}. Needs one card; builds the
kernels from the sources in lifelike_tpu_torch/csrc/ with nvcc. Exits
non-zero without a result when no card (or no lifelike_tpu_torch beside
this file) is present.
"""
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time

STEPS = 20  # closed-loop control steps of each task
POP, HORIZON, SUBSTEPS = 4096, 50, 10  # headline solve shape (bench.py bench_pmc)
CONTACT_K = 8  # boxes per EPMC solve (solver/mpc_tasks.py CONTACT_K)
# Scalar operations per candidate per control step at substeps 10 /
# mass_freeze 10: tools/sol_report.py::_lane_flops_per_control_step (the
# arithmetic primitives of one lifelike_tpu.ops.scalar_phys.control_step
# traced at (1, 1) tiles), counted on the CPU. K1: the plane-contact step.
# K2: the same count applied to scalar_phys.control_step(..., boxes=bx) with
# 8 boxes of shape (8, 1, 1) (155,546) plus the traversal stage cost of
# ops/traversal_pallas.py (_direction_terms, posture, fall and clearance
# over the 8 boxes: 312).
OPS_PER_LANE_STEP = {"K1": 52286, "K2": 155546 + 312}
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNELS = {
    "K1": dict(name="rollout_tracking_fused (K1 with K0 inlined)",
               source="lifelike_tpu_torch/csrc/rollout_tracking.cu",
               replaces="lifelike_tpu/ops/rollout_pallas.py:202"),
    "K2": dict(name="rollout_traversal_fused (K2 with K0 and box contact inlined)",
               source="lifelike_tpu_torch/csrc/rollout_traversal.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:626"),
}


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
    say(f"{label}: max|kernel-plain| {float(err[gated].max()):.3e} (rtol=atol={tol:g}, {bad} "
        f"outside){note} | cost mean {float(want.mean()):.6f} min {float(want.min()):.6f} "
        f"max {float(want.max()):.6f}")
    if bad:
        raise SystemExit(f"{label}: kernel disagrees with its plain version")
    return float(err[gated].max())


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


def closed_loop(task, launches_of, log_prefix):
    """STEPS control steps of run_mpc --task=<task> at the headline widths,
    with every kernel count set to 0 first; returns (run_mpc's dict,
    launches per kernel in this run)."""
    from lifelike_tpu_torch.bin import run_mpc

    for k in launches_of:
        k.launches = 0
    argv = [f"--task={task}", f"--steps={STEPS}", f"--population={POP}",
            f"--horizon={HORIZON}", "--iterations=1", "--device=cuda", "--seed=0"]
    if task == "epmc":
        argv.append("--element_id=1")
    args = run_mpc.parse_args(argv)
    run = run_mpc.run_epmc if task == "epmc" else run_mpc.run_pmc
    out = run(args, log=lambda m: say(f"{log_prefix}: " + m))
    launches = [k.launches for k in launches_of]
    rewards = out["step_rewards"]
    say(f"{log_prefix} rewards: " + " ".join(f"{r:.6f}" for r in rewards))
    t_ms = [1e3 * t for t in out["t_solve"][1:]]
    extra = ""
    if task == "epmc":
        extra = (f" | fall at steps {[i for i, f in enumerate(out['falls']) if f]}, reached at "
                 f"steps {[i for i, r in enumerate(out['reached']) if r]}")
    say(f"{log_prefix}: {len(rewards)} steps, episode ends at {out['episode_ends']}{extra}, "
        f"solve latency after warm-up p50 {statistics.median(t_ms):.3f} ms max {max(t_ms):.3f} ms "
        f"(CUDA events) | kernel launches {launches} (solves x iterations = {STEPS})")
    if len(rewards) != STEPS or not all(math.isfinite(r) for r in rewards):
        raise SystemExit(f"{log_prefix}: missing or non-finite rewards")
    return out, launches


def time_kernel(key, kernel_fn, plain_fn, exact_fn, nbytes):
    """Kernel, plain version and bound at the headline shape; the kernel at
    mass_freeze 1 (exact_fn)."""
    kernel_ms = cuda_ms(kernel_fn, reps=20, warmup=3)
    plain_ms = cuda_ms(plain_fn, reps=1, warmup=1)
    exact_ms = cuda_ms(exact_fn, reps=20, warmup=3)
    ops = OPS_PER_LANE_STEP[key] * POP * HORIZON
    ops_ms, bytes_ms = 1e3 * ops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
    bound_ms = max(ops_ms, bytes_ms)
    say(f"timing {key} f32 pop {POP} H {HORIZON} substeps {SUBSTEPS} mass_freeze {SUBSTEPS}: "
        f"kernel {kernel_ms:.4f} ms | plain {plain_ms:.1f} ms | bound {bound_ms:.4f} ms "
        f"({ops:.4e} ops / 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes} B / 3.35 TB/s = "
        f"{bytes_ms:.5f} ms) | kernel at {100 * bound_ms / kernel_ms:.2f}% of bound | "
        f"library: none | kernel at mass_freeze 1 (closed-loop setting) {exact_ms:.4f} ms")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None)


def main():
    if importlib.util.find_spec("lifelike_tpu_torch") is None:
        print("chip_smoke: no lifelike_tpu_torch package beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import cuda_build, rollout_cuda, traversal_cuda
    from lifelike_tpu_torch.solver import rollout_tl

    t_start = time.perf_counter()
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvidia-smi: {smi}")

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    infos = cuda_build.build_all([rollout_cuda.KERNEL, traversal_cuda.KERNEL])
    say(f"build: {len(infos)} kernels in {time.perf_counter() - t0:.1f} s wall "
        f"(nvcc {', '.join(f'{i.seconds:.1f} s' for i in infos)})")
    for key, mod, info in (("K1", rollout_cuda, infos[0]), ("K2", traversal_cuda, infos[1])):
        mod.build()
        say(f"{key} library: {info.path}")
        for sym, v in sorted(mod.ptxas_summary(info.ptxas).items()):
            say(f"ptxas {key} {'f64' if 'IdEE' in sym else 'f32'}: {v}")
        for dt in (torch.float32, torch.float64):
            a = (mod.kernel_attributes(dt, HORIZON) if key == "K1"
                 else mod.kernel_attributes(dt, HORIZON, CONTACT_K))
            say(f"runtime {key} {str(dt).replace('torch.', '')}: {a} | candidates/SM at pop "
                f"{POP}: {POP / 132:.1f} of {a['blocks_per_sm'] * a['block']} resident")

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

    # 6. / 7. the main paths: each closed loop through bin/run_mpc on its kernel
    kernels = (rollout_cuda.rollout_tracking_fused, traversal_cuda.rollout_traversal_fused)
    _, (k1_pmc, k2_pmc) = closed_loop("pmc", kernels, "closed loop pmc")
    _, (k1_epmc, k2_epmc) = closed_loop("epmc", kernels, "closed loop epmc")
    if (k1_pmc, k2_pmc) != (STEPS, 0) or (k1_epmc, k2_epmc) != (0, STEPS):
        raise SystemExit(f"kernel launches: pmc {k1_pmc}, {k2_pmc}; epmc {k1_epmc}, {k2_epmc}; "
                         f"expected {STEPS} of its own kernel each")
    launches = {"K1": k1_pmc, "K2": k2_epmc}

    # 8. timings at the headline solve shapes
    c, params, tl, u, ref = solve_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 3)
    c1, params1, tl1, u1, ref1 = solve_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 3)
    timing = {"K1": time_kernel(
        "K1", lambda: rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref),
        lambda: rollout_tl.rollout_tracking(c, params, tl, u, ref),
        lambda: rollout_cuda.rollout_tracking_fused(c1, params1, tl1, u1, ref1),
        4 * (u.numel() + 37 + HORIZON * 64 + rollout_cuda.pack_model(c).numel() + POP))}
    # the EPMC solve's kernel call: joystick, gait_weight 0, constant reference
    # (bench.py bench_epmc's fused row)
    targs = traversal_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 14, gait=False)
    targs1 = traversal_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 14, gait=False)
    rest = ("joystick", 1000)
    kw = dict(gait_weight=0.0)
    c, u, table = targs[0], targs[3], targs[4]
    timing["K2"] = time_kernel(
        "K2", lambda: traversal_cuda.rollout_traversal_fused(*targs, *rest, **kw),
        lambda: traversal_cuda.rollout_traversal_plain(*targs, *rest, **kw),
        lambda: traversal_cuda.rollout_traversal_fused(*targs1, *rest, **kw),
        4 * (u.numel() + 37 + HORIZON * 64 + traversal_cuda.TASK_WIDTH + table.numel()
             + rollout_cuda.pack_model(c).numel() + POP))

    say(json.dumps({"kernels": [
        dict(name=KERNELS[k]["name"], route="cuda", source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=launches[k], max_abs_err=err[k],
             **timing[k])
        for k in ("K1", "K2")]}))
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

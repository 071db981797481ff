#!/usr/bin/env python3
"""Smoke run of the lifelike_tpu_torch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before the
result line:
  1. the device (torch name, nvidia-smi name and power limit);
  2. the build of the four CUDA kernels (one nvcc per source, started
     together; wall time, ptxas registers/spills, runtime registers, local
     bytes and resident blocks per SM): K1 the PMC tracking rollout, K2 the
     EPMC traversal rollout with box contact, K3 the SEPMC opponent plan
     rollout, K4 the SEPMC chase rollout;
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
 11. timings at the headline solve shapes (float32, mass_freeze 10; the
     chase kernels at substeps 10 on the 4-wall arena as bench.py's
     bench_sepmc): each kernel, its plain version and its bound on this
     card, K3 at S = 1 and S = 16; then each kernel at the closed loops'
     setting (mass_freeze 1; the chase kernels at substeps 20);
then one JSON line listing the four kernels, the nvidia-smi line, and last
the result line {"ok": true, "device": {...}}. Needs one card; builds the
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
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNELS = {
    "K1": dict(name="rollout_tracking_fused (K1 with K0 inlined)",
               source="lifelike_tpu_torch/csrc/rollout_tracking.cu",
               replaces="lifelike_tpu/ops/rollout_pallas.py:202"),
    "K2": dict(name="rollout_traversal_fused (K2 with K0 and box contact inlined)",
               source="lifelike_tpu_torch/csrc/rollout_traversal.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:626"),
    "K3": dict(name="rollout_plan_fused (K3 with K0 and box contact inlined)",
               source="lifelike_tpu_torch/csrc/rollout_plan.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:287"),
    "K4": dict(name="rollout_chase_fused (K4 with K0 and box contact inlined)",
               source="lifelike_tpu_torch/csrc/rollout_chase.cu",
               replaces="lifelike_tpu/ops/traversal_pallas.py:486"),
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


def closed_loop(task, launches_of, log_prefix):
    """The control steps of run_mpc --task=<task> at the headline widths
    (STEPS; CHASE_STEPS at population CHASE_POP per robot for sepmc), with
    every kernel count set to 0 first; returns (run_mpc's dict, launches per
    kernel in this run)."""
    from lifelike_tpu_torch.bin import run_mpc

    for k in launches_of:
        k.launches = 0
    steps, pop = (CHASE_STEPS, CHASE_POP) if task == "sepmc" else (STEPS, POP)
    argv = [f"--task={task}", f"--steps={steps}", f"--population={pop}",
            f"--horizon={HORIZON}", "--iterations=1", "--device=cuda", "--seed=0"]
    if task == "epmc":
        argv.append("--element_id=1")
    if task == "sepmc":
        argv.append("--best_response=1")
    args = run_mpc.parse_args(argv)
    run = {"pmc": run_mpc.run_pmc, "epmc": run_mpc.run_epmc, "sepmc": run_mpc.run_sepmc}[task]
    out = run(args, log=lambda m: say(f"{log_prefix}: " + m))
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
    if task == "sepmc":
        extra = f" | games {out['games']}, final distance {out['final_dist']:.3f} m"
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
    from lifelike_tpu_torch.ops import cuda_build, rollout_cuda, traversal_cuda
    from lifelike_tpu_torch.solver import rollout_tl

    t_start = time.perf_counter()
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvidia-smi: {smi}")

    # 2. build: one nvcc per kernel source, all started together
    tc = traversal_cuda
    kernels = {"K1": (rollout_cuda.KERNEL, CONTACT_K), "K2": (tc.KERNEL, CONTACT_K),
               "K3": (tc.PLAN_KERNEL, 4), "K4": (tc.CHASE_KERNEL, 4)}
    t0 = time.perf_counter()
    infos = dict(zip(kernels, cuda_build.build_all([k for k, _ in kernels.values()])))
    say(f"build: {len(infos)} kernels in {time.perf_counter() - t0:.1f} s wall "
        f"(nvcc {', '.join(f'{k} {i.seconds:.1f} s' for k, i in infos.items())})")
    for key, (kernel, n_boxes) in kernels.items():
        info = infos[key]
        say(f"{key} library: {info.path}")
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
            lanes = {"K3": 1, "K4": CHASE_POP}.get(key, POP)
            say(f"runtime {key} {str(dt).replace('torch.', '')}: {a} | "
                f"{'plans' if key == 'K3' else 'candidates'}/SM at {lanes}: "
                f"{lanes / 132:.2f} of {a['blocks_per_sm'] * (1 if key == 'K3' else a['block'])} "
                "resident")

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

    # 8. - 10. the main paths: each closed loop through bin/run_mpc on its kernels
    fns = (rollout_cuda.rollout_tracking_fused, tc.rollout_traversal_fused,
           tc.rollout_plan_fused, tc.rollout_chase_fused)
    _, pmc = closed_loop("pmc", fns, "closed loop pmc")
    _, epmc = closed_loop("epmc", fns, "closed loop epmc")
    _, sepmc = closed_loop("sepmc", fns, "closed loop sepmc")
    rounds, robots = 1, 2
    expected = {"pmc": [STEPS, 0, 0, 0], "epmc": [0, STEPS, 0, 0],
                "sepmc": [0, 0, CHASE_STEPS * rounds * robots, CHASE_STEPS * rounds * robots]}
    for task, got in (("pmc", pmc), ("epmc", epmc), ("sepmc", sepmc)):
        if got != expected[task]:
            raise SystemExit(f"kernel launches of the {task} loop (K1-K4): {got}, expected "
                             f"{expected[task]}")
    launches = {"K1": pmc[0], "K2": epmc[1], "K3": sepmc[2], "K4": sepmc[3]}

    # 11. timings at the headline solve shapes
    c, params, tl, u, ref = solve_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 3)
    c1, params1, tl1, u1, ref1 = solve_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 3)
    model_n = rollout_cuda.pack_model(c).numel()
    timing = {"K1": time_kernel(
        "K1", lambda: rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref),
        lambda: rollout_tl.rollout_tracking(c, params, tl, u, ref),
        lambda: rollout_cuda.rollout_tracking_fused(c1, params1, tl1, u1, ref1),
        4 * (u.numel() + 37 + HORIZON * 64 + model_n + POP))[0]}
    # the EPMC solve's kernel call: joystick, gait_weight 0, constant reference
    # (bench.py bench_epmc's fused row)
    targs = traversal_inputs(torch.float32, HORIZON, SUBSTEPS, SUBSTEPS, POP, 14, gait=False)
    targs1 = traversal_inputs(torch.float32, HORIZON, SUBSTEPS, 1, POP, 14, gait=False)
    rest = ("joystick", 1000)
    kw = dict(gait_weight=0.0)
    u, table = targs[3], targs[4]
    timing["K2"] = time_kernel(
        "K2", lambda: tc.rollout_traversal_fused(*targs, *rest, **kw),
        lambda: tc.rollout_traversal_plain(*targs, *rest, **kw),
        lambda: tc.rollout_traversal_fused(*targs1, *rest, **kw),
        4 * (u.numel() + 37 + HORIZON * 64 + tc.TASK_WIDTH + table.numel() + model_n + POP))[0]
    timing.update(time_chase(model_n))

    say(json.dumps({"kernels": [
        dict(name=KERNELS[k]["name"], route="cuda", source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=launches[k], max_abs_err=err[k],
             **timing[k])
        for k in ("K1", "K2", "K3", "K4")]}))
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

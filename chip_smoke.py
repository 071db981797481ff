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
     (S = 4) with their own opponent trajectories, flags and roles, from
     one shared start state and from one start state per block;
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
     n_refine 7 so S = 8, 1 iLQR iteration) for HYB_STEPS control steps, K1's
     launches = solves and K6's = solves x iterations, the refined cost <=
     the best seed's + 1e-5 at every step; EPMC and SEPMC at H
     HYB_TASK_HORIZON for HYB_TASK_STEPS steps with 1 iteration (K2 / K3 /
     K4 / K6 launches checked);
 10d. K6 vs its plain version on the PMC hybrid loop's own first
     linearization (captured from its first solve): float32 at 8c's gate
     where it holds, else at twice the plain sweep's own float32-to-float64
     distance plus 2e-5 (both printed); float64 at 1e-9 of each block's
     scale;
 10e. the SEPMC scenario sweep (parallel/scenario_sweep.py) at bench.py
     bench_sweep's shape: S 16 arenas with random cubes, H 50, substeps 10,
     mass_freeze 10, sigma 0.15, one iteration, one best-response round,
     float32. Gates: (a) at population 256 the tiled sweep (K3 / K4 over all
     16 scenario blocks) equals its oracle sweep_scenarios (one scenario per
     launch) under the same normals at 2e-4, launches 2 / 2 against 32 /
     32; (b) at S 4, population 64, H 5 the sweep on the kernels matches the
     sweep on the plain versions (CPU tensors) at the reference's sweep
     tolerances (cost 5e-3, plans rtol 5e-2 / atol 5e-3); (c) finite costs
     and plans. Then at populations 256 and 1024 per robot per scenario,
     SWEEP_ROUNDS chained rounds (warm-started from the previous round's
     plans, as bench_sweep chains them) after 2 warm-up rounds: ms per round
     (CUDA events, p50 and max) under bench.py's row names
     sepmc_sweep_latency_s16_pop{256,1024}_H50, K3 / K4 launches (2 / 2 per
     round, every other kernel 0) and one profiled round's device-busy
     share (torch.profiler; not measured where no session records the
     round's K3 / K4 launches whole);
 10f. the C++ clip parser (lifelike_tpu_torch/_native) built with g++ on
     this machine; load_clips reads a synthetic clip through it, frames
     equal to the json module's;
 11. timings at the headline solve shapes (float32, mass_freeze 10; the
     chase kernels at substeps 10 on the 4-wall arena as bench.py's
     bench_sepmc): each kernel, its plain version and its bound on this
     card, K3 at S = 1 and S = 16; then each kernel at the closed loops'
     setting (mass_freeze 1; the chase kernels at substeps 20), K1-K4 at
     both settings beside their chain floor (the dependency depth of a
     control step x H x 4 cycles at the card's maximum SM clock); K5 (device
     time from torch.profiler, or, where it records no launch, from CUDA
     events around calls queued behind a spin kernel; and the wrapper call)
     at bench.py bench_impulse's shape (B 256 standing robots, 60 rows, 10
     iterations) and for one robot on the 129-row hurdle system, beside its
     chain floor (the dependency depth of a sweep x iterations x 4 cycles at
     the card's maximum SM clock), what one wrapper call on the plant's
     tensors does (one launch, two allocations for its outputs, and where
     the profiler records them no kernel but K5: a copy fails the run), and
     the whole hard-contact control step at bench_impulse's shape; K6
     (device time as K5's, the wrapper call, the plain sweep, the bound, the
     chain floor: the depth of a step x H x 4 cycles) at the hybrid's S 8 /
     H 50 in float32 and float64 and at S 1; where one hybrid PMC solve's
     time goes (MPPI stage, seed rollout, linearize, sweeps, line search);
 12. the policy networks (models/, no kernel of their own: dense layers on
     cuBLAS, convolutions on cuDNN, at full float32 precision) and the
     policy-evaluation entry point: (a) the card's forward against the
     CPU's, float32: PMCNet with the repo's trained pool checkpoint
     (lifelike_tpu_torch/data/pmc_r5/model_0009660.model, read by the port's
     ModelPool) at B 8 and B 4096, EPMCNet and SEPMCNet with seeded weights
     passed through the port's TLeague import of a seeded flat variable
     list at B 8, 3 recurrent steps with a mask reset and the sampled
     indices / angles injected; mean, logstd, value, z / z_logits, hs (and
     the HLC mean) within 1e-5 x max(1, |x|), the PMC z index equal except
     where the CPU's argmin gap is below 1e-4 (counted); entry.entry()'s
     forward on the card, finite and shaped; (b) bin/run_eval
     on the card, each run with every kernel count set to 0 first: PMC with
     the pool checkpoint on the synthetic clip (one episode of up to
     EVAL_STEPS["pmc"] steps), EPMC on hurdles on the hard-contact plant
     (K5's launches = steps x 10 substeps, no other kernel), SEPMC from a
     random init; reward sums, lengths and ms per control step split into
     policy forward and plant step (CUDA events); (c) forward latency (ms
     p50 over NET_REPS calls after warm-up, CUDA events) and device
     kernels per forward (torch.profiler): PMCNet at B 1 and B 4096,
     EPMCNet at B 1, SEPMCNet at B 2;
 13. the learner (learning/, bin/run_learner; no kernel of its own but K5
     on the hard-contact plant), at full float32 precision (TF32 off
     through forward, backward and optimizer): (a) train steps on the card
     against the CPU at the canonical widths on a fixed rollout made from
     a numpy seed (T 20 x B 256; SEPMC B 64; the actions sampled from the
     net, their behaviour neglogps plus noise): PMCNet from the pool
     checkpoint, EPMCNet with its LLC and prop_rms loaded from it and
     frozen (burn-in 12), SEPMCNet seeded (burn-in 12); one and two steps,
     metrics within 1e-5 x max(1, |x|), each leaf's gradients within 1e-4
     of its max |g|, parameters within 2 x lr x steps + 1e-6 x max(1, |p|),
     frozen leaves bitwise unchanged; for PMC the env columns holding a
     row whose z index differs between card and CPU (only where the CPU's
     argmin gap is below 1e-4) are masked out, and counted; (b)
     bin/run_learner for the three stages in turn at train_scripts'
     widths and configs, depth cut to unroll 20 (burn-in 12 + rollout 8)
     and LEARN_UPDATES updates, each run with every kernel count set to 0
     first: PMC at 256 envs (and one --pmc_replay update), EPMC on hurdles
     at 256 envs from the pool checkpoint with params/llc and
     params/prop_rms frozen, SEPMC at 64 envs from the model the EPMC run
     pushed to its pool (--update_opponent_freq 1), one EPMC update on
     the hard-contact plant (K5 launches = env steps x 10 substeps, every
     other count 0); every loss finite, the frozen leaves bitwise the
     donor's and every trainable leaf moved (or had an all-zero
     gradient), every pool file read back strictly by the port's
     ModelPool; (c) per run: ms per update split into collection and
     optimisation, env steps/s (CUDA events) and
     torch.cuda.max_memory_allocated, beside the card's name and power
     limit;
 14. the task evaluation (tools/make_eval.py; no kernel of its own: K2 under
     the gait bank, K3 / K4 under the gait chase solver) at make_eval's
     widths (population 1024, H 12, sigma 0.12), float32: (a) the prior
     bank of elements 1-3 (walk, jump and the synthesized / distilled
     skill clips; priors with their own TraversalWeights, speed scales and
     gait weights): K2 against its plain version on one solve's
     candidates of each prior at its own inputs, rtol=atol=2e-4, over the
     candidates whose plain cost stays within that of the plain version
     in float64 (contact chaos: the others are counted); then, each run
     with every kernel count set to 0 first, (b) eval_traversal on each
     element, 1 seed, EVAL_STEPS_TRAV control steps: K2 launches = steps
     x 2 priors x 2 MPPI iterations and no other kernel, finite prior
     costs; solve ms p50 / max (CUDA events), plant ms, the prior
     executed at each step, progress and outcome; (c) eval_chase against
     a standing escapee and eval_chase_game, EVAL_STEPS_CHASE steps each:
     K3 = K4 = 2 per step; (d) eval_checkpoints: bin/run_eval on the card
     in a subprocess with the repo's PMC pool checkpoint, one episode of
     EVAL_STEPS_CKPT steps, rc 0 and a finite reward; (e) distill_prior:
     a seeded EPMC flat list rolled EVAL_STEPS_DISTILL steps on the card,
     a window mined, resampled to 120 Hz, written as a clip and read back
     by motion_lib.load_clips; (f) utils.profiling.detect_chip names the
     card (the bounds of phase 11 read the same table's peaks);
 15. the multi-process layer (parallel/{mesh,distributed,sharded_solve}.py,
     scenario_sweep.sharded_scenario_sweep, run_learner's data-parallel
     path; no kernel of its own), in ranks started by
     tools/launch_multihost.py on this card after the kernels are built
     (`--multi-rank CASE DIR` is a rank's command): (a) one NCCL rank (a
     group of one, asked for): the sharded solve through
     make_sharded_solver at the PMC headline shape (population 4096, H 50,
     substeps 10, mass_freeze 10, 1 iteration, float32) against
     mppi_tl.mppi_step under the same normals, 2e-4; K1 launches = 1; (b)
     two gloo ranks sharing the card (NCCL refuses two ranks on one
     device), the same solve at 2 x 2048: the plan bitwise equal on both
     ranks, within 2e-4 of (a)'s, K1 once per rank; ms per solve p50 / max
     of MULTI_SOLVES chained solves per rank (CUDA events; the card
     time-sliced between the ranks: recorded, not gated); (c) the sharded
     sweep at bench_sweep's S 16 x 256, 8 scenario blocks per rank, each
     rank's plans and costs within 2e-4 of the single-process tiled sweep
     under the same per-scenario normals, K3 2 / K4 2 per rank, the
     summary equal on both ranks and within 2e-4 of one process's; (d) the
     sharded hybrid at bench_hybrid's population 1024, H
     HYB_TASK_HORIZON, 1 MPPI and 1 iLQR iteration: K1 1 / K6 1 per
     rank, u_best equal on both ranks, the refined cost <= the best seed's
     + 1e-5; (e) bin/run_learner on two gloo ranks: PMC at phase 13's
     widths (256 envs, 128 per rank) for MULTI_UPDATES updates with a
     checkpoint per update (.r0, .r1, .step written) beside an
     uninterrupted run of MULTI_UPDATES + 1, then the resume to
     MULTI_UPDATES + 1 updates (it starts at update MULTI_UPDATES; that
     update's loss within 1e-5 x max(1, |loss|) of the uninterrupted
     run's, bitwise equality reported) beside one EPMC update (hurdles, from the pool
     checkpoint); every update's metrics equal on both ranks; ms per
     update (collection / optimisation) per rank;
then one JSON line listing the six kernels, the nvidia-smi line, and last
the result line {"ok": true, "device": {...}}. Needs one card; builds the
kernels from the sources in lifelike_tpu_torch/csrc/ with nvcc. Exits
non-zero without a result when no card (or no lifelike_tpu_torch beside
this file) is present.

  python3 chip_smoke.py --learner

runs phase 13 alone and ends with one JSON line of its rows;

  python3 chip_smoke.py --eval

runs phase 14 alone and ends with one JSON line of its rows.

  python3 chip_smoke.py --multi

builds K1, K3, K4 and K6, runs phase 15 alone and ends with one JSON line
of its rows.

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
that closed loop of phases 8-10 and its solve latency; --loop sweep adds
phase 10e's timed rows (both populations; a checkout without
parallel/scenario_sweep.py has none). Ends with one JSON line of the
times.
"""
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

STEPS = 10  # closed-loop control steps of the PMC and EPMC tasks (depth cut to fit)
CHASE_STEPS = 10  # closed-loop control steps of the SEPMC task (depth cut to fit)
POP, HORIZON, SUBSTEPS = 4096, 50, 10  # headline solve shape (bench.py bench_pmc)
CONTACT_K = 8  # boxes per EPMC solve (solver/mpc_tasks.py CONTACT_K)
CHASE_POP = 2048  # candidates per robot (bench.py bench_sepmc: pop // 2)
CHASE_SUBSTEPS = 20  # the chase plant (envs/chase_tag.py ChaseTagConfig)
SWEEP_S = 16  # scenarios of bench.py's bench_sweep
SWEEP_POPS = (256, 1024)  # bench_sweep's populations per robot per scenario (bench.py:606-623)
SWEEP_ROUNDS = 10  # chained sweep rounds timed per population, after 2 warm-up rounds
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
# phase 12: the policy networks and bin/run_eval
POOL_MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)),  # runs/pmc_r5/pool's
                          "lifelike_tpu_torch/data/pmc_r5/model_0009660.model")
NET_TOL, VQ_GAP = 1e-5, 1e-4
NET_B, NET_REPS = 8, 50
EVAL_STEPS = {"pmc": 20, "epmc": 10, "sepmc": 10}  # steps per run_eval episode (depth cut)
# phase 13: the learner at train_scripts' widths, depth cut: unroll 20 =
# the reference's burn_in 12 + rollout_length 8, LEARN_UPDATES updates per
# stage; 256 envs for PMC / EPMC, 64 for SEPMC
LEARN_T, LEARN_BURN_IN, LEARN_B, LEARN_B_SEPMC, LEARN_UPDATES = 20, 12, 256, 64, 2
TRAIN_TOL, GRAD_TOL = 1e-5, 1e-4
# the stage hand-offs: EPMC takes PMC's LLC and prop_rms; SEPMC takes
# EPMC's, with EPMC's policy tower (pi_*) and z head as its frozen MLC (mlc_*)
# phase 14: make_eval's task evaluation at its widths (population 1024, H 12),
# depth cut: 1 seed per element, EVAL_STEPS_TRAV traversal steps,
# EVAL_STEPS_CHASE per chase evaluation, one run_eval episode of
# EVAL_STEPS_CKPT steps, one distill_prior episode of EVAL_STEPS_DISTILL
EVAL_POP, EVAL_H = 1024, 12
EVAL_STEPS_TRAV, EVAL_STEPS_CHASE, EVAL_STEPS_CKPT, EVAL_STEPS_DISTILL = 10, 5, 10, 20
LEARN_HANDOFF = {"epmc": "params/llc,params/prop_rms",
                 "sepmc": ",".join(["params/llc", "params/prop_rms"] + [
                     f"params/mlc_{k}=params/pi_{k}" for k in ("prop_embed", "cmd", "fc", "lstm")]
                     + ["params/z_out=params/z_out"])}
# K6: the MPPI->iLQR hybrid at bench.py bench_hybrid's width (population
# pop // 4 = 1024, H 50, n_refine 7: S = 8 scenarios); its PMC loop runs
# HYB_STEPS control steps, the EPMC and SEPMC hybrid loops HYB_TASK_STEPS at
# horizon HYB_TASK_HORIZON. Depth cut to fit the smoke: one step each since
# phase 14 came in, and 1 iLQR iteration (run_mpc's default is 2) since
# phase 15 did.
HYB_POP, HYB_REFINE, HYB_ITERS, HYB_STEPS = 1024, 7, 1, 1
HYB_TASK_HORIZON, HYB_TASK_STEPS = 5, 1
# phase 15: the multi-process layer on the one card; MULTI_SOLVES chained
# sharded solves timed per rank; run_learner's PMC run checkpoints after
# MULTI_UPDATES updates and resumes to MULTI_UPDATES + 1 (depth cut from 2
# and 3); every launch of ranks is killed after MULTI_TIMEOUT_S, and a
# collective waits that long at most
MULTI_SOLVES, MULTI_SEED, MULTI_TIMEOUT_S, MULTI_UPDATES = 10, 15, 300, 1
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


def report_diff(label, got, want, tol, shifted=None, screen="a 1e-10 m start shift"):
    """Max |kernel - plain| and the count outside rtol = atol = tol; exits
    on a non-finite cost or a disagreement.

    shifted: the plain version's costs under a perturbation named by
    `screen` (by default from a start state shifted by 1e-10 m).
    Candidates whose plain cost itself moves beyond the tolerance under it
    (ill-conditioned: contact chaos amplifies the perturbation, and rounding
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
        note = (f" | {n_ill} ill-conditioned (plain moves > tol under {screen}; "
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
    table, reference rows, opponent trajectory, flag and role, from one
    shared start state and from one start state per block (a scenario
    sweep's call), against the plain version."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda
    from lifelike_tpu_torch.physics import batched as B

    c, params, tl, u, table, rows, opp, flag = chase_kernel_inputs(
        torch.float64, 3, 2, 1, CHASE_POP, 21, gait=True)
    shift = torch.arange(4, dtype=torch.float64, device=u.device)
    tables = torch.stack([table] * 4)
    tables[:, :, 0] += 0.03 * shift[:, None]
    rows = torch.stack([rows * (1.0 + 0.01 * k) for k in range(4)])
    opps = torch.stack([opp.reshape(3, 3) + 0.1 * k for k in range(4)])  # (S, H, 3)
    flags = flag[None] + shift[:, None]
    roles = torch.tensor([True, False, True, False], device=u.device)
    err = 0.0
    per_block = B.map_state(lambda x: torch.cat([x + 0.01 * k for k in range(4)], dim=-2), tl)
    for state, label in ((tl, "one start state"), (per_block, "a start state per block")):
        args = (c, params, state, u, tables, rows, opps, flags, roles)
        got = traversal_cuda.rollout_chase_fused(*args, gait_weight=0.8)
        want = traversal_cuda.rollout_chase_plain(*args, gait_weight=0.8)
        err = max(err, report_diff(f"check K4 f64 S=4: pop {CHASE_POP} H 3 substeps 2, 4 scenario "
                                   f"blocks of {CHASE_POP // 4}, {label}", got, want, tol))
    return err


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


def profiled(fn, reps, whole, attempts=10):
    """torch.profiler's CUDA activity over `reps` calls of fn, as (events,
    is_whole): the device events of key_averages() that ran. On the H100
    the profiler now and then records none or only some of a session's
    kernels, several sessions in a row (none at all in the full smoke's
    phase 11 after K5's plain sweep), so each session, framed by 50 ms of
    idle card, is repeated up to `attempts` times until whole(events)
    holds; else the last session that recorded anything is returned, not
    whole (events None when none did). Each miss is printed with its
    kernel counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    last = None
    for attempt in range(attempts):
        torch.cuda.synchronize()
        time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) > 0.0]
        if whole(events):
            return events, True
        say(f"profiler session {attempt + 1} of {attempts} not whole: "
            + (", ".join(f"{e.key[:48]} x {e.count}" for e in events) or "no kernel record"))
        last = events or last
    return last, False


def queued_ms(fn, reps=20):
    """Device time per call of fn, the calls queued back to back behind a
    spin kernel that outlasts their launch on the host (CUDA events; the
    gaps between kernels included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin = 0.02
    while True:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin * sm_clock_mhz() * 1e6))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        host_s = time.perf_counter() - t0
        e1.synchronize()
        if host_s < spin / 2:
            return e0.elapsed_time(e1) / reps
        spin *= 4


def device_ms(fn, kernel_name, reps=20, whole=None):
    """(ms, how, events): device time per launch of the kernels whose name
    holds `kernel_name`, fn called `reps` times. From torch.profiler's CUDA
    activity, the mean over the launches of the first session that recorded
    one and for which whole(events) holds (by default any), else of the last
    that recorded one; when none did in 10 sessions, from queued_ms (each
    call one launch) and events None."""
    def hits(events):
        return [e for e in events or () if kernel_name in e.key]

    events, _ = profiled(fn, reps, lambda ev: bool(hits(ev)) and (whole is None or whole(ev)))
    if not hits(events):
        return (queued_ms(fn, reps), "device time, CUDA events behind a spin kernel: "
                "torch.profiler recorded no launch in 10 sessions", None)
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
             for e in hits(events))
    return us / 1e3 / sum(e.count for e in hits(events)), "device time, torch.profiler", events


def call_kernels(fn, reps=5):
    """{name: count per call} of the device kernels and copies that calls of
    fn run, from the first of `profiled`'s sessions that recorded any ({}
    when none did)."""
    events, _ = profiled(fn, reps, bool)
    return {e.key: e.count / reps for e in events or ()}


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
        # the plant's tensors go to the kernel as they are: a call launches K5
        # once and allocates its two outputs only; and the profiler, where
        # it records the calls, shows no kernel but K5 (a copy would run on
        # every call, so a session with another kernel is repeated in case
        # that was a stray record)
        k0 = pgs_cuda.pgs_sweep.launches
        a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(5):
            call()
        per_call = ((pgs_cuda.pgs_sweep.launches - k0) / 5,
                    (torch.cuda.memory_stats()["allocation.all.allocated"] - a0) / 5)
        if per_call != (1.0, 2.0):
            raise SystemExit(f"K5 wrapper, {label}: {per_call[0]:g} launches and "
                             f"{per_call[1]:g} allocations per call, expected 1 and 2")
        reps = 20
        kernel_ms, how, events = device_ms(call, "pgs_sweep_kernel", reps, whole=lambda ev: all(
            "pgs_sweep_kernel" in e.key for e in ev))
        ran = {e.key: e.count / reps for e in events or ()}
        if [k for k in ran if "pgs_sweep_kernel" not in k]:
            raise SystemExit(f"K5 wrapper: a call on the plant's tensors ran {ran} per call")
        plain_ms = cuda_ms(lambda: pgs_cuda.pgs_sweep_plain(*system, p.mu, idx, iterations=it),
                           reps=1, warmup=1)
        floor_ms = SWEEP_DEPTH[r] * it * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
        ops = OPS_PER_SWEEP[r] * it * lanes
        # each input read once, each output written once: v, lam0, J, MinvJT,
        # d, b, lo, hi, mu; mu_idx (int32); v and lam out
        nbytes = 4 * lanes * (2 * (18 + r) + 2 * r * 18 + 4 * r + 1) + 4 * r
        bound_ms, by, ops_ms, bytes_ms = bound(ops, nbytes)
        say(f"timing K5 f32 {label}, {it} iterations: kernel {kernel_ms:.4f} ms ({how}) | "
            f"wrapper call {wrapper_ms:.4f} ms (CUDA events) | plain "
            f"{plain_ms:.1f} ms | bound {bound_ms:.6f} ms ({ops:.4e} ops / 67 TFLOP/s = "
            f"{ops_ms:.6f} ms; {nbytes} B / 3.35 TB/s = {bytes_ms:.6f} ms, bound by {by}) | "
            f"kernel at {100 * bound_ms / kernel_ms:.4f}% of bound | chain floor "
            f"{SWEEP_DEPTH[r]} levels x {it} iterations x {CHAIN_CYCLES} cycles = {floor_ms:.4f} ms, "
            f"kernel {kernel_ms / floor_ms:.2f}x | library: none")
        say(f"timing K5 wrapper call, {label}: 1 launch and 2 allocations (the outputs) per call; "
            f"device work per call {ran or 'not recorded by torch.profiler'} (no copy kernel)")
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
    """Phase 11 for K6: device time (device_ms), the wrapper call, the
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
        kernel_ms, how, _ = device_ms(call, "riccati_sweep_kernel")
        plain_ms = cuda_ms(lambda: riccati_cuda.riccati_sweep_plain(*args, reg=1e-3), reps=1)
        ops = RICCATI_OPS_PER_STEP * S * HORIZON
        nbytes = RICCATI_BYTES_PER_STEP * S * HORIZON * (dtype.itemsize // 4)
        spec = peaks()
        peak = spec.peak_flops_f32 if dtype == torch.float32 else spec.peak_flops_f64
        ops_ms, bytes_ms = 1e3 * ops / peak, 1e3 * nbytes / spec.hbm_bytes_per_s
        bound_ms, by = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
        name = str(dtype).replace("torch.", "")
        floor_ms = RICCATI_DEPTH_PER_STEP * HORIZON * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
        say(f"chain floor K6 {name} S {S}: {RICCATI_DEPTH_PER_STEP} levels x H {HORIZON} x "
            f"{CHAIN_CYCLES} cycles = {floor_ms:.4f} ms | kernel {kernel_ms:.4f} ms, "
            f"{kernel_ms / floor_ms:.2f}x the floor")
        say(f"timing K6 {name} S {S} H {HORIZON}: kernel {kernel_ms:.4f} ms ({how}) | "
            f"wrapper call {wrapper_ms:.4f} ms (CUDA events) | plain "
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
    # a one-step run has no step after the warm-up: its one time is reported
    after = "after warm-up" if steps > 1 else "of the one step, warm-up included"
    t_ms = [1e3 * t for t in out["t_solve"][1:] or out["t_solve"]]
    extra = ""
    if task == "epmc":
        extra = (f" | fall at steps {[i for i, f in enumerate(out['falls']) if f]}, reached at "
                 f"steps {[i for i, r in enumerate(out['reached']) if r]}")
        p_ms = [1e3 * t for t in out["t_plant"][1:] or out["t_plant"]]
        extra += (f" | plant step {after} p50 {statistics.median(p_ms):.3f} ms max "
                  f"{max(p_ms):.3f} ms")
    if task == "sepmc":
        extra = f" | games {out['games']}, final distance {out['final_dist']:.3f} m"
    if hybrid:
        extra += f" | refined cost per step {out['refined_cost']} | seed costs {out['seed_costs']}"
    say(f"{log_prefix}: {len(rewards)} steps, episode ends at {out['episode_ends']}{extra}, "
        f"solve latency {after} p50 {statistics.median(t_ms):.3f} ms max {max(t_ms):.3f} ms "
        f"(CUDA events) | kernel launches {launches}")
    if len(rewards) != steps or not all(math.isfinite(r) for r in flat):
        raise SystemExit(f"{log_prefix}: missing or non-finite rewards")
    return out, launches


def sweep_inputs(pop, n_scen=SWEEP_S, horizon=HORIZON, device="cuda", seed=11):
    """(constants, plant, MPPI config, scenarios) of bench.py's bench_sweep:
    n_scen arenas with random cubes, float32, kd 1, max_tau 16, substeps 10,
    mass_freeze 10, sigma 0.15, one iteration, `pop` per robot per
    scenario."""
    import torch

    from lifelike_tpu_torch.parallel import scenario_sweep
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics import engine
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.scene import arena_gen
    from lifelike_tpu_torch.solver.mppi import MPPIConfig

    c = B.tl_constants(build_max_model(), dtype=torch.float32, device=torch.device(device))
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=SUBSTEPS, mass_freeze=SUBSTEPS)
    cfg = MPPIConfig(horizon=horizon, population=pop, iterations=1, sigma=0.15)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scen = scenario_sweep.generate_scenarios(gen, n_scen, arena_gen.ArenaConfig(rand_cube=True),
                                             torch.float32, device=device)
    return c, params, cfg, scen, gen


def time_sweep(pop, launches_of=(), rounds=SWEEP_ROUNDS):
    """bench_sweep's row at `pop`: `rounds` chained sweep rounds (1 best-
    response round, warm-started from the previous round's plans, as
    bench_sweep chains them) after 2 warm-up rounds, each timed with CUDA
    events; every kernel count of launches_of set to 0 before the timed
    rounds and read after. Returns {name, p50_ms, max_ms, launches, busy}:
    busy is the device-busy share of one round (torch.profiler's device
    time over the round's unprofiled time)."""
    import torch
    from torch.autograd import DeviceType

    from lifelike_tpu_torch.parallel import scenario_sweep

    c, params, cfg, scen, gen = sweep_inputs(pop)

    def round_(u):
        return scenario_sweep.sweep_scenarios_tiled(c, params, cfg, gen, scen, u_warm=u)

    u = None
    for _ in range(2):
        u, cost = round_(u)
    torch.cuda.synchronize()
    for k in launches_of:
        k.launches = 0
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        u, cost = round_(u)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    launches = [k.launches for k in launches_of]
    if not bool(torch.isfinite(cost).all()) or not bool(torch.isfinite(u).all()):
        raise SystemExit(f"sweep pop {pop}: non-finite costs or plans")
    state, marks = {"u": u}, []

    def profiled_round():
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state["u"], state["cost"] = round_(state["u"])
        e1.record()
        marks.append((e0, e1))

    symbols = (("K3", "rollout_plan_kernel"), ("K4", "rollout_chase_kernel"))
    per_round = sum(launches) / rounds
    events, is_whole = profiled(profiled_round, 1, lambda ev: sum(
        e.count for e in ev for _, sym in symbols if sym in e.key) == per_round)
    u, cost = state["u"], state["cost"]
    if not is_whole:
        dev_ms = prof_ms = float("nan")
        profiled_line = "not measured (torch.profiler recorded no whole round)"
    else:
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
        prof_ms = marks[-1][0].elapsed_time(marks[-1][1])
        kernels = {}
        for key, symbol in symbols:
            hits = [e for e in dev if symbol in e.key]
            n = sum(e.count for e in hits)
            kernels[key] = (n, sum(e.self_device_time_total for e in hits) / 1e3 / max(n, 1))
        other_ms = dev_ms - sum(n * ms for n, ms in kernels.values())
        profiled_line = (f"device time (torch.profiler) {dev_ms:.3f} ms of {prof_ms:.3f} ms (CUDA "
                         f"events), busy share {dev_ms / prof_ms:.4f}: "
                         + ", ".join(f"{k} {n} x {ms:.3f} ms" for k, (n, ms) in kernels.items())
                         + f", other kernels {other_ms:.3f} ms")
    p50 = statistics.median(times)
    name = f"sepmc_sweep_latency_s{SWEEP_S}_pop{pop}_H{cfg.horizon}"
    say(f"sweep {name}: {rounds} chained rounds after 2 warm-up (CUDA events) p50 {p50:.3f} ms "
        f"max {max(times):.3f} ms ({', '.join(f'{t:.3f}' for t in times)}) | kernel launches "
        f"{launches} in {rounds} rounds | one profiled round: {profiled_line} | best cost mean "
        f"{float(cost.mean()):.4f} min {float(cost.min()):.4f}")
    return dict(name=name, p50_ms=p50, max_ms=max(times), launches=launches,
                busy=dev_ms / prof_ms)


def check_sweep():
    """Phase 10e's gates: (a) the tiled sweep at S SWEEP_S x 256 equals its
    oracle sweep_scenarios (one scenario per K3 / K4 launch) under the same
    normals at K4's 2e-4; (b) at a cut depth (S 4, population 64, H 5) the
    sweep on the kernels matches the sweep on the plain versions (CPU
    tensors) at the reference's kernel-vs-XLA sweep tolerances (cost
    rtol = atol = 5e-3, plans rtol 5e-2 / atol 5e-3,
    tests/test_scenario_sweep.py:150-153); (c) finite costs throughout."""
    import torch

    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.parallel import scenario_sweep

    c, params, cfg, scen, gen = sweep_inputs(SWEEP_POPS[0])
    eps = scenario_sweep.draw_noise(gen, cfg, SWEEP_S, 1, torch.float32, "cuda")
    tc.rollout_plan_fused.launches = tc.rollout_chase_fused.launches = 0
    u, cost = scenario_sweep.sweep_scenarios_tiled(c, params, cfg, None, scen, eps=eps)
    u_o, cost_o = scenario_sweep.sweep_scenarios(c, params, cfg, None, scen, eps=eps)
    torch.cuda.synchronize()
    say(f"check sweep oracle: K3 / K4 launches {tc.rollout_plan_fused.launches} / "
        f"{tc.rollout_chase_fused.launches} (tiled 2 / 2, oracle {2 * SWEEP_S} / {2 * SWEEP_S})")
    if (tc.rollout_plan_fused.launches, tc.rollout_chase_fused.launches) != (2 + 2 * SWEEP_S,) * 2:
        raise SystemExit("sweep: launches of the tiled sweep or its oracle are not as expected")
    err = max(report_diff(f"check sweep (a) tiled vs oracle S {SWEEP_S} pop {cfg.population} H "
                          f"{cfg.horizon} f32 best cost", cost, cost_o, 2e-4),
              report_diff("check sweep (a) tiled vs oracle plans", u, u_o, 2e-4))

    S, pop, H = 4, 64, 5
    c, params, cfg, scen, gen = sweep_inputs(pop, n_scen=S, horizon=H)
    eps = scenario_sweep.draw_noise(gen, cfg, S, 1, torch.float32, "cuda")
    u, cost = scenario_sweep.sweep_scenarios_tiled(c, params, cfg, None, scen, eps=eps)
    cpu = torch.device("cpu")
    scen_cpu = type(scen)(*(type(x)(*(y.to(cpu) for y in x)) if isinstance(x, tuple)
                            else x.to(cpu) for x in scen))
    c_cpu = type(c)(*(x.to(cpu) if torch.is_tensor(x) else x for x in c))
    u_p, cost_p = scenario_sweep.sweep_scenarios_tiled(
        c_cpu, params, cfg, None, scen_cpu, eps=[[e.to(cpu) for e in r] for r in eps],
        device="cpu")
    for label, got, want, rtol, atol in (("best cost", cost, cost_p, 5e-3, 5e-3),
                                         ("plans", u, u_p, 5e-2, 5e-3)):
        got = got.cpu()
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"sweep (b) {label}: non-finite")
        d = (got - want).abs()
        bad = int((d > atol + rtol * want.abs()).sum())
        say(f"check sweep (b) kernels vs plain versions S {S} pop {pop} H {H} f32 {label}: "
            f"max|diff| {float(d.max()):.3e} (rtol {rtol:g} atol {atol:g}, {bad} outside)")
        if bad:
            raise SystemExit(f"sweep (b) {label}: the kernels' sweep disagrees with the plain one")
    return err


def check_clip_parser():
    """Phase 10f: the C++ clip parser (lifelike_tpu_torch/_native) built with
    g++ on this machine; load_clips reads a synthetic clip file through it,
    frames equal to the json module's."""
    import json
    import os
    import tempfile

    import numpy as np

    from lifelike_tpu_torch import _native
    from lifelike_tpu_torch.motion import motion_lib

    frames = motion_lib.make_synthetic_clip(600)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "synthetic_ret.txt")
        with open(path, "w") as f:
            json.dump({"FrameDuration": 1.0 / 120.0, "LegOrder": ["FR", "FL", "HR", "HL"],
                       "Frames": frames.tolist()}, f)
        t0 = time.perf_counter()
        lib = _native.load_library()
        t_build = time.perf_counter() - t0
        clips = motion_lib.load_clips(path, device="cuda")
        with open(path) as f:
            want = np.asarray(json.load(f)["Frames"], np.float32)
    if lib is None or motion_lib.load_clips.parsed_by != ["native"]:
        raise SystemExit(f"clip parser: the native path did not parse the clip "
                         f"({motion_lib.load_clips.parsed_by}, library {lib})")
    got = clips.frames[0].cpu().numpy()
    if not np.array_equal(got, want):
        raise SystemExit("clip parser: frames differ from the json module's")
    say(f"clip parser: {_native.library_path()} built and loaded in {t_build:.2f} s; "
        f"load_clips parsed_by {motion_lib.load_clips.parsed_by}, {got.shape[0]} frames equal "
        f"to the json module's")


def net_err(label, got, want, rows=None):
    """max |got - want| / max(1, |want|) of a card output against the CPU's
    (over `rows` when given); exits above NET_TOL."""
    import torch

    g, w = got.detach().cpu().double(), want.detach().double()
    if rows is not None:
        g, w = g[rows], w[rows]
    err = float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) if w.numel() else 0.0
    if not err <= NET_TOL:
        raise SystemExit(f"{label}: card vs CPU {err:.3e} > {NET_TOL:g} x max(1, |x|)")
    return err


def seeded_flat_list(paths, template, seed):
    """A seeded stand-in for a reference checkpoint's flat variable list
    (TF shapes): kernels N(0, 1 / fan_in), positive rms std, unit-ish
    layer-norm gains, small biases."""
    import numpy as np

    from lifelike_tpu_torch.compat import tleague_import

    rng = np.random.default_rng(seed)
    out = []
    for path, shape in zip(paths, tleague_import.flat_shapes(paths, template)):
        name = path[-1]
        if name == "moving_std":
            a = 0.5 + rng.uniform(size=shape)
        elif name in ("kernel", "wx", "wh"):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("logstd", "hlc_logvar"):
            a = -1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.3 * rng.standard_normal(shape)
        out.append(a.astype(np.float32))
    return out


def net_obs(kind, b, seed):
    """Seeded observations of a level's policy at batch b (CPU, float32)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn((b,) + shape, generator=g)
    u = lambda hi, *shape: hi * torch.rand((b,) + shape, generator=g)
    if kind == "pmc":
        return n(99), n(36), n(72)
    obs = dict(prop=n(99), prop_a=n(36), percep_2d=u(0.6, 25, 13), percep_1d=u(3.0, 128),
               percep_front=u(0.6, 25, 13))
    if kind == "epmc":
        return dict(obs, target=n(3))
    obs = {k.replace("percep_", "percept_"): v for k, v in obs.items()}
    for k, w in (("percept_vec", 5), ("oppo_info", 15), ("oppo_info_cheat", 15),
                 ("flag_info", 7), ("flag_info_cheat", 7), ("with_flag", 2)):
        obs[k] = n(w)
    return dict(obs, control_spd=0.5 + u(2.5, 1))


def vq_gap(net, prop, prop_a, future):
    """Distance between the nearest and the second-nearest codebook rows of
    each PMC latent (the margin of the VQ argmin)."""
    import torch

    with torch.no_grad():
        prop_rms, _ = net.prop_rms(net._prop_in(prop, prop_a))
        fut, _ = net.future_rms(future)
        z = net.z_out(net.encoder(torch.cat([prop_rms, fut], dim=-1)))
        cb = net.llc.embedding
        d = (z ** 2).sum(-1, keepdim=True) - 2.0 * z @ cb + (cb ** 2).sum(0)
        two = torch.topk(d, 2, dim=-1, largest=False).values
    return two[..., 1] - two[..., 0]


def check_networks():
    """Phase 12a: each policy network's forward on the card against the
    CPU's, float32. Returns the three nets on the card (for 12c)."""
    import copy

    import torch

    from lifelike_tpu_torch.compat import tleague_import
    from lifelike_tpu_torch.learning import registry
    from lifelike_tpu_torch.models import epmc, params, pmc, sepmc

    cpu = pmc.load_params(pmc.PMCNet(), registry.ModelPool().load_file("pool", POOL_MODEL))
    card = {"pmc": copy.deepcopy(cpu).cuda()}
    for b in (8, 4096):
        obs = net_obs("pmc", b, seed=b)
        with torch.no_grad():
            want = cpu(*obs)
            got = card["pmc"](*(x.cuda() for x in obs))
        same = got.z_idx.cpu() == want.z_idx
        gap = vq_gap(cpu, *obs)
        if bool((gap[~same] >= VQ_GAP).any()):
            raise SystemExit(f"PMCNet B {b}: z index differs where the CPU's argmin gap is "
                             f"{float(gap[~same].max()):.3e} >= {VQ_GAP:g}")
        errs = {k: net_err(f"PMCNet B {b} {k}", getattr(got, k), getattr(want, k), same)
                for k in ("mean", "logstd", "z")}
        errs["value"] = net_err(f"PMCNet B {b} value", got.value, want.value)
        say(f"check PMCNet pool checkpoint B {b}: z index equal on {int(same.sum())} of {b} "
            f"rows ({b - int(same.sum())} differ, all with a CPU argmin gap < {VQ_GAP:g}; "
            f"{int((gap < VQ_GAP).sum())} rows have such a gap) | max err / max(1, |x|): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    for kind, cls, paths, importer, load in (
            ("epmc", epmc.EPMCNet, tleague_import.EPMC_PATHS, tleague_import.import_epmc,
             epmc.load_params),
            ("sepmc", sepmc.SEPMCNet, tleague_import.SEPMC_PATHS, tleague_import.import_sepmc,
             sepmc.load_params)):
        template = params.flax_tree(cls())
        tree = importer(seeded_flat_list(paths, template, seed=len(paths)))
        cpu = load(cls(), tree)
        card[kind] = copy.deepcopy(cpu).cuda()
        b, g = NET_B, torch.Generator().manual_seed(len(paths))
        hs_cpu = 0.5 * torch.randn((b, cpu.cfg.hs_len), generator=g)
        hs_card = hs_cpu.cuda()
        fields = ["mean", "logstd", "value", "z_logits", "hs"] + (["hlc_mean"] if kind == "sepmc"
                                                                  else [])
        errs = dict.fromkeys(fields, 0.0)
        for step in range(3):
            obs = net_obs(kind, b, seed=100 * len(paths) + step)
            mask = torch.zeros(b)
            if step == 1:
                mask[0] = 1.0  # robot 0's episode restarts
            z_idx = torch.randint(0, 256, (b,), generator=g)
            acts = ((z_idx,) if kind == "epmc"
                    else (torch.rand((b, 1), generator=g) * 6.2 - 3.1, z_idx))
            with torch.no_grad():
                want = cpu(obs, hs_cpu, mask, *acts)
                got = card[kind]({k: v.cuda() for k, v in obs.items()}, hs_card, mask.cuda(),
                                 *(a.cuda() for a in acts))
            for k in fields:
                errs[k] = max(errs[k], net_err(f"{type(cpu).__name__} step {step} {k}",
                                               getattr(got, k), getattr(want, k)))
            hs_cpu, hs_card = want.hs, got.hs
        say(f"check {type(cpu).__name__} (seeded flat list through the TLeague import) B {b}, 3 "
            f"steps, mask reset at step 1, indices injected | max err / max(1, |x|): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    from lifelike_tpu_torch import entry

    fn, args = entry.entry()
    mean, value = fn(*args)
    if (mean.shape, value.shape) != ((entry.B, 12), (entry.B, 1)) or not (
            bool(torch.isfinite(mean).all()) and bool(torch.isfinite(value).all())):
        raise SystemExit(f"entry(): mean {tuple(mean.shape)}, value {tuple(value.shape)}")
    say(f"entry(): the PMCNet forward at B {entry.B} on {mean.device}: mean "
        f"{tuple(mean.shape)}, value {tuple(value.shape)}, finite")
    return card


def run_evals(launches_of):
    """Phase 12b: bin/run_eval for the three levels on the card, each with
    every kernel count set to 0 first."""
    import statistics as st

    from lifelike_tpu_torch.bin import run_eval

    runs = {"pmc": [f"--model_path={POOL_MODEL}", "--clip=synthetic"],
            "epmc": ["--env_config={'hard_contact': True, "
                     "'env_randomize_config': {'element_id': 1}}"],
            "sepmc": []}
    for task, flags in runs.items():
        for k in launches_of:
            k.launches = 0
        out = run_eval.main([f"--task={task}", "--device=cuda", "--episodes=1", "--seed=0",
                             f"--max_steps={EVAL_STEPS[task]}"] + flags,
                            log=lambda m: say(f"run_eval {task}: " + m))
        launches = [k.launches for k in launches_of]
        n = sum(out["episode_lengths"])
        flat = [x for r in out["step_rewards"] for x in (r if isinstance(r, list) else [r])]
        if not all(math.isfinite(x) for x in flat + out["max_abs_action"]):
            raise SystemExit(f"run_eval {task}: non-finite rewards or actions")
        want = [0] * len(launches_of)
        if task == "epmc":
            want[4] = n * IMPULSE_SUBSTEPS  # K5: the hard-contact plant's sweeps
        if launches != want:
            raise SystemExit(f"run_eval {task}: kernel launches (K1-K6) {launches}, expected "
                             f"{want}")
        fwd, plant = out["fwd_ms"][1:] or out["fwd_ms"], out["step_ms"][1:] or out["step_ms"]
        say(f"run_eval {task} on the card: {n} steps, reward sums {out['episode_rewards']}, "
            f"lengths {out['episode_lengths']} | ms per control step after the first (CUDA "
            f"events): policy forward p50 {st.median(fwd):.3f} max {max(fwd):.3f}, plant step "
            f"p50 {st.median(plant):.3f} max {max(plant):.3f} | kernel launches (K1-K6) "
            f"{launches}")


def time_networks(card):
    """Phase 12c: forward latency of each policy on the card (ms p50 over
    NET_REPS calls after warm-up) and its device kernels per forward."""
    import torch

    cases = [("PMCNet", "pmc", 1), ("PMCNet", "pmc", 4096), ("EPMCNet", "epmc", 1),
             ("SEPMCNet", "sepmc", 2)]
    for name, kind, b in cases:
        net = card[kind]
        obs = net_obs(kind, b, seed=7)
        if kind == "pmc":
            args = tuple(x.cuda() for x in obs)
        else:
            hs = torch.zeros((b, net.cfg.hs_len), device="cuda")
            args = ({k: v.cuda() for k, v in obs.items()}, hs, torch.zeros(b, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        kw = {} if kind == "pmc" else {"generator": gen}

        def fwd():
            with torch.no_grad():
                return net(*args, **kw)

        for _ in range(5):
            fwd()
        ms = []
        for _ in range(NET_REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fwd()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        kernels = call_kernels(fwd)
        count = f"{sum(kernels.values()):g}" if kernels else "not recorded by torch.profiler:"
        say(f"forward {name} B {b}: p50 {statistics.median(ms):.4f} ms, min {min(ms):.4f}, max "
            f"{max(ms):.4f} over {NET_REPS} calls (CUDA events) | {count} "
            f"device kernels / copies per forward")


def learn_rollout(kind, net, T, B, seed):
    """Phase 13a's fixed (T, B) rollout, float32 on the CPU: seeded numpy
    observations (and start hidden state, episode resets, rewards, ends);
    the actions sampled from `net` with a seeded generator; the behaviour
    neglogps of those actions plus N(0, 0.1) noise, so the PPO ratios sit
    around the clip."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.learning import learner, recurrent
    from lifelike_tpu_torch.models import layers

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    n = lambda *s: f32(rng.standard_normal((T, B) + s))
    u = lambda hi, *s: f32(hi * rng.uniform(size=(T, B) + s))
    reward = u(1.0) if kind == "pmc" else f32(rng.choice([-1.0, 0.0, 0.1, 1.0], (T, B)))
    discount = f32(0.95 * (rng.uniform(size=(T, B)) >= 0.05))
    noise = 0.1 * n()
    if kind == "pmc":
        prop, prop_a, future = n(99), n(36), n(72)
        with torch.no_grad():
            out = net(prop, prop_a, future)
            action = layers.gaussian_sample(g, out.mean, out.logstd)
            nlp = layers.gaussian_neglogp(out.mean, out.logstd, action)
        return learner.Rollout(prop=prop, prop_a=prop_a, future=future, action=action,
                               neglogp=nlp + noise, reward=reward, discount=discount)
    obs = dict(prop=n(99), prop_a=n(36), percep_2d=u(0.6, 25, 13), percep_1d=u(3.0, 128),
               percep_front=u(0.6, 25, 13))
    if kind == "epmc":
        obs["target"] = n(3)
    else:
        obs = {k.replace("percep_", "percept_"): v for k, v in obs.items()}
        for k, w in (("percept_vec", 5), ("oppo_info", 15), ("oppo_info_cheat", 15),
                     ("flag_info", 7), ("flag_info_cheat", 7), ("with_flag", 2)):
            obs[k] = n(w)
        obs["control_spd"] = 0.5 + u(2.5, 1)
    mask = f32(rng.uniform(size=(T, B)) < 0.05)
    hs = 0.5 * n(net.cfg.hs_len)[0]
    steps = []
    with torch.no_grad():
        for t in range(T):
            out = net({k: v[t] for k, v in obs.items()}, hs, mask[t], generator=g)
            a_llc = layers.gaussian_sample(g, out.mean, out.logstd)
            nlp = (layers.categorical_neglogp(out.z_logits, out.z_idx)
                   + layers.gaussian_neglogp(out.mean, out.logstd, a_llc))
            if kind == "sepmc":
                nlp = nlp + layers.gaussian_neglogp(out.hlc_mean, out.hlc_logstd, out.hlc_angle)
            steps.append((out.z_idx, a_llc, out.hlc_angle if kind == "sepmc"
                          else torch.zeros(B, 1), nlp, hs))
            hs = out.hs
    a_z, a_llc, a_hlc, nlp, hss = (torch.stack(x) for x in zip(*steps))
    return recurrent.RecurrentRollout(obs=obs, a_z=a_z, a_llc=a_llc, a_hlc=a_hlc,
                                      neglogp=nlp + noise, reward=reward, discount=discount,
                                      mask=mask, hs=hss)


def vq_flips(cpu, card, roll):
    """(T, B) rows whose PMC z index differs between the card's forward and
    the CPU's on the rollout; exits where such a row's CPU argmin gap is not
    below VQ_GAP."""
    import torch

    with torch.no_grad():
        z_cpu = cpu(roll.prop, roll.prop_a, roll.future).z_idx
        z_card = card(*(x.cuda() for x in (roll.prop, roll.prop_a, roll.future))).z_idx.cpu()
    flips = z_cpu != z_card
    if bool(flips.any()):
        gap = vq_gap(cpu, roll.prop, roll.prop_a, roll.future)
        if bool((gap[flips] >= VQ_GAP).any()):
            raise SystemExit(f"PMCNet train step: z index differs where the CPU's argmin gap is "
                             f"{float(gap[flips].max()):.3e} >= {VQ_GAP:g}")
    return flips


def check_train_steps():
    """Phase 13a: one and two train steps on the card against the CPU at the
    canonical widths, float32, each side at full float32 precision (TF32 off
    through the backward): PMCNet from the pool checkpoint, EPMCNet with its
    LLC and prop_rms loaded from it and frozen, SEPMCNet seeded."""
    import copy

    import torch

    from lifelike_tpu_torch.learning import freeze, learner, recurrent, registry
    from lifelike_tpu_torch.learning import replay as rp
    from lifelike_tpu_torch.models import epmc, pmc, sepmc

    pool_tree = registry.ModelPool().load_file("pool", POOL_MODEL)
    handoff = [("params", "llc"), ("params", "prop_rms")]
    pmc_net = pmc.load_params(pmc.PMCNet(), pool_tree)
    epmc_net = freeze.load_subtree(epmc.EPMCNet(generator=torch.Generator().manual_seed(2)),
                                   pool_tree, handoff)
    sepmc_net = sepmc.SEPMCNet(generator=torch.Generator().manual_seed(3))
    cases = [("PMCNet", pmc_net, (), learner.train_step, {}, LEARN_B),
             ("EPMCNet", epmc_net, handoff, recurrent.epmc_train_step, {"burn_in": LEARN_BURN_IN},
              LEARN_B),
             ("SEPMCNet", sepmc_net, (), recurrent.sepmc_train_step,
              {"burn_in": LEARN_BURN_IN}, LEARN_B_SEPMC)]
    cfg = learner.PPOConfig()
    for i, (name, cpu, frozen, step, kw, B) in enumerate(cases):
        kind = name[:-3].lower()
        roll = learn_rollout(kind, cpu, LEARN_T, B, seed=10 + i)
        card = copy.deepcopy(cpu).cuda()
        opt_cpu = learner.make_optimizer(cfg, cpu, frozen)
        opt_card = learner.make_optimizer(cfg, card, frozen)
        frozen0 = {k: p.detach().clone() for k, p in cpu.named_parameters()
                   if k not in opt_cpu.names}
        err = {"metrics": 0.0, "grads": 0.0, "params": 0.0}
        dropped, ms = [], []
        for s in (1, 2):
            r = roll
            if kind == "pmc":  # mask out the env columns with a VQ near-tie flip
                keep = ~vq_flips(cpu, card, roll).any(0)
                dropped.append(int((~keep).sum()))
                r = rp.tree_map(lambda x: x[:, keep], roll)
            r_card = rp.tree_map(lambda x: x.cuda(), r)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            m_card = step(card, opt_card, cfg, r_card, **kw)
            e1.record()
            m_cpu = step(cpu, opt_cpu, cfg, r, **kw)
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            for k, v in m_cpu.items():
                e = abs(float(m_card[k]) - float(v)) / max(1.0, abs(float(v)))
                if not e <= TRAIN_TOL:
                    raise SystemExit(f"{name} train step {s}: {k} card {float(m_card[k])!r} vs "
                                     f"CPU {float(v)!r} > {TRAIN_TOL:g} x max(1, |x|)")
                err["metrics"] = max(err["metrics"], e)
            for k, gc, gd in zip(opt_cpu.names, opt_cpu.views(opt_cpu.flat_grad()),
                                 opt_card.views(opt_card.flat_grad())):
                scale = float(gc.abs().max())
                e = float((gd.cpu() - gc).abs().max())
                if not e <= GRAD_TOL * scale:
                    raise SystemExit(f"{name} train step {s}: gradient of {k} off by {e:.3e} > "
                                     f"{GRAD_TOL:g} x its max |g| {scale:.3e}")
                err["grads"] = max(err["grads"], e / scale if scale else 0.0)
            for (k, pc), (_, pd) in zip(cpu.named_parameters(), card.named_parameters()):
                d = (pd.detach().cpu() - pc.detach()).abs()
                limit = 2 * cfg.learning_rate * s + 1e-6 * pc.detach().abs().clamp_min(1.0)
                if bool((d > limit).any()):
                    raise SystemExit(f"{name} train step {s}: parameter {k} off by "
                                     f"{float(d.max()):.3e} > 2 x lr x steps + 1e-6 x max(1, |p|)")
                err["params"] = max(err["params"], float((d / limit).max()))
        for k, p0 in frozen0.items():
            if not (torch.equal(dict(cpu.named_parameters())[k].detach(), p0)
                    and torch.equal(dict(card.named_parameters())[k].detach().cpu(), p0)):
                raise SystemExit(f"{name}: frozen parameter {k} changed")
        burn = f", burn-in {LEARN_BURN_IN}" if kw else ""
        say(f"check train step {name} (T {LEARN_T} x B {B}{burn}, {len(opt_cpu.names)} trainable "
            f"/ {len(frozen0)} frozen tensors): card vs CPU over 2 "
            f"steps | metrics max err / max(1, |x|) {err['metrics']:.3e} (gate {TRAIN_TOL:g}), "
            f"gradients max err / leaf max |g| {err['grads']:.3e} (gate {GRAD_TOL:g}), parameters "
            f"max err / (2 lr steps + 1e-6 max(1, |p|)) {err['params']:.3e}"
            + (f" | env columns masked for a VQ near-tie flip: {dropped}" if kind == "pmc" else "")
            + f" | card step ms {', '.join(f'{x:.1f}' for x in ms)} (CUDA events)")


def _learner_flags(d):
    """run_learner's flags for phase 13b's runs at train_scripts' widths and
    configs (unroll_length LEARN_T = burn_in 12 + rollout_length 8)."""
    lrn = "'learning_rate': 1e-5, 'gamma': 0.95, 'lam': 0.95, 'unroll_length': %d" % LEARN_T
    push = ("'disturb_force_config': {'start_time': 0.5, 'interval_time': 1.0, "
            "'duration_time': 0.2, 'horizontal_force': [0, 50], 'vertical_force': [0, 10]}")
    pmc_flags = [
        "--env_config={'data_path': 'synthetic', 'control_freq': 50.0, 'kp': 50.0, 'kd': 0.5, "
        "'max_tau': 18, 'reward_weights': {'joint_pos': 0.3, 'joint_vel': 0.05, "
        "'end_effector': 0.1, 'root_pose': 0.5, 'root_vel': 0.05}}",
        "--policy_config={'z_len': 32, 'num_embeddings': 256, 'bot_neck_z_embed_size': 32, "
        "'bot_neck_prop_embed_size': 64}",
        f"--num_envs={LEARN_B}"]
    pmc_lrn = (lrn + ", 'vf_coef': 1.0, 'ent_coef': 0.0, 'q_latent_coef': 1.0, "
               "'e_latent_coef': 0.25, 'rms_loss_coef': 1.0, 'max_grad_norm': 0.5")

    def epmc_flags(hard):
        return ["--env_config={'control_freq': 50.0, 'kp': 50.0, 'kd': 1.0, 'max_tau': 16, "
                f"'hard_contact': {hard}, 'env_randomize_config': {{'element_id': 1, "
                "'friction_range': [0.4, 3.0], 'target_spd_range': [0.5, 3.0], "
                f"'cmd_vary_freq_range': [25, 200], {push}}}}}",
                f"--learner_config={{{lrn}}}", f"--num_envs={LEARN_B}",
                f"--init_model={POOL_MODEL}", f"--init_model_subtree={LEARN_HANDOFF['epmc']}"]

    return {
        "pmc": pmc_flags + [f"--learner_config={{{pmc_lrn}}}", f"--model_pool_dir={d}/pool_pmc"],
        "pmc replay": pmc_flags + [
            "--pmc_replay", f"--learner_config={{{pmc_lrn}, 'rollout_length': 10, "
            "'replay_size': 1024, 'batch_windows': 256}", "--total_updates=1"],
        "epmc": epmc_flags(False) + [f"--model_pool_dir={d}/pool_epmc"],
        "sepmc": [
            "--env_config={'control_freq': 50.0, 'kp': 50.0, 'kd': 1.0, 'max_tau': 16, "
            "'max_steps': 1000, 'env_randomize_config': {'friction_range': [0.4, 3.0], "
            f"'control_spd_range': [1.0, 3.0], {push}}}}}",
            f"--learner_config={{{lrn}}}", f"--num_envs={LEARN_B_SEPMC}",
            f"--init_model={d}/pool_epmc/model_{LEARN_UPDATES - 1:07d}.model",
            f"--init_model_subtree={LEARN_HANDOFF['sepmc']}", "--update_opponent_freq=1",
            f"--model_pool_dir={d}/pool_sepmc", f"--checkpoint_dir={d}/league_sepmc"],
        "epmc hard-contact": epmc_flags(True) + ["--total_updates=1"],
    }


def check_handoff(name, out, flags):
    """Frozen parameters bitwise the donor's; every trainable one moved from
    run_learner's initial value unless its last gradient is all zero.
    Returns (frozen, moved, zero-gradient) tensor counts."""
    import torch

    from lifelike_tpu_torch.bin import run_learner
    from lifelike_tpu_torch.learning import freeze, registry
    from lifelike_tpu_torch.models import epmc, sepmc

    net, opt = out["net"], out["optimizer"]
    arg = dict(f[2:].split("=", 1) for f in flags if f.startswith("--init_"))
    donor = registry.ModelPool().load_file("donor", arg["init_model"])
    init = (epmc.EPMCNet if isinstance(net, epmc.EPMCNet) else sepmc.SEPMCNet)(
        generator=torch.Generator().manual_seed(0))
    freeze.load_subtree(init, donor, run_learner.subtree_paths(arg["init_model_subtree"]))
    start, trainable = dict(init.named_parameters()), set(opt.names)
    counts = [0, 0, 0]
    for k, p in net.named_parameters():
        p0 = start[k].to(p.device)
        if k not in trainable:
            if not torch.equal(p.detach(), p0):
                raise SystemExit(f"run_learner {name}: frozen parameter {k} changed")
            counts[0] += 1
        elif not torch.equal(p.detach(), p0):
            counts[1] += 1
        elif p.grad is None or not bool(p.grad.any()):
            counts[2] += 1
        else:
            raise SystemExit(f"run_learner {name}: trainable parameter {k} did not move")
    return counts


def run_learners(launches_of):
    """Phase 13b: bin/run_learner for the three stages in turn on the card,
    each run with every kernel count set to 0 first. Returns the rows of
    phase 13c."""
    import tempfile

    import torch

    from lifelike_tpu_torch.bin import run_learner
    from lifelike_tpu_torch.learning import registry
    from lifelike_tpu_torch.models import epmc, params, pmc, sepmc

    rows = {}
    loaders = {"pmc": pmc.PMCNet, "epmc": epmc.EPMCNet, "sepmc": sepmc.SEPMCNet}
    with tempfile.TemporaryDirectory() as d:
        for name, flags in _learner_flags(d).items():
            updates = next((int(f.split("=")[1]) for f in flags
                            if f.startswith("--total_updates")), LEARN_UPDATES)
            argv = [f"--task={name.split()[0]}", "--device=cuda", "--seed=0",
                    f"--total_updates={updates}", "--log_interval=1", "--pub_interval=1"] + [
                f for f in flags if not f.startswith("--total_updates")]
            for k in launches_of:
                k.launches = 0
            out = run_learner.main(argv, log=lambda m, name=name: say(f"run_learner {name}: " + m))
            launches = [k.launches for k in launches_of]
            want = [0] * len(launches_of)
            if name == "epmc hard-contact":
                want[4] = LEARN_T * updates * IMPULSE_SUBSTEPS  # K5: env steps x substeps
            if launches != want:
                raise SystemExit(f"run_learner {name}: kernel launches (K1-K6) {launches}, "
                                 f"expected {want}")
            ups = out["updates"]
            if len(ups) != updates or not all(math.isfinite(v) for u in ups
                                              for v in u["metrics"].values()):
                raise SystemExit(f"run_learner {name}: missing or non-finite losses {ups}")
            extra = ""
            if name in ("epmc", "sepmc", "epmc hard-contact"):
                f, m, z = check_handoff(name, out, flags)
                extra = (f" | {f} frozen tensors bitwise the donor's, {m} trainable moved, {z} "
                         f"with an all-zero gradient")
            pool_dir = next((f.split("=", 1)[1] for f in flags
                             if f.startswith("--model_pool_dir")), None)
            if pool_dir:
                pool = registry.ModelPool(pool_dir)
                files = sorted(os.listdir(pool_dir))
                for fn in files:  # strict: every leaf used, every parameter filled
                    params.load_flax_tree(loaders[name.split()[0]](), pool.load(fn[:-6]))
                extra += f" | pool files {files} read back by the port's ModelPool"
            rows[name] = dict(
                updates=updates, launches=launches, losses=[u["metrics"]["loss"] for u in ups],
                collect_ms=[u["collect_ms"] for u in ups],
                optimize_ms=[u["optimize_ms"] for u in ups],
                env_steps_per_s=[u["env_steps_per_s"] for u in ups],
                max_memory_allocated=out["max_memory_allocated"])
            say(f"run_learner {name} on the card: {updates} updates of {out['cfg'].unroll_length} "
                f"env steps, losses {rows[name]['losses']}{extra} | kernel launches (K1-K6) "
                f"{launches}")
    return rows


def report_learners(rows, smi):
    """Phase 13c: ms per update split into collection and optimisation, env
    steps/s and the peak device memory of each run_learner run."""
    for name, r in rows.items():
        per = "; ".join(f"update {i}: collection {c:.1f} ms, optimisation {o:.1f} ms, "
                        f"{s:.1f} env steps/s" for i, (c, o, s) in enumerate(
                            zip(r["collect_ms"], r["optimize_ms"], r["env_steps_per_s"])))
        mem = r["max_memory_allocated"]
        say(f"learner {name} [{smi}]: {per} (CUDA events; update 0 includes warm-up) | "
            f"torch.cuda.max_memory_allocated "
            + ("not measured" if mem is None else f"{mem / 2**20:.1f} MiB"))


def check_prior_bank(fns):
    """Phase 14a: make_eval's prior bank for elements 1-3; K2 against its
    plain version, float32, on one solve's candidates of each prior at its
    own inputs (its TraversalWeights, speed scale, gait weight and clip
    reference at the eval loop's first clip times), population EVAL_POP, H
    EVAL_H, the corridor prune of the element's first state. The robot lands
    within the horizon, and contact chaos turns the float32 rounding of a
    few candidates into costs far apart, so the candidates whose plain cost
    moves beyond the tolerance in float64 (the plain version's own float32
    rounding; computed for the candidates outside the gate) are counted and
    not gated, as phase 5's float64 checks screen theirs. Returns the
    largest gated error."""
    import numpy as np
    import torch

    from lifelike_tpu_torch.envs import playground
    from lifelike_tpu_torch.ops import traversal_cuda
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.solver import mpc_tasks, mppi_tl, rollout_tl
    from lifelike_tpu_torch.solver.mppi import MPPIConfig
    from lifelike_tpu_torch.tools import make_eval as me

    worst = 0.0
    for eid in (1, 2, 3):
        dev, model, cfg, clips, _, priors, skill = me.traversal_setup(eid, EVAL_POP, EVAL_H,
                                                                      device="cuda")
        c = B.tl_constants(model, dtype=torch.float32, device=dev)
        c64 = B.tl_constants(model, dtype=torch.float64, device=dev)
        mcfg = MPPIConfig(horizon=EVAL_H, population=EVAL_POP, iterations=2, sigma=0.12)
        gen = torch.Generator(device=dev).manual_seed(1000)
        s, _ = playground.reset(model, cfg, gen)
        spd = torch.clamp_max(s.target_spd, me.SPD_CAP)
        table = traversal_cuda.pack_boxes(mpc_tasks._corridor_scene(
            cfg.params, mcfg, s.robot, s.scene, s.target_pos, spd, mpc_tasks.CONTACT_K))
        tl = mpc_tasks._tl_single(s.robot)
        t_clips = (me.CLIP_LOOP[0], skill["t0"] if skill["kind"] == "play" else skill["loop"][0])
        ids, weights, scales, gaits = mpc_tasks._prior_tuples(priors, 1.0)
        rng = np.random.default_rng(140 + eid)
        for pi, (cid, w, ss, gw) in enumerate(zip(ids, weights, scales, gaits)):
            ref = rollout_tl.precompute_reference(model, clips, cid, t_clips[pi], EVAL_H,
                                                  cfg.policy_dt)
            eps = torch.as_tensor(rng.standard_normal((EVAL_H, 4, 3, EVAL_POP // 128, 128)),
                                  dtype=torch.float32, device=dev)
            u = 0.12 * mppi_tl._smooth_noise_tl(None, eps.shape, 0.7, torch.float32, dev, eps=eps)
            args = (c, cfg.params, tl, u.contiguous(), table, ref, s.target_pos, spd * ss,
                    cfg.reward_type, cfg.max_steps, w, gw)
            got = traversal_cuda.rollout_traversal_fused(*args)
            want = traversal_cuda.rollout_traversal_plain(*args)
            # the float64 screen, run on the candidates outside the gate only
            # (a candidate's cost does not depend on the others)
            exact = want.clone()
            out = ((got - want).abs() > 2e-4 * (1.0 + want.abs())).reshape(-1).nonzero()[:, 0]
            if len(out):
                f64 = lambda x: x.to(torch.float64)
                u_out = args[3].reshape(EVAL_H, 4, 3, -1)[..., out][..., None, :].contiguous()
                exact.view(-1)[out] = traversal_cuda.rollout_traversal_plain(
                    c64, cfg.params, B.map_state(f64, tl), f64(u_out), f64(table), ref,
                    f64(s.target_pos), f64(spd * ss), *args[8:]).reshape(-1).to(torch.float32)
            worst = max(worst, report_diff(
                f"check K2 f32 prior bank element {eid} prior {pi} (clip {cid}, "
                f"{'default weights' if w == type(w)() else 'own weights'}, speed x {ss:g}, "
                f"gait weight {gw:g}): pop {EVAL_POP} H {EVAL_H} substeps "
                f"{cfg.params.substeps}", got, want, 2e-4, shifted=exact,
                screen="float64"))
    return worst


def run_task_evals(fns, smi):
    """Phase 14b-f: make_eval's task evaluation on the card, each run with
    every kernel count set to 0 first. Returns its rows."""
    import statistics as st
    import tempfile

    import numpy as np
    import torch

    from lifelike_tpu_torch.compat import tleague_import
    from lifelike_tpu_torch.models import epmc, params
    from lifelike_tpu_torch.motion import motion_lib
    from lifelike_tpu_torch.tools import distill_prior
    from lifelike_tpu_torch.tools import make_eval as me
    from lifelike_tpu_torch.utils import profiling

    def zero():
        for k in fns:
            k.launches = 0

    def counts():
        return [k.launches for k in fns]

    log = lambda m: say("make_eval: " + m.strip())
    rows = {}
    # (b) eval_traversal: K2 = steps x priors x MPPI iterations, nothing else
    for eid in (1, 2, 3):
        zero()
        (r,) = me.eval_traversal(1, EVAL_STEPS_TRAV, eid, EVAL_POP, EVAL_H, device="cuda",
                                 log=log)
        got = counts()
        want = [0, r["steps"] * 2 * 2, 0, 0, 0, 0]
        if got != want:
            raise SystemExit(f"eval_traversal element {eid}: kernel launches (K1-K6) {got}, "
                             f"expected {want} (steps x 2 priors x 2 iterations)")
        flat = [x for step in r["prior_costs"] for x in step]
        if not all(math.isfinite(x) for x in flat + [r["reward"], r["progress"]]):
            raise SystemExit(f"eval_traversal element {eid}: non-finite costs or rewards")
        solve, plant = r["solve_ms"][1:], r["plant_ms"][1:]
        rows[f"traversal {eid}"] = dict(r, launches=got)
        say(f"eval_traversal element {eid} ({me.ELEMENT_NAMES[eid]}) [{smi}]: pop {EVAL_POP} H "
            f"{EVAL_H}, 2 priors x 2 iterations, {r['steps']} steps, {r['outcome']}, progress "
            f"{r['progress']:.3f} m, reward {r['reward']:.4f} | prior per step {r['sel']} | "
            f"solve ms after the first (CUDA events) p50 {st.median(solve):.2f} max "
            f"{max(solve):.2f} (first {r['solve_ms'][0]:.1f}) | plant ms p50 "
            f"{st.median(plant):.2f} max {max(plant):.2f} | kernel launches (K1-K6) {got}")
    # (c) the chase evaluations: K3 = K4 = steps x 1 round x 2 robots (1 iteration)
    for name, run in (("chase standing escapee", lambda: me.eval_chase(
            1, EVAL_STEPS_CHASE, EVAL_POP, EVAL_H, True, device="cuda", log=log)),
                      ("chase game", lambda: me.eval_chase_game(
            1, EVAL_STEPS_CHASE, EVAL_POP, EVAL_H, device="cuda", log=log))):
        zero()
        t0 = time.perf_counter()
        (r,) = run()
        dt = time.perf_counter() - t0
        got = counts()
        want = [0, 0, 2 * r["steps"], 2 * r["steps"], 0, 0]
        if got != want:
            raise SystemExit(f"eval {name}: kernel launches (K1-K6) {got}, expected {want}")
        rows[name] = dict(r, launches=got, s=dt)
        say(f"eval {name} [{smi}]: pop {EVAL_POP} per robot H {EVAL_H}, {r['steps']} steps, "
            f"{r['outcome']} | {dt:.2f} s wall (set-up included) | kernel launches (K1-K6) "
            f"{got}")
    # (d) the checkpoint section: run_eval in a subprocess on the card
    t0 = time.perf_counter()
    ck = me.eval_checkpoints(1, EVAL_STEPS_CKPT, seeds=1, device="cuda", log=log)
    eps = ck["pmc"]["episodes"]
    if ck["pmc"]["rc"] != 0 or len(eps) != 1 or not math.isfinite(eps[0][0]):
        raise SystemExit(f"eval_checkpoints pmc: {ck['pmc']}")
    if any(ck[t]["episodes"] or ck[t]["rc"] is not None for t in ck if t != "pmc"):
        raise SystemExit(f"eval_checkpoints: a task without a model ran: {ck}")
    rows["checkpoints"] = dict(ck, s=time.perf_counter() - t0)
    say(f"eval_checkpoints pmc ({os.path.basename(me.MODELS['pmc'])}) through "
        f"bin/run_eval --device=cuda: reward {eps[0][0]:.3f} over {eps[0][1]} steps, rc 0 | "
        f"{rows['checkpoints']['s']:.1f} s wall (a subprocess) | other tasks: no model")
    # (e) distill_prior on a seeded EPMC flat list: roll, mine, resample,
    # write, read back (a 20-step episode holds none of the 60-125-step
    # crawl windows, so the window here is half the episode, any height)
    zero()
    flat = seeded_flat_list(tleague_import.EPMC_PATHS, params.flax_tree(epmc.EPMCNet()), 14)
    t0 = time.perf_counter()
    ep = distill_prior.roll_policy("hole", 1, EVAL_STEPS_DISTILL, 0, flat, device="cuda",
                                   log=lambda m: say("distill_prior: " + m.strip()))
    n = len(ep[0]["states"])
    hit = distill_prior.find_crawl(ep, z_max=math.inf, z_min=-math.inf, widths=(max(1, n // 2),))
    if hit is None or not np.isfinite(ep[0]["states"]).all():
        raise SystemExit(f"distill_prior: {n} states, window {hit}")
    ei, w0, W, spd = hit
    frames = distill_prior.reorient_resample(ep[ei]["states"][w0:w0 + W])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hole_crawl.json")
        distill_prior.write_prior(path, frames, "seeded flat list", ei, (w0, w0 + W), spd)
        clips = motion_lib.load_clips(path, device="cuda")
    if tuple(clips.frames.shape) != (1, len(frames), 19) or \
            not bool(torch.isfinite(clips.frames).all()):
        raise SystemExit(f"distill_prior: clip read back as {tuple(clips.frames.shape)}")
    rows["distill"] = dict(steps=n, window=(w0, W), frames=len(frames), launches=counts(),
                           s=time.perf_counter() - t0)
    say(f"distill_prior on the card: {n} steps of a seeded EPMC flat list, window [{w0}, "
        f"{w0 + W}) at {spd:.3f} m/s -> {len(frames)} frames at 120 Hz, written and read back "
        f"by motion_lib.load_clips | {rows['distill']['s']:.2f} s | kernel launches (K1-K6) "
        f"{rows['distill']['launches']}")
    # (f) utils.profiling names the card
    spec = profiling.detect_chip()
    if spec.name != torch.cuda.get_device_name(0):
        raise SystemExit(f"detect_chip: {spec.name}, the card is {torch.cuda.get_device_name(0)}")
    rows["chip"] = spec._asdict()
    say(f"utils.profiling.detect_chip: {spec.name} | peaks FP32 {spec.peak_flops_f32:g} / FP64 "
        f"{spec.peak_flops_f64:g} FLOP/s, HBM {spec.hbm_bytes_per_s:g} B/s at "
        f"{spec.power_limit_w:g} W | nvidia-smi: {smi}")
    return rows


# ---------------------------------------------------------------------------
# phase 15: the multi-process layer (parallel/, torch.distributed) on the one
# card, in subprocesses started by tools/launch_multihost.py
# ---------------------------------------------------------------------------


def multi_inputs(dev, pop, horizon, iterations=1):
    """(model, clips, plant, constants, start state, MPPI config, t0) of the
    PMC headline solve (substeps 10, mass_freeze 10, synthetic clip, the
    robot standing), float32, on `dev`."""
    import torch

    from lifelike_tpu_torch.motion import motion_lib
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.physics import engine
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.solver.mppi import MPPIConfig
    from lifelike_tpu_torch.tools.multihost_worker import standing_tl

    model = build_max_model()
    clips = motion_lib.pack_clips([motion_lib.make_synthetic_clip(int(120 * (horizon / 50 + 3)))],
                                  frame_step=1.0 / 120.0, device=dev)
    params = engine.PhysicsParams(substeps=SUBSTEPS, mass_freeze=SUBSTEPS)
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    cfg = MPPIConfig(horizon=horizon, population=pop, iterations=iterations)
    return model, clips, params, c, standing_tl(torch.float32, dev), cfg, 0.2


def _counts(fns):
    return {k: f.launches for k, f in fns.items()}


def _launched(fns, before):
    return {k: f.launches - before[k] for k, f in fns.items()}


def multi_solve(mesh, fns, world_one):
    """Phase 15a / 15b on this rank: one sharded solve at the headline shape
    under the global normals of seed MULTI_SEED (this rank's rows), its K1
    launches, then MULTI_SOLVES chained solves on generator noise timed
    with CUDA events; world_one: also hold it to mppi_tl.mppi_step on the
    same normals (phase 15a)."""
    import torch

    from lifelike_tpu_torch.parallel import mesh as meshlib
    from lifelike_tpu_torch.parallel import distributed, sharded_solve
    from lifelike_tpu_torch.solver import mppi_tl, rollout_tl

    dev = mesh.device
    model, clips, params, c, tl, cfg, t0 = multi_inputs(dev, POP, HORIZON)
    g = torch.Generator(device=dev).manual_seed(MULTI_SEED)
    eps_all = [torch.randn((HORIZON, 4, 3, POP // 128, 128), generator=g, device=dev)]
    eps = [meshlib.shard_batch(mesh, e, axis=3).contiguous() for e in eps_all]
    solve = sharded_solve.make_sharded_solver(mesh, model, c, params, clips, cfg)
    u0 = torch.zeros((HORIZON, 4, 3), device=dev)
    before = _counts(fns)
    u, diag = solve(None, tl, u0, 0, t0, eps=eps)
    torch.cuda.synchronize()
    out = {"u": u.cpu(), "best_cost": float(diag["best_cost"]), "launches": _launched(fns, before),
           "layout": sharded_solve.local_layout(mesh, POP)}
    if world_one:
        ref = rollout_tl.precompute_reference(model, clips, 0, t0, HORIZON,
                                              params.dt * params.substeps)
        u_ref, _ = mppi_tl.mppi_step(c, params, cfg, None, tl, u0, ref, eps=eps_all)
        out["err_vs_mppi_step"] = report_diff(
            f"multi (a) sharded solve, 1 NCCL rank, vs mppi_tl.mppi_step pop {POP} H {HORIZON} "
            "f32 plan", u, u_ref, 2e-4)
    gen = distributed.rank_generator(MULTI_SEED, mesh)
    ms, u_w = [], u0
    for _ in range(MULTI_SOLVES + 1):  # the first is a warm-up
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        u_w, _ = solve(gen, tl, u_w, 0, t0)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    out["ms"] = ms[1:]
    return out


def multi_sweep(mesh, fns):
    """Phase 15c on this rank: sharded_scenario_sweep at bench_sweep's S 16 x
    256 (S / W scenario blocks per rank), held to the single-process tiled
    sweep of all 16 scenarios under the same per-scenario normals (its
    launches not counted), and one sharded round's K3 / K4 launches and ms."""
    import torch

    from lifelike_tpu_torch.parallel import mesh as meshlib
    from lifelike_tpu_torch.parallel import scenario_sweep

    c, params, cfg, scen, _ = sweep_inputs(SWEEP_POPS[0], n_scen=SWEEP_S, horizon=HORIZON,
                                           device=mesh.device)
    eps = scenario_sweep.scenario_noise(MULTI_SEED, cfg, range(SWEEP_S), 1, torch.float32,
                                        scen.flag_pos.device)
    u_all, cost_all = scenario_sweep.sweep_scenarios_tiled(c, params, cfg, None, scen, eps=eps,
                                                           device=mesh.device)
    rows = meshlib.shard_rows(mesh, SWEEP_S)
    before = _counts(fns)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    u, cost, summary = scenario_sweep.sharded_scenario_sweep(mesh, c, params, cfg, MULTI_SEED,
                                                             scen, device=mesh.device)
    e1.record()
    e1.synchronize()
    launches = _launched(fns, before)
    label = f"multi (c) rank {mesh.rank} sharded sweep S {SWEEP_S} pop {cfg.population} f32"
    err = max(report_diff(f"{label} best cost vs one process", cost, cost_all[rows], 2e-4),
              report_diff(f"{label} plans vs one process", u, u_all[rows], 2e-4))
    return {"launches": launches, "ms": e0.elapsed_time(e1), "err": err,
            "summary": {k: float(v) for k, v in summary.items()},
            "summary_one": {"mean_cost": float(cost_all.mean()), "min_cost": float(cost_all.min())}}


def multi_hybrid(mesh, fns):
    """Phase 15d on this rank: one sharded hybrid solve (bench_hybrid's
    population, H HYB_TASK_HORIZON, 1 MPPI and 1 iLQR iteration)."""
    import torch

    from lifelike_tpu_torch.parallel import distributed, sharded_solve
    from lifelike_tpu_torch.solver import ilqr, rollout_tl

    model, clips, params, c, tl, cfg, t0 = multi_inputs(mesh.device, HYB_POP, HYB_TASK_HORIZON)
    ref = rollout_tl.precompute_reference(model, clips, 0, t0, cfg.horizon,
                                          params.dt * params.substeps)
    u0 = torch.zeros((cfg.horizon, 4, 3), device=mesh.device)
    before = _counts(fns)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    u, diag = sharded_solve.sharded_hybrid_step(
        mesh, model, c, params, clips, cfg, ilqr.ILQRConfig(iterations=1),
        distributed.rank_generator(MULTI_SEED, mesh), tl, u0, 0, t0, ref)
    e1.record()
    e1.synchronize()
    return {"u": u.cpu(), "launches": _launched(fns, before), "ms": e0.elapsed_time(e1),
            **{k: float(v) for k, v in diag.items()}}


def multi_rank(case, out_dir):
    """One rank of phase 15 (`chip_smoke.py --multi-rank CASE DIR`, started
    by run_multi): "nccl" runs 15a, "shared" 15b-d; writes its results to
    DIR/CASE_rank{r}.pt."""
    import torch

    from lifelike_tpu_torch.ops import rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.parallel import distributed
    from lifelike_tpu_torch.solver import riccati_cuda

    fns = {"K1": rollout_cuda.rollout_tracking_fused, "K3": tc.rollout_plan_fused,
           "K4": tc.rollout_chase_fused, "K6": riccati_cuda.riccati_sweep}
    distributed.initialize(timeout_s=MULTI_TIMEOUT_S)
    try:
        mesh = distributed.global_mesh()
        out = {"world": mesh.world, "backend": mesh.backend, "device": str(mesh.device),
               "solve": multi_solve(mesh, fns, world_one=case == "nccl")}
        if case == "shared":
            out["sweep"] = multi_sweep(mesh, fns)
            out["hybrid"] = multi_hybrid(mesh, fns)
        torch.save(out, os.path.join(out_dir, f"{case}_rank{mesh.rank}.pt"))
    finally:
        distributed.destroy()
    return 0


def _ranks(name, cmd, n, backend, log_dir):
    """Launch `cmd` as n ranks; exits with the ranks' log tails unless all
    exit 0. Returns each rank's log."""
    from lifelike_tpu_torch.tools import launch_multihost

    logs = os.path.join(log_dir, name.replace(" ", "_"))
    t0 = time.perf_counter()
    rcs = launch_multihost.launch(cmd, n, backend=backend, log_dir=logs,
                                  timeout=MULTI_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
                                      __file__)))
    text = [open(os.path.join(logs, f"rank{r}.log")).read() for r in range(n)]
    say(f"multi {name}: {n} rank(s), backend {backend}, exit codes {rcs}, "
        f"{time.perf_counter() - t0:.1f} s of wall time")
    for r, t in enumerate(text):  # the ranks' own check lines
        for line in t.splitlines():
            if line.startswith("multi ("):
                say(f"[rank {r}] {line}")
    if any(rcs):
        for r, t in enumerate(text):
            say(f"--- rank {r} log (tail) ---\n{t[-3000:]}")
        raise SystemExit(f"multi {name}: a rank failed ({rcs})")
    return text


_UPDATE = r"^update (\d+): (\{.*?\}) \| env steps/s \S+ \| ms per update: collection (\S+), " \
          r"optimisation (\S+)$"


def _updates(text):
    """{update: (metrics, collection ms, optimisation ms)} of a run_learner log."""
    import ast
    import re

    return {int(m[0]): (ast.literal_eval(m[1]), float(m[2]), float(m[3]))
            for m in re.findall(_UPDATE, text, re.M)}


def multi_learners(d, smi, device="cuda"):
    """Phase 15e: bin/run_learner data-parallel on two gloo ranks sharing the
    card: PMC at 256 envs (128 per rank) for MULTI_UPDATES updates with a
    checkpoint per update beside an uninterrupted run of one update more,
    then the resume to that many updates beside one EPMC update."""
    import concurrent.futures

    flags = _learner_flags(d)
    base = [sys.executable, "-m", "lifelike_tpu_torch.bin.run_learner", f"--device={device}",
            "--seed=0", "--log_interval=1", "--pub_interval=1"]
    pmc = base + ["--task=pmc"] + [f for f in flags["pmc"] if "--model_pool_dir" not in f]
    ckpt = os.path.join(d, "multi_train.ckpt")
    saving = [f"--train_checkpoint={ckpt}", "--save_interval=1"]
    epmc = base + ["--task=epmc", "--total_updates=1"] + [
        f for f in flags["epmc"] if "--model_pool_dir" not in f]
    n, k_saved, k_straight = MULTI_UPDATES, f"learner pmc {MULTI_UPDATES} updates", \
        f"learner pmc {MULTI_UPDATES + 1} updates"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {k_saved: pool.submit(_ranks, k_saved, pmc + [f"--total_updates={n}"] + saving, 2,
                                     "gloo", d),
                k_straight: pool.submit(_ranks, k_straight, pmc + [f"--total_updates={n + 1}"], 2,
                                        "gloo", d)}
        text = {k: v.result() for k, v in runs.items()}
        runs = {"learner pmc resumed": pool.submit(
                    _ranks, "learner pmc resumed", pmc + [f"--total_updates={n + 1}"] + saving, 2,
                    "gloo", d),
                "learner epmc 1 update": pool.submit(
                    _ranks, "learner epmc 1 update", epmc, 2, "gloo", d)}
        text.update({k: v.result() for k, v in runs.items()})
    ups = {k: [_updates(t) for t in v] for k, v in text.items()}
    for k, want in ((k_saved, list(range(n))), (k_straight, list(range(n + 1))),
                    ("learner pmc resumed", [n]), ("learner epmc 1 update", [0])):
        r0, r1 = ups[k]
        if sorted(r0) != want or sorted(r1) != want:
            raise SystemExit(f"multi {k}: updates {sorted(r0)} / {sorted(r1)}, expected {want}")
        for i in want:
            m0, m1 = r0[i][0], r1[i][0]
            if m0 != m1 or not all(math.isfinite(v) for v in m0.values()):
                raise SystemExit(f"multi {k}: update {i} metrics differ across the ranks or are "
                                 f"not finite: {m0} / {m1}")
    for suffix in (".r0", ".r1", ".step"):
        if not os.path.exists(ckpt + suffix):
            raise SystemExit(f"multi learner: {ckpt + suffix} not written")
    if not all(f"resumed {ckpt} at update {n}" in t for t in text["learner pmc resumed"]):
        raise SystemExit(f"multi learner: the resume did not start at update {n}")
    got = ups["learner pmc resumed"][0][n][0]["loss"]
    want = ups[k_straight][0][n][0]["loss"]
    diff = abs(got - want)
    same = "; bitwise equal" if got == want else ""
    say(f"multi (e) learner pmc resume: update {n} loss {got!r} resumed vs {want!r} "
        f"uninterrupted, |diff| {diff:.3e} (gate {TRAIN_TOL:g} x max(1, |loss|){same})")
    if diff > TRAIN_TOL * max(1.0, abs(want)):
        raise SystemExit(f"multi learner: the resumed update {n} differs from the uninterrupted "
                         "run")
    rows = {}
    for k, per in ups.items():
        rows[k] = [{i: {"loss": m["loss"], "collect_ms": cm, "optimize_ms": om}
                    for i, (m, cm, om) in sorted(r.items())} for r in per]
        say(f"multi (e) {k} [{smi}]: " + "; ".join(
            f"rank {r}: " + ", ".join(f"update {i} loss {v['loss']:.6f} collection "
                                      f"{v['collect_ms']:.1f} ms optimisation "
                                      f"{v['optimize_ms']:.1f} ms" for i, v in rr.items())
            for r, rr in enumerate(rows[k])) + " (CUDA events per rank; the card and the host "
            "are shared by the ranks)")
    return rows


def run_multi(smi, rank_cmd=None, learner_device="cuda"):
    """Phase 15 (see the module's docstring), the kernels built by this
    process before. rank_cmd: the command of a rank of 15a-d, to which the
    case and a directory are appended (default: this script with
    --multi-rank). Returns its rows."""
    import tempfile

    import torch

    t15 = time.perf_counter()
    rank_cmd = rank_cmd or [sys.executable, os.path.abspath(__file__), "--multi-rank"]
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        _ranks("(a) one NCCL rank", rank_cmd + ["nccl", d], 1, "nccl", d)
        _ranks("(b-d) two gloo ranks sharing the card", rank_cmd + ["shared", d], 2, "gloo", d)
        a = torch.load(os.path.join(d, "nccl_rank0.pt"), weights_only=False)
        s = [torch.load(os.path.join(d, f"shared_rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
        # (a)
        if a["solve"]["launches"] != {"K1": 1, "K3": 0, "K4": 0, "K6": 0}:
            raise SystemExit(f"multi (a): launches {a['solve']['launches']}, expected K1 1")
        # (b)
        if not torch.equal(s[0]["solve"]["u"], s[1]["solve"]["u"]):
            raise SystemExit("multi (b): the plan differs across the ranks")
        err_b = report_diff(f"multi (b) 2 gloo ranks x {POP // 2} vs 1 NCCL rank x {POP} plan",
                            s[0]["solve"]["u"], a["solve"]["u"], 2e-4)
        for r in (0, 1):
            if s[r]["solve"]["launches"] != {"K1": 1, "K3": 0, "K4": 0, "K6": 0}:
                raise SystemExit(f"multi (b) rank {r}: launches {s[r]['solve']['launches']}")
        for name, out in (("(a) 1 NCCL rank", [a]), ("(b) 2 gloo ranks", s)):
            say(f"multi {name} solve pop {POP} H {HORIZON} [{smi}]: " + "; ".join(
                f"rank {r} layout {o['solve']['layout']} ms per solve p50 "
                f"{statistics.median(o['solve']['ms']):.3f} max {max(o['solve']['ms']):.3f}"
                for r, o in enumerate(out)) + f" ({MULTI_SOLVES} chained solves, CUDA events"
                + ("; the card is time-sliced between the ranks)" if len(out) > 1 else ")"))
        # (c)
        for r in (0, 1):
            if s[r]["sweep"]["launches"] != {"K1": 0, "K3": 2, "K4": 2, "K6": 0}:
                raise SystemExit(f"multi (c) rank {r}: launches {s[r]['sweep']['launches']}")
        if s[0]["sweep"]["summary"] != s[1]["sweep"]["summary"]:
            raise SystemExit("multi (c): the summary differs across the ranks")
        for k in ("mean_cost", "min_cost"):
            got, want = s[0]["sweep"]["summary"][k], s[0]["sweep"]["summary_one"][k]
            if abs(got - want) > 2e-4 * (1 + abs(want)):
                raise SystemExit(f"multi (c): {k} {got} vs one process {want}")
        say(f"multi (c) sharded sweep S {SWEEP_S} x {SWEEP_POPS[0]}, {SWEEP_S // 2} blocks per "
            f"rank: summary "
            f"{s[0]['sweep']['summary']} (one process {s[0]['sweep']['summary_one']}) | ms per "
            f"round rank 0 {s[0]['sweep']['ms']:.3f}, rank 1 {s[1]['sweep']['ms']:.3f} [{smi}]")
        # (d)
        h = [o["hybrid"] for o in s]
        if not torch.equal(h[0]["u"], h[1]["u"]):
            raise SystemExit("multi (d): u_best differs across the ranks")
        for r in (0, 1):
            if h[r]["launches"] != {"K1": 1, "K3": 0, "K4": 0, "K6": 1}:
                raise SystemExit(f"multi (d) rank {r}: launches {h[r]['launches']}")
        if not h[0]["refined_cost"] <= h[0]["seed_cost"] + 1e-5:
            raise SystemExit(f"multi (d): refined {h[0]['refined_cost']} above the best seed's "
                             f"{h[0]['seed_cost']}")
        say(f"multi (d) sharded hybrid pop {HYB_POP} H {HYB_TASK_HORIZON}: refined "
            f"{h[0]['refined_cost']:.6f} <= best seed {h[0]['seed_cost']:.6f} + 1e-5 | ms per "
            f"solve rank 0 {h[0]['ms']:.1f}, rank 1 {h[1]['ms']:.1f} [{smi}]")
        rows.update(a=a["solve"]["ms"], b=[o["solve"]["ms"] for o in s], err_b=err_b,
                    err_a=a["solve"]["err_vs_mppi_step"],
                    c=[o["sweep"]["ms"] for o in s], d=[x["ms"] for x in h],
                    launches={"a": a["solve"]["launches"],
                              "b-d": [{p: o[p]["launches"] for p in ("solve", "sweep", "hybrid")}
                                      for o in s]})
        rows["e"] = multi_learners(d, smi, learner_device)
    say(f"phase 15: {time.perf_counter() - t15:.1f} s")
    return rows


def multi_mode():
    """The --multi mode: phase 15 alone, then one JSON line of its rows."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import cuda_build, rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.solver import riccati_cuda

    smi = nvidia_smi()
    say(f"multi: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvidia-smi: {smi}")
    t0 = time.perf_counter()
    cuda_build.build_all([rollout_cuda.KERNEL, tc.PLAN_KERNEL, tc.CHASE_KERNEL,
                          riccati_cuda.KERNEL])
    say(f"build: K1, K3, K4, K6 in {time.perf_counter() - t0:.1f} s wall")
    rows = run_multi(smi)
    say(json.dumps({"smi": smi, "rows": rows}, default=str))
    return 0


def peaks():
    """The H100 SXM's published peaks (utils.profiling.H100_SXM: FP32 / FP64
    outside the tensor cores, HBM3 bytes/s, at its 700 W limit), the one
    place the bounds read them from."""
    from lifelike_tpu_torch.utils import profiling

    return profiling.H100_SXM


def bound(ops, nbytes):
    """(bound ms, what bounds it, ops ms, bytes ms) on this card's peaks."""
    spec = peaks()
    ops_ms, bytes_ms = 1e3 * ops / spec.peak_flops_f32, 1e3 * nbytes / spec.hbm_bytes_per_s
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

    # 10e. the scenario sweep (bench_sweep's rows) on K3 / K4: its gates, then
    # each population's chained rounds with every kernel count set to 0 first
    check_sweep()
    for pop in SWEEP_POPS:
        row = time_sweep(pop, fns)
        want = [0, 0, 2 * SWEEP_ROUNDS, 2 * SWEEP_ROUNDS, 0, 0]
        if row["launches"] != want:
            raise SystemExit(f"kernel launches of the sweep at pop {pop} (K1-K6): "
                             f"{row['launches']}, expected {want} (2 K3 + 2 K4 per round)")
    # 10f. the C++ clip parser
    check_clip_parser()

    # 11. timings at the headline solve shapes
    timing, _ = time_rollouts(sys.modules[__name__])
    timing.update(time_chase(model_len()))
    timing["K5"] = time_pgs()
    timing["K6"] = time_riccati()
    hybrid_breakdown(timing["K6"]["ms"])

    # 12. the policy networks: card vs CPU, bin/run_eval on the card, latency
    t12 = time.perf_counter()
    card = check_networks()
    run_evals(fns)
    time_networks(card)
    say(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # 13. the learner: train steps on the card vs the CPU, then bin/run_learner
    # for the three stages in turn, each with every kernel count set to 0 first
    t13 = time.perf_counter()
    check_train_steps()
    report_learners(run_learners(fns), smi)
    say(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # 14. make_eval's task evaluation: the prior bank's K2 inputs vs the
    # plain version, then each evaluation with every kernel count set to 0 first
    t14 = time.perf_counter()
    check_prior_bank(fns)
    run_task_evals(fns, smi)
    say(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # 15. the multi-process layer: ranks on this card, the kernels built above
    run_multi(smi)

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
    ap.add_argument("--loop", action="append", default=[],
                    choices=("pmc", "epmc", "sepmc", "sweep"))
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
        if task == "sweep":
            for pop in smoke.SWEEP_POPS:
                row = smoke.time_sweep(pop, fns["sepmc"])
                out[row["name"]] = {k: row[k] for k in ("p50_ms", "max_ms", "launches", "busy")}
            continue
        run, launches = smoke.closed_loop(task, fns[task], f"closed loop {task}")
        t_ms = [1e3 * t for t in run["t_solve"][1:]]
        out[task] = {"solve_p50_ms": statistics.median(t_ms), "solve_max_ms": max(t_ms),
                     "launches": launches}
    say(json.dumps(out))
    return 0


def learner_mode():
    """The --learner mode: phase 13 alone, then one JSON line of its rows."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import pgs_cuda, rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.solver import riccati_cuda

    smi = nvidia_smi()
    say(f"learner: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvidia-smi: {smi}")
    fns = (rollout_cuda.rollout_tracking_fused, tc.rollout_traversal_fused,
           tc.rollout_plan_fused, tc.rollout_chase_fused, pgs_cuda.pgs_sweep,
           riccati_cuda.riccati_sweep)
    t13 = time.perf_counter()
    check_train_steps()
    rows = run_learners(fns)
    report_learners(rows, smi)
    say(json.dumps({"smi": smi, "phase13_s": time.perf_counter() - t13, "rows": rows}))
    return 0


def eval_mode():
    """The --eval mode: phase 14 alone, then one JSON line of its rows."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from lifelike_tpu_torch.ops import cuda_build, pgs_cuda, rollout_cuda
    from lifelike_tpu_torch.ops import traversal_cuda as tc
    from lifelike_tpu_torch.solver import riccati_cuda

    smi = nvidia_smi()
    say(f"eval: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvidia-smi: {smi}")
    kernels = (tc.KERNEL, tc.PLAN_KERNEL, tc.CHASE_KERNEL)
    t0 = time.perf_counter()
    cuda_build.build_all(list(kernels))
    for k in kernels:
        tc.build(k)
    say(f"build: K2, K3, K4 in {time.perf_counter() - t0:.1f} s wall")
    fns = (rollout_cuda.rollout_tracking_fused, tc.rollout_traversal_fused,
           tc.rollout_plan_fused, tc.rollout_chase_fused, pgs_cuda.pgs_sweep,
           riccati_cuda.riccati_sweep)
    t14 = time.perf_counter()
    err = check_prior_bank(fns)
    rows = run_task_evals(fns, smi)
    say(json.dumps({"smi": smi, "phase14_s": time.perf_counter() - t14, "k2_max_abs_err": err,
                    "rows": rows}, default=str))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-rank"]:
        sys.exit(multi_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--multi"]:
        sys.exit(multi_mode())
    if sys.argv[1:2] == ["--timing"]:
        sys.exit(timing_mode(sys.argv[2:]))
    if sys.argv[1:2] == ["--learner"]:
        sys.exit(learner_mode())
    if sys.argv[1:2] == ["--eval"]:
        sys.exit(eval_mode())
    sys.exit(main())

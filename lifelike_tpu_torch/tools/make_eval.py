"""Closed-loop task-success evaluation of the port, as a Markdown report.

Port of tools/make_eval.py. Three sections:

  1. EPMC traversal success: solver.mpc_tasks.make_multigait_traversal_controller
     (a bank of gait priors, K2 per prior) drives envs.playground closed
     loop on hurdle / hole / cube courses (element_id 1 / 2 / 3) over N
     seeds; success = reach within 0.5 m of the course target without
     falling, within --cap control steps.
  2. SEPMC catch: solver.mpc_tasks.make_gait_chase_solver (K3 / K4) drives
     envs.chase_tag; (a) against a standing escapee (hold-pose action) and
     (b) both robots solver-driven, then full games with flag switches.
  3. Checkpoints: per-episode rewards of the models given by --models,
     through bin/run_eval in a subprocess on --device.

  python -m lifelike_tpu_torch.tools.make_eval [--seeds 5] [--cap 300] [--out FILE]
  python -m lifelike_tpu_torch.tools.make_eval --device=cpu --population=64 --horizon=3 \\
      --cap=5 --seeds=1 --skip_checkpoints

Differences from the JAX tool: --walk_clip / --jump_clip take reference-format
clip files or "synthetic" (the default: motion_lib.make_synthetic_clip,
30 s at 120 Hz, seeds 0 and 1); --models task=path,... names the
checkpoints (default: the repo's PMC pool checkpoint only; a task without a
model gets a row of 0 episodes); --device picks the card or the CPU; the
report goes to stdout unless --out names a file. The LIFELIKE_* environment
variables are the JAX tool's, with its defaults.
"""
import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.bin.run_mpc import _timed
from lifelike_tpu_torch.costs.traversal import TraversalWeights
from lifelike_tpu_torch.motion import motion_lib

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
MODELS = {"pmc": os.path.join(PACKAGE, "data", "pmc_r5", "model_0009660.model")}
CHECKPOINT_TASKS = ("pmc", "epmc_hurdle", "epmc_hole", "epmc_cube", "sepmc")
ELEMENT_NAMES = {1: "hurdles", 2: "holes", 3: "cubes"}

SYNTHETIC = "synthetic"
SYNTHETIC_FRAMES = 30 * 120  # 30 s at 120 Hz: CLIP_LOOP and RUN_LOOP need > 8.8 s
WALK_SEED, JUMP_SEED = 0, 1  # make_synthetic_clip seeds of the walk / jump stand-ins
CLIP_LOOP = (0.5, 4.5)  # the clip's steady-walk section
RUN_LOOP = (6.2, 8.8)  # the run section (~2-3 m/s) for fast targets
JUMP_T0, JUMP_END = 0.7, 2.4  # approach -> peak (1.47 s) -> landing window
PRIOR_DIR = os.path.join(PACKAGE, "data", "priors")
SPD_CAP = 1.3  # planning speed cap of the traversal loop


def clip_frames(spec, seed):
    """(N, 19) float32 frames: the 30 s synthetic clip of `seed` for
    "synthetic", else the Frames of a reference-format clip file."""
    if spec == SYNTHETIC:
        return motion_lib.make_synthetic_clip(SYNTHETIC_FRAMES, seed=seed)
    with open(spec) as f:
        return np.asarray(json.load(f)["Frames"], np.float32)


def _advance_clip(t_clip, loop=CLIP_LOOP):
    t_clip += 0.02
    return loop[0] if t_clip > loop[1] else t_clip


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class HostScene(NamedTuple):
    """A box scene's center / half / active as numpy (read once per episode:
    the gating below reads it every control step)."""

    center: np.ndarray
    half: np.ndarray
    active: np.ndarray


def host_scene(scene):
    return HostScene(_np(scene.center), _np(scene.half), _np(scene.active))


def gate_skill(scene, base_pos, element_id):
    """Per-obstacle skill gating from scene geometry (host-side, numpy).

    Returns the forced prior index for make_multigait_traversal_controller:
    0 = walk, 1 = the element's obstacle skill (jump / crouch / climb), -1 =
    pick by cost. The playground courses run along +x, so an x-window test
    against the robot's base suffices. Window half-widths cover the
    approach (enter early enough to set up the skill) and the exit (the
    body must clear the obstacle)."""
    c = _np(scene.center)
    h = _np(scene.half)
    a = _np(scene.active).astype(bool)
    x = float(_np(base_pos)[0])
    bottom = c[:, 2] - h[:, 2]
    top = c[:, 2] + h[:, 2]
    if element_id == 1:
        # hurdles: cost-based jump selection (forcing the jump at every
        # hurdle makes the robot fall)
        return -1
    elif element_id == 2:  # holes: elevated bars -> crouch-crawl
        obst = a & (bottom > 0.15) & (top > 0.3)
        enter, exit_ = 0.55, 0.25
    elif element_id == 3:  # cubes
        if os.environ.get("LIFELIKE_CUBE_SKILL", "mantle") == "highstep":
            # looping climb handles every step face: gate on any cube top
            obst = a & (bottom < 0.02) & (top > 0.05) & (top <= 0.3)
            enter, exit_ = 0.5, 0.4
        else:
            # running mantle: gate on the tall faces only (0.1 m aprons are
            # walkable) and only in the final approach
            obst = a & (bottom < 0.02) & (top > 0.15) & (top <= 0.3)
            enter, exit_ = 0.6, 0.5
    else:
        return 0
    near = obst & ((c[:, 0] - h[:, 0]) - x < enter) & ((c[:, 0] + h[:, 0]) - x > -exit_)
    return 1 if bool(near.any()) else 0


def build_prior_bank(model, element_id, walk_clip=SYNTHETIC, jump_clip=SYNTHETIC,
                     device="cuda"):
    """Clip bank + per-element skill priors for the traversal MPC.

    Bank: walk / run loop, running jump, the crouch-walk and high-step climb
    variants of the walk (motion_lib.crouch_variant / highstep_variant) and
    the distilled maneuvers in data/priors/ when present (tools.distill_prior):
    the hole model's fast crawl (tiled 3x with x-advanced copies, so the
    horizon's lookahead past the loop seam stays in gait) and the cube
    model's running mantle. The clips are packed on `device`.

    Returns (clips, priors, skill): priors feeds
    make_multigait_traversal_controller; skill is the second prior's
    clip-time protocol for the eval loop:
      kind='loop'  t advances 0.02 per step, wraps over skill['loop']
      kind='play'  gated play-through: t0 -> end while engaged, else rewind
    """
    walk_fr = clip_frames(walk_clip, WALK_SEED)
    jump_fr = clip_frames(jump_clip, JUMP_SEED)
    crouch_fr = motion_lib.crouch_variant(
        walk_fr, hip_delta=0.4, knee_delta=1.1,
        joint_lower=model.joint_lower, joint_upper=model.joint_upper)
    climb_fr = motion_lib.highstep_variant(
        walk_fr,
        gain=float(os.environ.get("LIFELIKE_HIGHSTEP_GAIN", 2.2)),
        lift=float(os.environ.get("LIFELIKE_HIGHSTEP_LIFT", 0.14)),
        joint_lower=model.joint_lower, joint_upper=model.joint_upper)
    bank = [walk_fr, jump_fr, crouch_fr, climb_fr]
    distilled = {}
    for name in ("hole_crawl", "cube_mantle"):
        path = os.path.join(PRIOR_DIR, f"{name}.json")
        if os.path.exists(path):
            fr = clip_frames(path, None)
            if name == "hole_crawl":
                dx = fr[-1, 0] - fr[0, 0]
                tiles = [fr]
                for i in (1, 2):
                    t2 = fr.copy()
                    t2[:, 0] += i * dx
                    tiles.append(t2)
                fr = np.concatenate(tiles, axis=0)
            distilled[name] = len(bank)
            bank.append(fr)
    clips = motion_lib.pack_clips(bank, frame_step=1.0 / 120.0, device=device)

    if element_id == 2:
        if "hole_crawl" in distilled:
            # the distilled fast crawl: the stand-height hinge relaxed to its
            # recorded base band, elevated bars crawlable, a ceiling just
            # above the crawl posture, planned near its natural speed
            crawl_w = TraversalWeights(height_min=0.14, height=8.0, pose=0.0,
                                       crawl_gap=0.18, ceiling=0.20)
            n = distilled["hole_crawl"]
            cyc = (int(clips.lengths[n]) // 3) / 120.0  # one crawl cycle
            priors = [(0, None), (n, crawl_w, 0.9)]
            skill = dict(kind="loop", loop=(0.0, 2.0 * cyc))
        else:
            crouch_w = TraversalWeights(height_min=0.06, height=2.0, pose=0.0,
                                        crawl_gap=0.18, ceiling=0.13)
            priors = [(0, None), (2, crouch_w, 0.4)]
            skill = dict(kind="loop", loop=CLIP_LOOP)
    elif element_id == 3:
        # the default here is "highstep" while gate_skill's is "mantle", as
        # in the JAX tool (ROADMAP.md note R7)
        cube_skill = os.environ.get("LIFELIKE_CUBE_SKILL", "highstep")
        if cube_skill == "highstep":
            priors = [(0, None), (3, None)]
            skill = dict(kind="loop", loop=CLIP_LOOP)
        elif "cube_mantle" in distilled:
            n = distilled["cube_mantle"]
            end = (int(clips.lengths[n]) - 1) / 120.0
            priors = [(0, None), (n, None)]
            skill = dict(kind="play", t0=0.0, end=float(end), rewind=0.06)
        else:
            priors = [(0, None), (1, None)]
            skill = dict(kind="play", t0=JUMP_T0, end=JUMP_END, rewind=0.06)
    else:
        priors = [(0, None), (1, None)]
        skill = dict(kind="play", t0=JUMP_T0, end=JUMP_END, rewind=0.06)
    return clips, priors, skill


def advance_skill_clip(t, skill, engaged):
    """Next skill-prior clip time under the skill's protocol (host-side)."""
    if skill["kind"] == "loop":
        return _advance_clip(t, skill["loop"])
    if engaged:  # play the maneuver through, then rearm
        t = min(t + 0.02, skill["end"])
        return skill["t0"] if t >= skill["end"] else t
    return max(skill["t0"], t - skill["rewind"])


def approach_speed_cap(scene, base_pos, element_id, spd_cap):
    """Slow-approach zone for hole bars: cap the commanded speed at 0.7 m/s
    while the next bar's front face is within 0.8 m, so the fold into the
    crawl happens at walking pace."""
    if element_id != 2:
        return spd_cap
    c = _np(scene.center)
    h = _np(scene.half)
    a = _np(scene.active).astype(bool)
    bars = a & ((c[:, 2] - h[:, 2]) > 0.15) & ((c[:, 2] + h[:, 2]) > 0.3)
    if not bars.any():
        return spd_cap
    ahead = (c[bars, 0] - h[bars, 0]) - float(_np(base_pos)[0])
    ahead = ahead[ahead > -0.5]
    if ahead.size and float(ahead.min()) < 0.8:
        return min(spd_cap, 0.7)
    return spd_cap


def _floor(spd, v):
    return torch.clamp_min(torch.as_tensor(spd), v)


def skill_speed_floor(scene, base_pos, element_id, gate, spd):
    """Commanded-speed floors for the hole / cube courses, off by default
    (LIFELIKE_CLIMB_SPD / LIFELIKE_CRAWL_SPD / LIFELIKE_WALK_SPD_FLOOR; 0
    disables), an opt-in experiment lever as in the JAX tool."""
    if element_id == 3:
        if gate == 1:
            climb = float(os.environ.get("LIFELIKE_CLIMB_SPD", 0))
            return _floor(spd, climb) if climb else spd
        walk = float(os.environ.get("LIFELIKE_WALK_SPD_FLOOR", 0))
        return _floor(spd, walk) if walk else spd
    if element_id == 2:
        if gate == 1:
            crawl = float(os.environ.get("LIFELIKE_CRAWL_SPD", 0))
            return _floor(spd, crawl) if crawl else spd
        # open ground: floor only outside the approach-slowdown zone
        walk = float(os.environ.get("LIFELIKE_WALK_SPD_FLOOR", 0))
        if walk and approach_speed_cap(scene, base_pos, 2, 9.9) > 9.0:
            return _floor(spd, walk)
    return spd


def traversal_setup(element_id, population, horizon, walk_clip=SYNTHETIC, jump_clip=SYNTHETIC,
                    device="cuda"):
    """(device, model, env config, clips, controller, priors, skill) of the
    traversal evaluation: the element's prior bank, the reference eval
    config's friction 0.4-1.0 with pushes on, MPPI at 2 iterations and
    sigma 0.12, float32."""
    from lifelike_tpu_torch.envs import playground
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.scene import playground_gen
    from lifelike_tpu_torch.solver import mpc_tasks
    from lifelike_tpu_torch.solver.mppi import MPPIConfig

    dev = _device.resolve_device(device)
    model = build_max_model()
    clips, priors, skill = build_prior_bank(model, element_id, walk_clip, jump_clip, dev)
    cfg = playground.PlaygroundConfig(
        scene=playground_gen.PlaygroundConfig(element_id=element_id),
        friction_range=(0.4, 1.0))
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    mcfg = MPPIConfig(horizon=horizon, population=population, iterations=2, sigma=0.12)
    ctrl = mpc_tasks.make_multigait_traversal_controller(
        model, c, cfg.params, mcfg, clips, priors=priors, reward_type=cfg.reward_type,
        max_steps=cfg.max_steps, device=dev)
    return dev, model, cfg, clips, ctrl, priors, skill


def eval_traversal(seeds, cap, element_id, population, horizon, walk_clip=SYNTHETIC,
                   jump_clip=SYNTHETIC, device="cuda", log=print):
    """Gait-prior traversal MPC closed loop, one episode per seed. Each
    result holds the JAX tool's seed / outcome / steps / reward / progress,
    plus the prior executed at each step (`sel`), the priors' weighted
    costs at each step (`prior_costs`) and each step's solve and plant time
    in ms (`solve_ms`, `plant_ms`: CUDA events on the card, the host clock
    on the CPU)."""
    from lifelike_tpu_torch.envs import playground

    dev, model, cfg, _, ctrl, priors, skill = traversal_setup(
        element_id, population, horizon, walk_clip, jump_clip, device)
    results = []
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        s, obs = playground.reset(model, cfg, gen)
        scene = host_scene(s.scene)
        d0 = float(np.linalg.norm((_np(s.target_pos) - _np(s.robot.base_pos))[:2]))
        u = torch.zeros((len(priors), horizon, 4, 3), device=dev)
        # gait section matched to the capped commanded speed (the clip walks
        # early and runs after t = 6 s)
        loop = RUN_LOOP if min(float(s.target_spd), SPD_CAP) > 1.2 else CLIP_LOOP
        t_walk = loop[0]
        t_skill = skill["t0"] if skill["kind"] == "play" else skill["loop"][0]
        outcome = "timeout"
        reward_sum, t, jumps = 0.0, 0, 0
        sels, costs, solve_ms, plant_ms = [], [], [], []
        # plan at a capped speed (the env keeps its sampled target_spd for rewards)
        spd_cmd = torch.clamp_max(s.target_spd, SPD_CAP)
        for t in range(cap):
            base = _np(s.robot.base_pos)
            gate = gate_skill(scene, base, element_id)
            spd_t = torch.clamp_max(spd_cmd, approach_speed_cap(scene, base, element_id,
                                                                SPD_CAP))
            spd_t = skill_speed_floor(scene, base, element_id, gate, spd_t)
            t_clips = torch.tensor([t_walk, t_skill], dtype=torch.float32, device=dev)
            (tgt, u, sel, diag), dt = _timed(dev, lambda: ctrl(
                gen, s.robot, s.scene, s.target_pos, spd_t, t_clips, u, gate))
            solve_ms.append(1e3 * dt)
            (s, obs, r, done, info), dt = _timed(dev, lambda: playground.step(
                model, cfg, s, tgt - s.robot.joint_pos, gen))
            plant_ms.append(1e3 * dt)
            t_walk = _advance_clip(t_walk, loop)
            sels.append(int(sel))
            costs.append(_np(diag["prior_costs"]).tolist())
            engaged = sels[-1] == 1 if gate < 0 else gate == 1
            jumps += engaged
            t_skill = advance_skill_clip(t_skill, skill, engaged)
            reward_sum += float(r)
            if bool(done):
                outcome = ("reached" if bool(info["reached"])
                           else "fall" if bool(info["fall"]) else "timeout")
                break
        d1 = float(np.linalg.norm((_np(s.target_pos) - _np(s.robot.base_pos))[:2]))
        results.append(dict(seed=seed, outcome=outcome, steps=t + 1, reward=reward_sum,
                            progress=d0 - d1, sel=sels, prior_costs=costs, solve_ms=solve_ms,
                            plant_ms=plant_ms))
        log(f"  element {element_id} seed {seed}: {outcome} in {t + 1} steps "
            f"(progress {d0 - d1:.2f} m of {d0:.2f}, skill gated {jumps} steps)")
    return results


def chase_setup(population, horizon, walk_clip=SYNTHETIC, device="cuda"):
    """(device, model, env config, solver) of the chase evaluations: the
    gait chase solver for both robots (one MPPI iteration, one best-response
    round, sigma 0.12) on the walk clip, the default ChaseTagConfig plant."""
    from lifelike_tpu_torch.envs import chase_tag
    from lifelike_tpu_torch.physics import batched as B
    from lifelike_tpu_torch.robot.model import build_max_model
    from lifelike_tpu_torch.solver import mpc_tasks
    from lifelike_tpu_torch.solver.mppi import MPPIConfig

    dev = _device.resolve_device(device)
    model = build_max_model()
    cfg = chase_tag.ChaseTagConfig()
    c = B.tl_constants(model, dtype=torch.float32, device=dev)
    clips = motion_lib.pack_clips([clip_frames(walk_clip, WALK_SEED)], frame_step=1.0 / 120.0,
                                  device=dev)
    mcfg = MPPIConfig(horizon=horizon, population=population, iterations=1, sigma=0.12)
    solver = mpc_tasks.make_gait_chase_solver(model, c, cfg.params, mcfg, clips,
                                              n_best_response=1, device=dev)
    return dev, model, cfg, solver


def eval_chase(seeds, cap, population, horizon, standing_escapee, walk_clip=SYNTHETIC,
               device="cuda", log=print):
    """Chaser (robot 0, the contact-detecting toucher) against a standing or
    a solver-driven escapee; success = catch within `cap` steps."""
    from lifelike_tpu_torch.envs import chase_tag

    dev, model, cfg, solver = chase_setup(population, horizon, walk_clip, device)
    results = []
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(2000 + seed)
        s, obs = chase_tag.reset(model, cfg, gen)
        s = s._replace(with_flag=torch.tensor([True, False], device=dev))
        u = torch.zeros((2, horizon, 4, 3), device=dev)
        outcome, t = "timeout", 0
        t_clip = CLIP_LOOP[0]
        for t in range(cap):
            tgt, u, _ = solver(gen, s.robots, s.scene, s.flag_pos, s.with_flag,
                               torch.tensor(t_clip, dtype=torch.float32, device=dev), u)
            t_clip = _advance_clip(t_clip)
            action = tgt - s.robots.joint_pos
            if standing_escapee:
                action[1] = 0.0  # the escapee holds its pose
            s, obs, r, done, info = chase_tag.step(model, cfg, s, action, gen)
            if bool(done):
                outcome = "caught" if bool(info["caught"]) else "fall/timeout"
                break
        results.append(dict(seed=seed, outcome=outcome, steps=t + 1))
        log(f"  chase ({'standing' if standing_escapee else 'fleeing'}) seed {seed}: "
            f"{outcome} in {t + 1} steps")
    return results


def eval_chase_game(seeds, cap, population, horizon, walk_clip=SYNTHETIC, device="cuda",
                    log=print):
    """Full Chase Tag games, both robots solver-driven: flag grabs swap roles
    (the flag teleports), +-1 on the switch frame, terminal +-1 on the
    catch. Records per-episode switches, outcome, reward sums and the
    average speeds of the game's info."""
    from lifelike_tpu_torch.envs import chase_tag

    dev, model, cfg, solver = chase_setup(population, horizon, walk_clip, device)
    results = []
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(3000 + seed)
        s, obs = chase_tag.reset(model, cfg, gen)
        u = torch.zeros((2, horizon, 4, 3), device=dev)
        t_clip = CLIP_LOOP[0]
        switches, r_sum = 0, np.zeros(2)
        outcome, t, info = "timeout", 0, {}
        for t in range(cap):
            wf_before = _np(s.with_flag)
            tgt, u, _ = solver(gen, s.robots, s.scene, s.flag_pos, s.with_flag,
                               torch.tensor(t_clip, dtype=torch.float32, device=dev), u)
            t_clip = _advance_clip(t_clip)
            s, obs, r, done, info = chase_tag.step(model, cfg, s, tgt - s.robots.joint_pos, gen)
            r_sum += _np(r).astype(np.float64)
            if (_np(s.with_flag) != wf_before).any():
                switches += 1
            if bool(done):
                outcome = "caught" if bool(info["caught"]) else (
                    "fall" if t + 1 < cap else "timeout")
                break
        results.append(dict(
            seed=seed, outcome=outcome, steps=t + 1, switches=switches,
            r0=float(r_sum[0]), r1=float(r_sum[1]),
            avg_spd0=float(info.get("avg_spd0", 0.0)),
            avg_spd1=float(info.get("avg_spd1", 0.0)),
        ))
        log(f"  game seed {seed}: {outcome} in {t + 1} steps, {switches} flag switches, "
            f"rewards ({r_sum[0]:+.0f}, {r_sum[1]:+.0f}), avg_spd "
            f"({results[-1]['avg_spd0']:.2f}, {results[-1]['avg_spd1']:.2f})")
    return results


# The reference eval env configs (test_environmental_level_env.py:16-49 and
# test_strategic_level_env.py:13-42): evaluating the recurrent checkpoints
# without them (default joystick env, teleporting targets) makes competent
# models look broken.
EVAL_ENV_CONFIG = {
    "pmc": "",
    "epmc_hurdle": (
        "{'kp': 50.0, 'kd': 0.5, 'max_tau': 16, 'max_steps': 1000, "
        "'env_randomize_config': {'element_id': 1, "
        "'friction_range': [0.4, 1.0], "
        "'disturb_force_config': {'start_time': 0.5, 'interval_time': 1.0, "
        "'duration_time': 0.2, 'horizontal_force': [0, 50], "
        "'vertical_force': [0, 10]}, "
        "'cmd_vary_freq_range': [9999, 10000], "
        "'target_spd_range': [3.0, 3.0]}}"
    ),
    "epmc_hole": (
        "{'kp': 50.0, 'kd': 0.5, 'max_tau': 16, 'max_steps': 1000, "
        "'env_randomize_config': {'element_id': 2, "
        "'friction_range': [0.4, 1.0], "
        "'disturb_force_config': {'start_time': 0.5, 'interval_time': 1.0, "
        "'duration_time': 0.2, 'horizontal_force': [0, 50], "
        "'vertical_force': [0, 10]}, "
        "'cmd_vary_freq_range': [9999, 10000], "
        "'target_spd_range': [3.0, 3.0], 'hole_config': {'min_gap_height': 0.25, "
        "'max_gap_height': 0.25}}}"
    ),
    "epmc_cube": (
        "{'kp': 50.0, 'kd': 0.5, 'max_tau': 16, 'max_steps': 1000, "
        "'env_randomize_config': {'element_id': 3, "
        "'friction_range': [0.4, 1.0], "
        "'disturb_force_config': {'start_time': 0.5, 'interval_time': 1.0, "
        "'duration_time': 0.2, 'horizontal_force': [0, 50], "
        "'vertical_force': [0, 10]}, "
        "'cmd_vary_freq_range': [9999, 10000], "
        "'target_spd_range': [3.0, 3.0]}}"
    ),
    "sepmc": (
        "{'kp': 50.0, 'kd': 0.5, 'max_tau': 16, 'max_steps': 1000, "
        "'env_randomize_config': {'friction_range': [0.4, 1.0], "
        "'disturb_force_config': {'start_time': 0.5, 'interval_time': 1.0, "
        "'duration_time': 0.2, 'horizontal_force': [0, 50], "
        "'vertical_force': [0, 10]}, 'control_spd': 1.0}, "
        "'element_config': {'rand_cube': False, 'hurdle': False, "
        "'hole': False}}"
    ),
}


def parse_episodes(text):
    """(reward, length, outcome flags) of each episode line bin/run_eval
    printed."""
    eps = []
    for ln in text.splitlines():
        flags = "".join(f" {name}" for name, pat in
                        (("REACHED", r"'reached': 1\.0"), ("caught", r"'caught': 1\.0"),
                         ("fall", r"'fall': 1\.0"))
                        if re.search(pat, ln))
        m = re.search(r"episode \d+: reward(?:_sum)? ([-\d.]+) len (\d+)", ln)
        if m:
            eps.append((float(m.group(1)), int(m.group(2)), flags))
        m2 = re.search(r"episode \d+: rewards \[([-\d., ]+)\] len (\d+)", ln)
        if m2:
            vals = [float(v) for v in m2.group(1).split(",")]
            eps.append((vals[0], int(m2.group(2)), flags))
    return eps


def eval_checkpoints(episodes, max_steps, seeds=3, models=None, device="cuda", log=print):
    """Per-episode rewards of the checkpoints `models` (task -> path;
    default MODELS) under the reference eval env configs, over `seeds`
    seeds x `episodes` episodes, each seed one `python -m
    lifelike_tpu_torch.bin.run_eval --device=<device>` subprocess. A task
    without a model gets no run and no episodes (rc None)."""
    models = MODELS if models is None else models
    rows = {}
    for task in CHECKPOINT_TASKS:
        path = models.get(task)
        if not path:
            rows[task] = dict(episodes=[], rc=None)
            log(f"  checkpoint {task}: no model")
            continue
        cli_task = "epmc" if task.startswith("epmc") else task
        eps, rc = [], 0
        for seed in range(seeds):
            cmd = [sys.executable, "-m", "lifelike_tpu_torch.bin.run_eval", f"--task={cli_task}",
                   f"--model_path={path}", f"--device={device}", f"--episodes={episodes}",
                   f"--max_steps={max_steps}", f"--seed={seed}"]
            if EVAL_ENV_CONFIG[task]:
                cmd.append(f"--env_config={EVAL_ENV_CONFIG[task]}")
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=7200, cwd=REPO)
            rc = rc or out.returncode
            eps += parse_episodes(out.stdout + "\n" + out.stderr)
        rows[task] = dict(episodes=eps, rc=rc)
        log(f"  checkpoint {task}: {len(eps)} eps {[e[2] or 'run' for e in eps]} (rc={rc})")
    return rows


def parse_models(spec):
    """--models "task=path,..." -> {task: path}."""
    out = {}
    for item in filter(None, spec.split(",")):
        task, _, path = item.partition("=")
        if task not in CHECKPOINT_TASKS or not path:
            raise ValueError(f"--models: {item!r} is not task=path with task in "
                             f"{CHECKPOINT_TASKS}")
        out[task] = path
    return out


def arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="report file (default: stdout)")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--cap", type=int, default=300)
    ap.add_argument("--population", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=12)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--ckpt_seeds", type=int, default=3)
    ap.add_argument("--skip_checkpoints", action="store_true")
    ap.add_argument("--only", default="", help="traversal|chase|checkpoints: run one section")
    ap.add_argument("--elements", default="1,2,3",
                    help="comma-separated element_ids for the traversal section")
    ap.add_argument("--walk_clip", default=SYNTHETIC,
                    help="walk / run clip file, or 'synthetic' (30 s, seed 0)")
    ap.add_argument("--jump_clip", default=SYNTHETIC,
                    help="jump clip file, or 'synthetic' (30 s, seed 1)")
    ap.add_argument("--models", default=None,
                    help="checkpoints as task=path,... (tasks: " + ", ".join(CHECKPOINT_TASKS)
                         + "; default: pmc=" + os.path.relpath(MODELS["pmc"], REPO) + ")")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return ap


def main(argv=None, log=print):
    """Run the sections and write the report; returns its text."""
    args = arg_parser().parse_args(argv)
    dev = _device.resolve_device(args.device)
    models = MODELS if args.models is None else parse_models(args.models)
    elements = tuple(int(e) for e in args.elements.split(",") if e)
    clips = dict(walk_clip=args.walk_clip, device=dev, log=log)

    t0 = time.time()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = [
        "# EVAL — closed-loop task success (solver) + checkpoints (lifelike_tpu_torch)",
        "",
        f"Generated by `python -m lifelike_tpu_torch.tools.make_eval --seeds {args.seeds} "
        f"--cap {args.cap} --population {args.population} --horizon {args.horizon}` on "
        f"`{where}`, {datetime.date.today().isoformat()}; walk clip {args.walk_clip}, "
        f"jump clip {args.jump_clip}.",
        "",
        "## 1. EPMC traversal: solver drives the playground env closed-loop",
        "",
        "Success = reach within 0.5 m of the course target without falling "
        f"(playground done convention), cap {args.cap} control steps "
        "(friction 0.4-1.0, pushes, target speed per reset).",
        "",
        "| course | success | outcomes (per seed) | mean steps |",
        "|---|---|---|---|",
    ]
    for eid in (() if args.only in ("chase", "checkpoints") else elements):
        log(f"traversal element {eid} ({ELEMENT_NAMES[eid]}):")
        res = eval_traversal(args.seeds, args.cap, eid, args.population, args.horizon,
                             jump_clip=args.jump_clip, **clips)
        n_ok = sum(r["outcome"] == "reached" for r in res)
        lines.append(
            f"| {ELEMENT_NAMES[eid]} (element_id={eid}) | **{n_ok}/{len(res)}** | "
            + ", ".join(f"{r['outcome']}({r['progress']:.1f}m)" for r in res)
            + " | " + f"{np.mean([r['steps'] for r in res]):.0f} |")

    lines += [
        "",
        "## 2. SEPMC chase: solver catches in the V4 arena",
        "",
        f"Success = chaser's leg / wheel links contact the escapee within {args.cap} steps.",
        "",
        "| escapee | catch | outcomes | mean steps |",
        "|---|---|---|---|",
    ]
    for standing in (() if args.only in ("traversal", "checkpoints") else (True, False)):
        log(f"chase standing={standing}:")
        res = eval_chase(args.seeds, args.cap, args.population, args.horizon, standing,
                         **clips)
        n_ok = sum(r["outcome"] == "caught" for r in res)
        lines.append(
            f"| {'standing (hold pose)' if standing else 'solver-driven (fleeing)'} | "
            f"**{n_ok}/{len(res)}** | " + ", ".join(r["outcome"] for r in res) + " | "
            + f"{np.mean([r['steps'] for r in res]):.0f} |")

    if args.only not in ("traversal", "checkpoints"):
        lines += [
            "",
            "### Full games: flag possession, role swaps, +-1 accounting",
            "",
            "| seed | outcome | steps | flag switches | rewards (r0, r1) | avg_spd0/1 |",
            "|---|---|---|---|---|---|",
        ]
        log("full chase games:")
        for r in eval_chase_game(args.seeds, args.cap, args.population, args.horizon, **clips):
            lines.append(
                f"| {r['seed']} | {r['outcome']} | {r['steps']} | {r['switches']} | "
                f"({r['r0']:+.0f}, {r['r1']:+.0f}) | {r['avg_spd0']:.2f} / "
                f"{r['avg_spd1']:.2f} |")

    if not args.skip_checkpoints:
        lines += [
            "",
            "## 3. Checkpoints (bin/run_eval)",
            "",
            f"Per-episode reward sums, {args.ckpt_seeds} seeds x {args.episodes} episodes x "
            f"{args.cap} step cap, on `{where}`.",
            "",
            "| checkpoint | n | reward mean+-std | len mean | outcomes | "
            "per-episode (reward, len) |",
            "|---|---|---|---|---|---|",
        ]
        log("checkpoint evals:")
        rows = eval_checkpoints(args.episodes, args.cap, seeds=args.ckpt_seeds, models=models,
                                device=str(dev), log=log)
        for task, row in rows.items():
            ep = row["episodes"]
            name = os.path.basename(models[task]) if task in models else f"{task} (no model)"
            if not ep:
                rc = "-" if row["rc"] is None else row["rc"]
                lines.append(f"| {name} | 0 | - | - | rc={rc} | |")
                continue
            rs = np.asarray([e[0] for e in ep])
            ls = np.asarray([e[1] for e in ep])
            oc = Counter((e[2].strip() or "ran") for e in ep)
            ocs = ", ".join(f"{k} {v}" for k, v in sorted(oc.items()))
            detail = ", ".join(f"({r:.2f}, {n}{fl})" for r, n, fl in ep)
            lines.append(f"| {name} | {len(ep)} | {rs.mean():.2f}+-{rs.std():.2f} | "
                         f"{ls.mean():.0f} | {ocs} | {detail} |")

    lines += ["", f"Total eval wall time: {time.time() - t0:.0f} s.", ""]
    text = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        log(f"wrote {args.out} in {time.time() - t0:.0f} s")
    else:
        sys.stdout.write(text)
        sys.stdout.flush()
    return text


if __name__ == "__main__":
    main(sys.argv[1:])

"""Step-level telemetry for one closed-loop traversal episode.

Port of tools/debug_traversal.py: builds the controller and the prior bank
through tools.make_eval exactly, but prints the robot pose, gate state and
the priors' costs every --log_every steps — the tool that localizes where a
course run stalls (approach, bar contact, crawl, exit). Runs on the card
unless --device=cpu.

  python -m lifelike_tpu_torch.tools.debug_traversal --element 2 --seed 0 --cap 400
"""
import argparse
import sys

import numpy as np
import torch

from lifelike_tpu_torch.tools import make_eval as me


def arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--element", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cap", type=int, default=400)
    ap.add_argument("--population", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--spd_cap", type=float, default=1.3)
    ap.add_argument("--clip_rate", type=float, default=1.0,
                    help="skill-clip playback rate (crawl cadence)")
    ap.add_argument("--walk_clip", default=me.SYNTHETIC)
    ap.add_argument("--jump_clip", default=me.SYNTHETIC)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return ap


def main(argv=None, log=print):
    """Run one episode; returns its final (x, y) and whether it ended."""
    from lifelike_tpu_torch.envs import playground

    args = arg_parser().parse_args(argv)
    element_id = args.element
    dev, model, cfg, _, ctrl, priors, skill = me.traversal_setup(
        element_id, args.population, args.horizon, args.walk_clip, args.jump_clip, args.device)
    gen = torch.Generator(device=dev).manual_seed(1000 + args.seed)
    s, obs = playground.reset(model, cfg, gen)
    scene = me.host_scene(s.scene)
    cnp, hnp, anp = scene.center, scene.half, scene.active.astype(bool)
    bars = anp & ((cnp[:, 2] - hnp[:, 2]) > 0.15)
    grounds = anp & ((cnp[:, 2] - hnp[:, 2]) < 0.02) & ((cnp[:, 2] + hnp[:, 2]) > 0.03)
    log(f"target: {me._np(s.target_pos)[:2]} target_spd: {float(s.target_spd)}")
    which = bars if element_id == 2 else grounds
    log("obstacle x-spans: " + str([
        (round(float(cnp[i, 0] - hnp[i, 0]), 2), round(float(cnp[i, 0] + hnp[i, 0]), 2),
         round(float(cnp[i, 2] - hnp[i, 2]), 2), round(float(cnp[i, 2] + hnp[i, 2]), 2))
        for i in np.where(which)[0]]))

    u = torch.zeros((len(priors), args.horizon, 4, 3), device=dev)
    loop = me.RUN_LOOP if min(float(s.target_spd), args.spd_cap) > 1.2 else me.CLIP_LOOP
    t_walk = loop[0]
    t_skill = skill["t0"] if skill["kind"] == "play" else skill["loop"][0]
    spd_cmd = torch.clamp_max(s.target_spd, args.spd_cap)
    done = False
    for t in range(args.cap):
        base = me._np(s.robot.base_pos)
        gate = me.gate_skill(scene, base, element_id)
        spd_t = torch.clamp_max(spd_cmd, me.approach_speed_cap(scene, base, element_id,
                                                               args.spd_cap))
        spd_t = me.skill_speed_floor(scene, base, element_id, gate, spd_t)
        t_clips = torch.tensor([t_walk, t_skill], dtype=torch.float32, device=dev)
        tgt, u, sel, diag = ctrl(gen, s.robot, s.scene, s.target_pos, spd_t, t_clips, u, gate)
        s, obs, r, done, info = playground.step(model, cfg, s, tgt - s.robot.joint_pos, gen)
        t_walk = me._advance_clip(t_walk, loop)
        engaged = int(sel) == 1 if gate < 0 else gate == 1
        if skill["kind"] == "loop" and args.clip_rate != 1.0:
            t_skill += 0.02 * args.clip_rate
            if t_skill > skill["loop"][1]:
                t_skill = skill["loop"][0]
        else:
            t_skill = me.advance_skill_clip(t_skill, skill, engaged)
        if t % args.log_every == 0:
            p = me._np(s.robot.base_pos)
            v = me._np(s.robot.base_lin_vel)
            q = me._np(s.robot.base_orn)
            upz = 1 - 2 * (q[0] ** 2 + q[1] ** 2)
            pc = me._np(diag["prior_costs"])
            log(f"t={t:4d} x={p[0]:+.2f} y={p[1]:+.2f} z={p[2]:.3f} vx={v[0]:+.2f} "
                f"upz={upz:+.2f} gate={gate} costs=[{pc[0]:.1f},{pc[1]:.1f}]")
        if bool(done):
            log(f"DONE at t={t}: reached={bool(info['reached'])} fall={bool(info['fall'])}")
            break
    p = me._np(s.robot.base_pos)
    log(f"final x={p[0]:+.2f} y={p[1]:+.2f}")
    return (float(p[0]), float(p[1])), bool(done)


if __name__ == "__main__":
    main(sys.argv[1:])

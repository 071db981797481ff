"""Distill an EPMC policy into a solver gait-prior clip.

Port of tools/distill_prior.py. The reference's environmental-level models
traverse hole bars and cube steps with maneuvers the mocap library lacks
(no crawl or mantle clip; its EPMC learns them through the codebook). The
traversal MPC needs them as gait priors
(solver.mpc_tasks.make_multigait_traversal_controller). This tool:

  1. rolls the model (a reference TLeague checkpoint, read by
     compat.tleague_import) closed loop in envs.playground under the
     reference eval config (tools.make_eval.EVAL_ENV_CONFIG), on the card
     unless --device=cpu;
  2. mines the trajectory for the element's maneuver —
       holes: the fastest sustained crouch-crawl window (base z between
              z_min and z_max throughout, forward speed maximized);
       cubes: the cleanest mantle (base z rises >= 0.18 m while advancing);
  3. re-origins the window (x = y = 0, heading +x), resamples the 50 Hz
     control-step states to 120 Hz clip frames and writes a
     reference-format clip JSON {"FrameDuration": 1/120, "Frames": [[pos 3,
     quat xyzw 4, joints 12], ...]}, by default into the port's
     data/priors/, which tools.make_eval's prior bank reads.

  python -m lifelike_tpu_torch.tools.distill_prior --task hole --model_path M.model
  python -m lifelike_tpu_torch.tools.distill_prior --task cube --model_path M.model --out F.json
"""
import argparse
import ast
import json
import os
import sys

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.tools.make_eval import EVAL_ENV_CONFIG, PRIOR_DIR


def roll_policy(task, episodes, max_steps, seed, model_path, device="cuda", log=print):
    """Closed-loop episodes of the EPMC policy `model_path` (a reference
    checkpoint path, a TLeagueModel or its flat array list) with the
    policy's mean action and sampled skill index; returns per-episode dicts
    of the robot states (T, 19) [base_pos, base_orn, joint_pos] and whether
    it fell."""
    from lifelike_tpu_torch.compat import tleague_import
    from lifelike_tpu_torch.envs import factory
    from lifelike_tpu_torch.models import epmc, params

    dev = _device.resolve_device(device)
    env_config = ast.literal_eval(EVAL_ENV_CONFIG[f"epmc_{task}"])
    env_config["max_steps"] = max_steps
    bundle = factory.create_playground_game(device=dev, **env_config)
    net = epmc.EPMCNet(generator=torch.Generator().manual_seed(seed))
    epmc.load_params(net, tleague_import.import_epmc(model_path, params.flax_tree(net)))
    net = net.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros((), device=dev)

    eps = []
    for ep in range(episodes):
        env_state, obs = bundle.reset(gen)
        hs = net.initial_state(())
        rows, fell = [], False
        for _ in range(max_steps):
            with torch.no_grad():
                out = net(obs, hs, mask, generator=gen)
            hs = out.hs
            env_state, obs, r, done, info = bundle.step(
                env_state, {"A_Z": out.z_idx, "A_LLC": out.mean}, gen)
            rb = env_state.robot
            rows.append(torch.cat([rb.base_pos, rb.base_orn, rb.joint_pos]))
            if bool(done):
                fell = bool(info["fall"])
                break
        states = torch.stack(rows).cpu().numpy()
        eps.append(dict(states=states, fell=fell))
        log(f"  {task} ep {ep}: {len(rows)} steps, x {states[-1][0]:.1f} m, fell={fell}")
    return eps


def find_crawl(eps, z_max=0.26, z_min=0.10, widths=(60, 75, 100, 125)):
    """Fastest sustained-crouch window across episodes: (ep, t0, W, speed)."""
    best = None
    for ei, ep in enumerate(eps):
        s = ep["states"]
        x, z = s[:, 0], s[:, 2]
        for W in widths:
            for t0 in range(0, len(s) - W):
                zz = z[t0:t0 + W]
                if zz.max() < z_max and zz.min() > z_min:
                    spd = (x[t0 + W - 1] - x[t0]) / (W * 0.02)
                    if best is None or spd > best[3]:
                        best = (ei, t0, W, spd)
    return best


def find_mantle(eps, rise_min=0.18, span=(10, 60), pre=12, post=15):
    """Cleanest mantle: base z rises >= rise_min within `span` steps while
    advancing; the window padded by pre / post approach / landing steps.
    Picks the fastest qualifying mount (max forward speed over the
    window)."""
    best = None
    for ei, ep in enumerate(eps):
        s = ep["states"]
        x, z = s[:, 0], s[:, 2]
        n = len(s)
        for t0 in range(pre, n - span[0] - post):
            for dt in range(span[0], min(span[1], n - t0 - post)):
                rise = z[t0 + dt] - z[t0]
                if rise >= rise_min and x[t0 + dt] > x[t0] + 0.2:
                    a, b = t0 - pre, t0 + dt + post
                    spd = (x[b - 1] - x[a]) / ((b - a) * 0.02)
                    if best is None or spd > best[3]:
                        best = (ei, a, b - a, spd)
                    break  # smallest qualifying dt for this t0
    return best


def _yaw_of(q):
    """Heading yaw of quaternion(s) xyzw: forward = R @ [1, 0, 0]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    fx = 1.0 - 2.0 * (y * y + z * z)
    fy = 2.0 * (x * y + w * z)
    return np.arctan2(fy, fx)


def _quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def reorient_resample(states, fps_in=50.0, fps_out=120.0):
    """Re-origin to x = y = 0 / heading +x at frame 0, resample to the clip
    rate (positions and joints linearly, the quaternion by nlerp)."""
    pos = states[:, 0:3].copy()
    quat = states[:, 3:7].copy()
    joints = states[:, 7:19]
    yaw0 = float(_yaw_of(quat[0]))
    c, s = np.cos(-yaw0), np.sin(-yaw0)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    pos = (pos - [pos[0, 0], pos[0, 1], 0.0]) @ rot.T
    qz = np.array([0.0, 0.0, np.sin(-yaw0 / 2.0), np.cos(-yaw0 / 2.0)])
    quat = _quat_mul(np.broadcast_to(qz, quat.shape), quat)

    t_in = np.arange(len(states)) / fps_in
    t_out = np.arange(int(np.floor(t_in[-1] * fps_out)) + 1) / fps_out
    cols = []
    for arr in (pos, quat, joints):
        cols.append(np.stack([np.interp(t_out, t_in, arr[:, i]) for i in range(arr.shape[1])],
                             axis=1))
    pos_o, quat_o, joints_o = cols
    quat_o /= np.linalg.norm(quat_o, axis=-1, keepdims=True)  # nlerp
    return np.concatenate([pos_o, quat_o, joints_o], axis=1)


def write_prior(out, frames, source_model, episode, window, speed):
    """Write `frames` (N, 19) as a reference-format clip JSON at `out`."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "FrameDuration": 1.0 / 120.0,
            "Frames": [[round(float(v), 6) for v in row] for row in frames],
            "Distilled": {
                "source_model": source_model,
                "episode": int(episode), "window_steps": [int(window[0]), int(window[1])],
                "mean_speed_mps": round(float(speed), 3),
            },
        }, f)


def arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=("hole", "cube"), required=True)
    ap.add_argument("--model_path", required=True,
                    help="reference environmental_level_{hole,cube}.model checkpoint")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="clip file (default: data/priors/<name>.json)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return ap


def main(argv=None, log=print):
    """Distill and write the prior; returns (path, frames)."""
    args = arg_parser().parse_args(argv)
    eps = roll_policy(args.task, args.episodes, args.max_steps, args.seed, args.model_path,
                      args.device, log)
    if args.task == "hole":
        hit, name = find_crawl(eps), "hole_crawl"
    else:
        hit, name = find_mantle(eps), "cube_mantle"
    if hit is None:
        raise SystemExit("no qualifying maneuver window found")
    ei, t0, W, spd = hit
    log(f"selected ep {ei} steps [{t0}, {t0 + W}) speed {spd:.2f} m/s")
    frames = reorient_resample(eps[ei]["states"][t0:t0 + W])
    out = args.out or os.path.join(PRIOR_DIR, f"{name}.json")
    write_prior(out, frames, os.path.basename(args.model_path), ei, (t0, t0 + W), spd)
    log(f"wrote {out}: {len(frames)} frames @120 Hz ({len(frames) / 120.0:.2f} s), z range "
        f"[{frames[:, 2].min():.2f}, {frames[:, 2].max():.2f}]")
    return out, frames


if __name__ == "__main__":
    main(sys.argv[1:])

"""PMC training evidence of the port: reward curve + checkpoint eval table.

Port of tools/pmc_curve.py. It turns a bin/run_learner PMC run into a
Markdown section:

  1. parse the learner log (reward_mean / return / perplexity / VQ loss per
     logged update) into a downsampled curve table;
  2. evaluate policies on the same tracking env through the port's
     bin/run_eval (argmax actions, N episodes) in a subprocess on --device:
     the run's latest pool checkpoint and a random-init policy (the floor).
     The imported reference primitive_level.model (the ceiling) is the
     TLeague file --imported names; without one its row says "absent".

  python -m lifelike_tpu_torch.tools.pmc_curve --run_dir runs/pmc_r5 [--episodes 5]
  python -m lifelike_tpu_torch.tools.pmc_curve --device=cpu --episodes=1 --max_steps=10

The section goes to stdout unless --out names a file (appended to). The
learner log may be the JAX run_learner's or the port's: both print the
`update N: {metrics, sorted}` line that parse_log reads.
"""
import argparse
import glob
import os
import re
import subprocess
import sys

import numpy as np

from lifelike_tpu_torch import _device

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)

_UPDATE = re.compile(
    r"update (\d+): .*'e_latent_loss': ([-\w.]+).*'perplexity': "
    r"([-\w.]+).*'return': ([-\w.]+).*'reward_mean': ([-\w.]+).*"
    r"env steps/s (\d+)"
)
_EPISODE = re.compile(r"episode \d+: reward_sum ([-\d.]+) len (\d+)")


def parse_log(path):
    """[(update, reward_mean, ret, perplexity, e_latent_loss, steps_s)], one
    row per update: a resumed run re-logs earlier updates, and the last
    occurrence wins."""
    by_update = {}
    with open(path) as f:
        for ln in f:
            m = _UPDATE.search(ln)
            if not m:
                continue
            try:
                row = (int(m.group(1)), float(m.group(5)), float(m.group(4)),
                       float(m.group(3)), float(m.group(2)), int(m.group(6)))
            except ValueError:
                continue  # nan rows
            by_update[row[0]] = row
    return [by_update[k] for k in sorted(by_update)]


def eval_policy(model_path, episodes, max_steps, seed=0, device="cuda"):
    """(episode rewards, episode lengths, return code) of the port's
    bin/run_eval --task=pmc on `device`, read from its stdout."""
    cmd = [sys.executable, "-m", "lifelike_tpu_torch.bin.run_eval", "--task=pmc",
           f"--device={device}", f"--episodes={episodes}", f"--max_steps={max_steps}",
           f"--seed={seed}"]
    if model_path:
        cmd.append(f"--model_path={model_path}")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=7200, cwd=REPO)
    rews, lens = [], []
    for ln in out.stdout.splitlines():
        m = _EPISODE.search(ln)
        if m:
            rews.append(float(m.group(1)))
            lens.append(int(m.group(2)))
    return rews, lens, out.returncode


def curve_lines(rows, points):
    """The section's heading and its downsampled curve table."""
    idx = np.unique(np.linspace(0, len(rows) - 1, points).astype(int))
    n = rows[-1][0] + 1
    lines = [
        "",
        "## From-scratch PMC training (bin/run_learner)",
        "",
        f"Reference recipe hyperparameters (train_scripts/pmc_train.sh: lr 1e-5, "
        f"gamma=lam=0.95, clip 0.1, 256 envs x 128-step unrolls = 32768 env steps/update), "
        f"prioritized clip resampling, float32 (the port trains with TF32 off). "
        f"{n} updates = {n * 32768 / 1e6:.0f}M env steps.",
        "",
        "| update | reward/step | return | VQ perplexity | e_latent | env steps/s |",
        "|---|---|---|---|---|---|",
    ]
    for i in idx:
        u, rm, ret, per, el, sps = rows[i]
        lines.append(f"| {u} | {rm:.3f} | {ret:.3f} | {per:.1f} | {el:.3f} | {sps} |")
    return lines


def eval_lines(run_dir, episodes, max_steps, device, imported="", log=print):
    """The held-out evaluation table: random init, the run's latest pool
    checkpoint and the imported reference model `imported` (absent: said
    so)."""
    pool = sorted(glob.glob(os.path.join(run_dir, "pool", "*.model")))
    if not pool:
        raise FileNotFoundError(f"no pool checkpoints in {run_dir}/pool")
    trained = pool[-1]
    lines = [
        "",
        f"Held-out eval on the port's tracking env ({device}; argmax actions, {episodes} "
        f"episodes x {max_steps} cap, random clips/offsets per reset). Random init is the "
        f"floor, the imported reference PMC the ceiling.",
        "",
        "| policy | reward sum mean+-std | episode len mean |",
        "|---|---|---|",
    ]
    for name, path in (("random init", ""), (f"trained ({os.path.basename(trained)})", trained),
                       ("imported primitive_level.model",
                        imported if imported and os.path.exists(imported) else None)):
        if path is None:
            lines.append(f"| {name} | absent | |")
            log(f"  {name}: absent")
            continue
        rews, lens, rc = eval_policy(path, episodes, max_steps, device=device)
        if rews:
            lines.append(f"| {name} | {np.mean(rews):.2f}+-{np.std(rews):.2f} | "
                         f"{np.mean(lens):.0f} |")
        else:
            lines.append(f"| {name} | rc={rc} | |")
        log(f"  {name}: {[round(r, 2) for r in rews]}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", default=os.path.join(REPO, "runs/pmc_r5"))
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--max_steps", type=int, default=400)
    ap.add_argument("--points", type=int, default=16)
    ap.add_argument("--out", default="", help="file to append the section to (default stdout)")
    ap.add_argument("--no_eval", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--imported", default="",
                    help="the reference's imported primitive_level.model (TLeague file)")
    args = ap.parse_args(argv)
    device = str(_device.resolve_device(args.device))

    rows = parse_log(os.path.join(args.run_dir, "train.log"))
    if not rows:
        raise ValueError("no parseable updates in the log")
    lines = curve_lines(rows, args.points)
    if not args.no_eval:
        lines += eval_lines(args.run_dir, args.episodes, args.max_steps, device,
                            args.imported)
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "a") as f:
            f.write(text)
        print(f"appended PMC training section to {args.out}")
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()

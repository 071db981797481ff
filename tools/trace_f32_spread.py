#!/usr/bin/env python
"""float32 spread of the hard-contact plant over the golden traces: the JAX
reference beside the PyTorch port, from the same starts.

Over the traces' 50 control steps, float32 rounding is amplified chaotically
through contact (tests/test_impulse_contact.py), so one float32 run's error
against a golden trace is one draw from a spread. This script measures the
spread for the JAX plant (lifelike_tpu.physics.impulse.control_step, XLA on
the CPU) and for the port's plant (lifelike_tpu_torch.physics.impulse, the
plain PGS sweep on the CPU) from the starts that chip_smoke.py phase 8b steps
through the CUDA sweep: per trace the trace's own start and members - 1
starts whose joint positions are moved by 1e-6 rad draws
(lifelike_tpu_torch.physics.oracle_traces.start_shifts, seed 0). Walk, run
and stand are stepped as one batch with their own targets, hurdle through
its box scene. It also runs each trace once, unbatched, as the JAX test
does.

  python tools/trace_f32_spread.py [--members 64] [--out FILE]

Per trace it prints the quantiles (0/25/50/75/100 %) over the starts of the
largest |joint_pos - trace| over the 50 steps, how many starts are at or over
the JAX tests' ceiling, and the own start's error; then one JSON line. The
JAX side takes about a minute; the port's plain sweep several more.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as the JAX tests run; the plant is float32

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lifelike_tpu.physics import impulse as jimpulse  # noqa: E402
from lifelike_tpu.physics.dynamics import RobotState as JRobotState  # noqa: E402
from lifelike_tpu.robot.model import build_max_model as jbuild  # noqa: E402
from lifelike_tpu.scene.boxes import BoxScene as JBoxScene  # noqa: E402
from lifelike_tpu_torch.physics import impulse, oracle_traces  # noqa: E402
from lifelike_tpu_torch.physics.dynamics import RobotState  # noqa: E402
from lifelike_tpu_torch.robot.model import build_max_model  # noqa: E402

CEILING = {"walk": 1e-2, "run": 1e-2, "stand": 2e-2, "hurdle": 6e-3}  # the JAX tests'
QUANTILES = (0.0, 0.25, 0.5, 0.75, 1.0)


def _starts(names, shifts):
    """float32 start states (numpy, one row per start), targets (H, rows,
    12) and trace joint positions (H, rows, 12) of a group of traces."""
    trs = [oracle_traces.load(n, dtype=torch.float64, device="cpu") for n in names]
    members = shifts[names[0]].shape[0]
    init = {f: np.concatenate([np.repeat(getattr(t.init, f).numpy()[None].astype(np.float32),
                                         members, 0) for t in trs])
            for f in JRobotState._fields}
    shift = np.concatenate([shifts[n] for n in names])
    init["joint_pos"] = (init["joint_pos"].astype(np.float64) + shift).astype(np.float32)
    targets = np.stack([t.targets.numpy() for t in trs], 1).repeat(members, 1)
    want = np.stack([t.joint_pos for t in trs], 1).repeat(members, 1)
    return init, targets.astype(np.float32), want, trs[0].scene


def _jax_scene(scene):
    if scene is None:
        return None
    return JBoxScene(center=jnp.asarray(scene.center.numpy(), jnp.float32),
                     half=jnp.asarray(scene.half.numpy(), jnp.float32),
                     active=jnp.ones(scene.center.shape[0], bool),
                     target_pos=jnp.zeros(3, jnp.float32))


def jax_errors(init, targets, want, scene, batched=True):
    """(H, rows) max |dq| of the JAX plant, every start at once (vmap) or
    each start alone (jit of the unbatched step, as the JAX tests run it)."""
    model, jscene = jbuild(), _jax_scene(scene)
    one = jimpulse.make_control_step(model, jimpulse.ImpulseParams(), scene=jscene)
    rows = targets.shape[1]

    def run(s, lam, tg, w):
        step = jax.jit(jax.vmap(one)) if batched else jax.jit(one)
        out = []
        for t in range(tg.shape[0]):
            s, lam = step((s, lam), jnp.asarray(tg[t]))
            out.append(np.abs(np.asarray(s.joint_pos, np.float64) - w[t]).max(-1))
        return np.stack(out)

    if batched:
        s = JRobotState(*(jnp.asarray(init[f]) for f in JRobotState._fields))
        return run(s, jimpulse.init_lam((rows,), jnp.float32, scene=jscene), targets, want)
    cols = []
    for k in range(rows):
        s = JRobotState(*(jnp.asarray(init[f][k]) for f in JRobotState._fields))
        cols.append(run(s, jimpulse.init_lam((), jnp.float32, scene=jscene), targets[:, k],
                        want[:, k]))
    return np.stack(cols, 1)


def port_errors(init, targets, want, scene):
    """(H, rows) max |dq| of the port's plant in float32 on the CPU."""
    model, p = build_max_model(), impulse.ImpulseParams()
    s = RobotState(*(torch.as_tensor(init[f]) for f in RobotState._fields))
    sc = None if scene is None else scene._replace(
        center=scene.center.float(), half=scene.half.float(), target_pos=scene.target_pos.float())
    lam = impulse.init_lam((targets.shape[1],), torch.float32, scene=sc, device="cpu")
    out = []
    for t in range(targets.shape[0]):
        s, lam = impulse.control_step(model, p, s, lam, torch.as_tensor(targets[t]), scene=sc)
        out.append(np.abs(s.joint_pos.double().numpy() - want[t]).max(-1))
    return np.stack(out)


def summary(name, errs, members):
    """Quantiles of the H 50 max over the starts, count at or over the
    ceiling, the own start's max."""
    peak = errs.max(0)
    return {"quantiles": [float(x) for x in np.quantile(peak, QUANTILES)],
            "over_ceiling": int((peak >= CEILING[name]).sum()), "members": members,
            "own_start": float(peak[0]), "first_step_own": float(errs[0, 0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    shifts = oracle_traces.start_shifts(args.members)
    result = {"members": args.members, "noise_rad": 1e-6, "jax": {}, "jax_single": {},
              "port_cpu": {}}
    for names in oracle_traces.GROUPS:
        init, targets, want, scene = _starts(names, shifts)
        own = [k * args.members for k in range(len(names))]
        runs = {"jax": lambda: jax_errors(init, targets, want, scene),
                "jax_single": lambda: jax_errors(
                    {f: x[own] for f, x in init.items()}, targets[:, own], want[:, own], scene,
                    batched=False),
                "port_cpu": lambda: port_errors(init, targets, want, scene)}
        for key, fn in runs.items():
            t0 = time.perf_counter()
            errs = fn()
            sec = time.perf_counter() - t0
            per = errs.shape[1] // len(names)
            for k, n in enumerate(names):
                r = summary(n, errs[:, k * per:(k + 1) * per], per)
                result[key][n] = r
                q = " ".join(f"{x:.3e}" for x in r["quantiles"])
                print(f"{key:10s} {n:6s} f32 H {errs.shape[0]}: {per} start(s), H 50 max "
                      f"quantiles 0/25/50/75/100 {q} | {r['over_ceiling']} at or over "
                      f"{CEILING[n]:g} | own start {r['own_start']:.3e}, first step "
                      f"{r['first_step_own']:.3e} ({sec:.0f} s for the group)", flush=True)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()

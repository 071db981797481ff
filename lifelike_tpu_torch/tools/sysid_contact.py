"""System identification of the compliant ContactParams vs the golden traces.

Port of tools/sysid_contact.py. The compliant penalty model
(physics/contact.py) is the fast MPPI sampling path; the hard-contact
impulse plant (physics/impulse.py) is the fidelity mode. This tool searches
ContactParams (kn, dn, v_slip, fric_visc_cap) by cross-entropy in log-space
for the compliant engine (physics/engine.py) that stays closest to the
walk, run and stand golden traces (physics/oracle_traces) over their 50
control steps. A whole CEM population is one batch of the engine: the
candidates' four parameters are tensors of shape (batch, 1) that broadcast
over the feet and wheels, and the three traces are stacked behind each
other, so one call rolls pop x 3 robots through the 500 substeps.

    python -m lifelike_tpu_torch.tools.sysid_contact [--iters 15] [--pop 48] [--device cpu]

Prints the per-trace max |joint error| at the shipped defaults, one line per
CEM iteration and, last, a JSON object with the best (kn, dn, v_slip,
fric_visc_cap) and its errors beside the defaults'.

The search computes in float64, the precision the reference tool asks for.
(The reference runs JAX without x64 as a script, so there it is float32;
under the tests, which turn x64 on, it is float64.)
"""
import argparse
import json

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.physics import engine, oracle_traces
from lifelike_tpu_torch.physics.contact import ContactParams
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model

NAMES = ("walk", "run", "stand")
# log-space search box: [kn, dn, v_slip, fric_visc_cap]
LOG_LO = np.log(np.array([4e3, 10.0, 2e-3, 20.0]))
LOG_HI = np.log(np.array([2e5, 500.0, 0.3, 500.0]))
NOT_FINITE = 1e3  # the error of a rollout that blew up


def load_traces(device, dtype=torch.float64):
    """[(start state, targets (H, 12), joint positions (H, 12))] of NAMES."""
    out = []
    for name in NAMES:
        tr = oracle_traces.load(name, dtype=dtype, device=device)
        out.append((tr.init, tr.targets, torch.as_tensor(tr.joint_pos, dtype=dtype,
                                                         device=device)))
    return out


def default_theta():
    d = ContactParams()
    return np.log(np.array([d.kn, d.dn, d.v_slip, d.fric_visc_cap]))


def make_eval(data, model=None):
    """Batched objective: theta (n, 4) log-params -> per-trace max |joint
    error| (n, 3) over every step and joint, NOT_FINITE where not finite."""
    model = model or build_max_model()
    init, targets, ref_q = zip(*data)
    dev, dtype = targets[0].device, targets[0].dtype
    nt = len(data)

    def evaluate(theta):
        theta = torch.as_tensor(np.asarray(theta), dtype=dtype, device=dev)
        n = theta.shape[0]
        p = torch.exp(theta).repeat(nt, 1)  # (nt * n, 4), trace-major
        params = engine.PhysicsParams(contact=ContactParams(
            kn=p[:, 0:1], dn=p[:, 1:2], v_slip=p[:, 2:3], fric_visc_cap=p[:, 3:4]))
        s = RobotState(*(torch.cat([x[k].expand((n,) + x[k].shape) for x in init])
                         for k in range(len(RobotState._fields))))
        tgt = torch.stack(targets).repeat_interleave(n, dim=0)  # (nt * n, H, 12)
        err = torch.zeros(nt * n, dtype=dtype, device=dev)
        want = torch.stack(ref_q).repeat_interleave(n, dim=0)
        for t in range(tgt.shape[1]):
            s = engine.control_step(model, params, s, tgt[:, t])
            # max with NaN propagation, as the reference's jnp.max
            err = torch.maximum(err, (s.joint_pos - want[:, t]).abs().amax(dim=-1))
        err = torch.where(torch.isfinite(err), err, torch.full_like(err, NOT_FINITE))
        return err.reshape(nt, n).T.cpu().numpy()

    return evaluate


def search(evaluate, iters, pop, elites, seed, log=print):
    """The reference's CEM: normal draws around the elite mean, clipped to
    the box, the best so far kept as candidate 0. Returns (best theta,
    its errors, the defaults' errors)."""
    theta0 = default_theta()
    base = evaluate(theta0[None])[0]
    log("defaults", dict(zip(NAMES, np.round(base, 4))))
    rng = np.random.default_rng(seed)
    mean, std = theta0.copy(), (LOG_HI - LOG_LO) / 4.0
    best_theta, best_score = theta0, float(np.sum(base))
    for it in range(iters):
        cand = np.clip(rng.normal(mean, std, size=(pop, 4)), LOG_LO, LOG_HI)
        cand[0] = best_theta  # elitism
        errs = evaluate(cand)  # (pop, 3)
        scores = errs.sum(axis=1)
        order = np.argsort(scores)
        top = cand[order[:elites]]
        mean, std = top.mean(axis=0), top.std(axis=0) + 1e-3
        if scores[order[0]] < best_score:
            best_score, best_theta = float(scores[order[0]]), cand[order[0]].copy()
        log(f"iter {it:2d} best={scores[order[0]]:.4f} errs={np.round(errs[order[0]], 4)} "
            f"params={np.round(np.exp(cand[order[0]]), 4)}")
    return best_theta, evaluate(best_theta[None])[0], base


def main(argv=None, log=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--pop", type=int, default=48)
    ap.add_argument("--elites", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve_device(args.device)

    evaluate = make_eval(load_traces(dev))
    theta, final, base = search(evaluate, args.iters, args.pop, args.elites, args.seed, log)
    kn, dn, vs, cap = np.exp(theta)
    out = dict(kn=float(kn), dn=float(dn), v_slip=float(vs), fric_visc_cap=float(cap),
               errors={n: float(e) for n, e in zip(NAMES, final)},
               default_errors={n: float(e) for n, e in zip(NAMES, base)})
    log(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

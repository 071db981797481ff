#!/usr/bin/env python
"""Where the JAX reference's and the PyTorch port's hard-contact plants part
on the hurdle golden trace in float32 (CPU).

Both plants step from the trace's own start (lifelike_tpu_torch/data/
oracle_traces/hurdle.npz) in float32, substep by substep (the JAX substep
jitted, as the JAX tests jit their steps; the port's plain PGS sweep). It
prints

  1. for the first control step, per substep, on the JAX trajectory's state:
     the largest difference of the two forward kinematics (relative to each
     field's scale); the ulps between the row systems (J, b, lo, hi) of the
     two `_build_rows` given the SAME kinematics (JAX's), and the rows given
     as the kinematics were; the ulps between the PGS sweeps given the same
     inputs (JAX's system);
  2. stepping the two plants apart over the trace's 50 control steps: the
     first substep whose states differ, the first (control step, substep,
     row) at which a row is active in one plant and not in the other, and
     each control step's largest joint error against the trace;
  3. JAX alone, the trace's H 50 error with the same source jitted as one
     control step or as one substep.

    JAX_PLATFORMS=cpu python tools/hurdle_f32_parting.py [--steps 50]

Takes a few minutes. Ends with one JSON line of the findings.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # as the JAX tests run; the plant is float32

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lifelike_tpu.physics import dynamics as JD  # noqa: E402
from lifelike_tpu.physics import impulse as JI  # noqa: E402
from lifelike_tpu.physics.dynamics import RobotState as JRobotState  # noqa: E402
from lifelike_tpu.robot.model import build_max_model as jbuild  # noqa: E402
from lifelike_tpu.scene.boxes import BoxScene as JBoxScene  # noqa: E402
from lifelike_tpu_torch.physics import dynamics as PD  # noqa: E402
from lifelike_tpu_torch.physics import impulse as PI  # noqa: E402
from lifelike_tpu_torch.physics import oracle_traces  # noqa: E402
from lifelike_tpu_torch.physics.dynamics import RobotState  # noqa: E402
from lifelike_tpu_torch.robot.model import build_max_model  # noqa: E402


def ulps(a, b):
    """Elementwise distance in float32 units in the last place (an infinity
    against a finite value counts 2**30)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    same = (a == b) | (np.isnan(a) & np.isnan(b))
    finite = np.isfinite(a) & np.isfinite(b)
    return np.where(same, 0, np.where(finite, np.abs(ordered(a) - ordered(b)), 1 << 30))


class Plants:
    def __init__(self):
        tr = oracle_traces.load("hurdle", dtype=torch.float32, device="cpu")
        self.trace = tr
        self.jm, self.pm = jbuild(), build_max_model()
        self.jp, self.pp = JI.ImpulseParams(), PI.ImpulseParams()
        self.jscene = JBoxScene(center=jnp.asarray(tr.scene.center.numpy()),
                                half=jnp.asarray(tr.scene.half.numpy()),
                                active=jnp.ones(tr.scene.center.shape[0], bool),
                                target_pos=jnp.zeros(3, jnp.float32))
        jm, jp, sc = self.jm, self.jp, self.jscene
        self.j_kin = jax.jit(lambda s: JD.forward_kinematics(jm, s))
        self.j_rows = jax.jit(lambda s: JI._build_rows(jm, jp, s, JD.forward_kinematics(jm, s),
                                                       scene=sc))
        self.j_system = jax.jit(self._j_system)
        self.j_pgs = jax.jit(lambda *a: JI._pgs(jp, *a, mu_idx=JI._MU_IDX_BOX))
        self.j_substep = jax.jit(lambda s, lam, tq: JI.substep(jm, jp, s, lam, tq, scene=sc))
        self.j_control = jax.jit(JI.make_control_step(jm, jp, scene=sc))

    def _j_system(self, s, lam, tq):
        """The JAX substep up to its PGS sweep (lifelike_tpu.physics.impulse
        .substep's own lines): (v, lam0, J, MinvJT, d, b, lo, hi)."""
        jm, jp, dt = self.jm, self.jp, self.jp.dt
        kin = JD.forward_kinematics(jm, s)
        tau_j = jp.kp * (jnp.clip(tq, -3.0, 3.0) - s.joint_pos) + jp.kd * (0.0 - s.joint_vel)
        tau_j = jnp.clip(tau_j, -jp.max_tau, jp.max_tau)
        tau_j = tau_j - jnp.asarray(jm.joint_damping, s.base_pos.dtype).reshape(-1) * s.joint_vel
        tau_j = tau_j.reshape(s.joint_pos.shape[:-1] + (4, 3))
        ext = jnp.broadcast_to(jnp.asarray(jp.ext_force, s.base_pos.dtype), s.base_pos.shape)
        tau_b = jnp.concatenate([jnp.zeros_like(ext), ext], axis=-1)
        bias_b, bias_j = JD.bias_forces(jm, kin, s, s.base_pos)
        fac = JD.factor_dynamics(*JD.mass_matrix_blocks(jm, kin, s.base_pos, s.base_pos))
        a_base, qdd = JD.forward_dynamics_apply(fac, tau_b - bias_b, tau_j - bias_j)
        w = s.base_ang_vel
        a_lin = a_base[..., 3:] + jnp.cross(w, s.base_lin_vel)
        v_free = jnp.concatenate([w + a_base[..., :3] * dt, s.base_lin_vel + a_lin * dt,
                                  s.joint_vel + qdd.reshape(s.joint_vel.shape) * dt], axis=-1)
        mu_idx = JI._MU_IDX_BOX
        J, b, lo, hi = JI._build_rows(jm, jp, s, kin, scene=self.jscene)
        MinvJT = JD.minv_apply_rows(fac, J)
        d = jnp.einsum("...ni,...ni->...n", J, MinvJT)
        lam0 = jnp.where((hi > 0.0) | (lo < 0.0) | (mu_idx >= 0), lam, 0.0)
        lam0 = jnp.where((mu_idx >= 0) & (hi[..., np.maximum(mu_idx, 0)] <= 0.0), 0.0, lam0)
        v = v_free + jnp.einsum("...nk,...n->...k", MinvJT, lam0)
        return v, lam0, J, MinvJT, d, b, lo, hi

    def start(self):
        sp = RobotState(*(x.clone() for x in self.trace.init))
        return (self.to_jax(sp), JI.init_lam((), jnp.float32, scene=self.jscene), sp,
                PI.init_lam((), torch.float32, scene=self.trace.scene, device="cpu"))

    @staticmethod
    def to_jax(s):
        return JRobotState(*(jnp.asarray(x.numpy()) for x in s))

    @staticmethod
    def to_port(s):
        return RobotState(*(torch.as_tensor(np.array(x)) for x in s))


def first_step_rows(pl):
    """Part 1: per substep of the first control step, on JAX's state."""
    sj, lj, _, _ = pl.start()
    tq = pl.trace.targets[0]
    out = []
    for sub in range(pl.jp.substeps):
        sp = pl.to_port(sj)
        kin_j, kin_p = pl.j_kin(sj), PD.forward_kinematics(pl.pm, sp)
        kin_err = max(float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max()
                            / max(float(np.abs(np.asarray(a)).max()), 1e-30))
                      for a, b in zip(kin_j, kin_p))
        rows_j = pl.j_rows(sj)
        same_kin = type(kin_p)(*(torch.as_tensor(np.array(x)) for x in kin_j))
        rows_same = PI._build_rows(pl.pm, pl.pp, sp, same_kin, scene=pl.trace.scene)
        rows_own = PI._build_rows(pl.pm, pl.pp, sp, kin_p, scene=pl.trace.scene)
        system = pl.j_system(sj, lj, jnp.asarray(tq.numpy()))
        pgs_j = pl.j_pgs(*system)
        pgs_p = PI._pgs(pl.pp, *(torch.as_tensor(np.array(x)) for x in system),
                        mu_idx=PI._MU_IDX_BOX)
        row = {"substep": sub, "kinematics_rel": kin_err,
               "rows_same_kinematics_ulps": [int(ulps(a, b.numpy()).max())
                                             for a, b in zip(rows_j, rows_same)],
               "rows_own_kinematics_ulps": [int(ulps(a, b.numpy()).max())
                                            for a, b in zip(rows_j, rows_own)],
               "pgs_same_inputs_ulps": [int(ulps(a, b.numpy()).max())
                                        for a, b in zip(pgs_j, pgs_p)]}
        out.append(row)
        print(f"step 0 substep {sub}: kinematics {kin_err:.2e} of scale | rows J, b, lo, hi "
              f"(same kinematics) {row['rows_same_kinematics_ulps']} ulps, (own) "
              f"{row['rows_own_kinematics_ulps']} | PGS on the same inputs: v, lam "
              f"{row['pgs_same_inputs_ulps']} ulps", flush=True)
        sj, lj = pl.j_substep(sj, lj, jnp.asarray(tq.numpy()))
    return out


def trajectories(pl, steps):
    """Part 2: the two plants stepped apart."""
    sj, lj, sp, lp = pl.start()
    first_state = first_row = None
    errors = []
    for step in range(steps):
        tq = pl.trace.targets[step]
        for sub in range(pl.jp.substeps):
            if first_row is None:
                rows_j = pl.j_rows(sj)
                rows_p = PI._build_rows(pl.pm, pl.pp, sp, PD.forward_kinematics(pl.pm, sp),
                                        scene=pl.trace.scene)
                act_j, act_p = np.asarray(rows_j[3]) > 0, rows_p[3].numpy() > 0
                if (act_j != act_p).any():
                    rows = np.flatnonzero(act_j != act_p)
                    # an active normal row's bias is erp x penetration / dt
                    pen = [float(max(np.asarray(rows_j[1])[r], rows_p[1][r].item()))
                           * pl.jp.dt / pl.jp.erp for r in rows]
                    first_row = {"step": step, "substep": sub, "rows": rows.tolist(),
                                 "active_in_jax": [bool(act_j[r]) for r in rows],
                                 "penetration_m": pen}
            sj, lj = pl.j_substep(sj, lj, jnp.asarray(tq.numpy()))
            sp, lp = PI.substep(pl.pm, pl.pp, sp, lp, tq, scene=pl.trace.scene)
            if first_state is None:
                diff = {f: float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())
                        for f, a, b in zip(RobotState._fields, sj, sp)}
                if any(diff.values()):
                    first_state = {"step": step, "substep": sub, "diff": diff}
        want = pl.trace.joint_pos[step]
        errors.append((float(np.abs(np.asarray(sj.joint_pos, np.float64) - want).max()),
                       float(np.abs(sp.joint_pos.double().numpy() - want).max())))
        print(f"control step {step}: |q - trace| JAX {errors[-1][0]:.3e} port "
              f"{errors[-1][1]:.3e}", flush=True)
    print(f"first substep whose states differ: {first_state}", flush=True)
    print(f"first row active in one plant only: {first_row}", flush=True)
    return {"first_state": first_state, "first_row": first_row, "errors": errors}


def jax_jits(pl, steps):
    """Part 3: the JAX plant's H max error, jitted as a control step or as a
    substep."""
    out = {}
    for name in ("control_step", "substep"):
        sj, lj, _, _ = pl.start()
        errs = []
        for step in range(steps):
            tq = jnp.asarray(pl.trace.targets[step].numpy())
            if name == "control_step":
                sj, lj = pl.j_control((sj, lj), tq)
            else:
                for _ in range(pl.jp.substeps):
                    sj, lj = pl.j_substep(sj, lj, tq)
            errs.append(float(np.abs(np.asarray(sj.joint_pos, np.float64)
                                     - pl.trace.joint_pos[step]).max()))
        out[name] = max(errs)
        print(f"JAX jitted as one {name}: H {steps} max |q - trace| {out[name]:.3e}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    pl = Plants()
    result = {"first_step": first_step_rows(pl), "apart": trajectories(pl, args.steps),
              "jax_jits": jax_jits(pl, args.steps)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()

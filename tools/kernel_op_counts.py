#!/usr/bin/env python
"""Scalar-operation counts per candidate per control step of the fused
rollout kernels, the operation term of their roofline bounds.

The count is tools/sol_report.py's method: trace one
lifelike_tpu.ops.scalar_phys.control_step at (1, 1) tiles and count every
arithmetic primitive of the jaxpr as one operation per lane. With `boxes`
(K rows of shape (K, 1, 1)) the box-contact path is traced too, and each
primitive on a (K, 1, 1) value counts K operations. The stage costs are
counted the same way from the Pallas kernels' own cost code
(ops/traversal_pallas.py). Runs on the CPU in about a minute and a half:

  JAX_PLATFORMS=cpu python tools/kernel_op_counts.py

Prints one JSON line per configuration: the physics count, the stage-cost
count and their sum. Beside each count of K1-K4 stands the dependency depth
of one control step (`physics_depth`, `stage_depth`): the longest path of
dependent arithmetic primitives through the same jaxpr, each primitive one
level whatever its shape, so the box axis counts once (its boxes are
independent), and a reduction over it (the sum of the boxes' forces) counts
one level too. A strictly sequential rollout cannot run faster than depth x
H x (the latency of one dependent operation, about 4 cycles on the H100's
FP32 and FP64 pipes) per candidate: chip_smoke.py turns the depth into the
chain floor of K1-K4 with the card's own maximum SM clock. The PGS sweep (K5) is counted from
lifelike_tpu.physics.impulse._pgs, the row loop the Pallas sweep is pinned
to, for one iteration of one batch element: every arithmetic primitive, and
a dot_general of length K as K multiplies and K - 1 adds. The Riccati
sweep (K6) is counted the same way from the Pallas kernel's own step
(lifelike_tpu.solver.riccati_pallas._backward_step with its Gauss-Jordan
inverse), per scenario per horizon step at n = 37, m = 12, beside the bytes
one step must move (its six input blocks read once, its two gains written
once, float32). Beside K5's and K6's counts stands their dependency depth
by the same rule as K1-K4's, with each dot_general (a dot or a matrix
product) one level too: K5's for one sweep of one element (its rows in
order, each row's update a chain through v and lam) and per row (the
sweep's depth over its rows), K6's for one backward step (the 12
Gauss-Jordan rounds of the inverse among it). chip_smoke.py turns them into
the chain floor of K5 (the sweep's depth x iterations) and of K6 (the
step's depth x H).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

ARITH = {
    "add", "sub", "mul", "div", "sqrt", "rsqrt", "exp", "tanh", "log",
    "sin", "cos", "abs", "neg", "max", "min", "integer_pow", "pow",
    "select_n", "lt", "gt", "ge", "le", "clamp", "sign", "logistic",
}  # tools/sol_report.py's set


REDUCE = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "argmax", "argmin"}
DOT = {"dot_general"}  # one level in K5's and K6's depths


def _count(fn, *args):
    n = 0
    for eqn in jax.make_jaxpr(fn)(*args).jaxpr.eqns:
        if eqn.primitive.name in ARITH:
            for ov in eqn.outvars:
                n += int(np.prod(ov.aval.shape)) if ov.aval.shape else 1
    return n


def _depth_of(jaxpr, in_depths, levels=ARITH | REDUCE):
    """Longest chain of dependent primitives of `levels` (ARITH / REDUCE)
    from the inputs (at in_depths) to each output of `jaxpr`, entering call
    bodies (jit, custom_jvp_call, a scan's body once)."""
    depth = dict(zip(jaxpr.invars, in_depths))

    def of(v):  # a literal (it has a value) starts no chain
        return 0 if hasattr(v, "val") else depth.get(v, 0)

    for eqn in jaxpr.eqns:
        ins = [of(v) for v in eqn.invars]
        sub = eqn.params.get("jaxpr", eqn.params.get("call_jaxpr"))
        if sub is not None:
            outs = _depth_of(getattr(sub, "jaxpr", sub), ins, levels)
        else:
            step = 1 if eqn.primitive.name in levels else 0
            outs = [max(ins, default=0) + step] * len(eqn.outvars)
        for ov, d in zip(eqn.outvars, outs):
            depth[ov] = d
    return [of(v) for v in jaxpr.outvars]


def _depth(fn, *args, levels=ARITH | REDUCE):
    """Dependency depth of fn's outputs (the longest over them), inputs at 0."""
    closed = jax.make_jaxpr(fn)(*args)
    return max(_depth_of(closed.jaxpr, [0] * len(closed.jaxpr.invars), levels), default=0)


def _state():
    from lifelike_tpu.ops import scalar_phys as SP

    z = jnp.zeros((1, 1), jnp.float32)
    return SP.State(
        pb=(z, z, z + 0.33), q=(z, z, z, z + 1.0), vb=(z, z, z), wb=(z, z, z),
        jq=tuple((z, z + 0.5, z + 1.5) for _ in range(4)),
        jqd=tuple((z, z, z) for _ in range(4)),
    )


def _boxes(k):
    return tuple(jnp.zeros((k, 1, 1), jnp.float32) for _ in range(7))


def physics_ops(substeps, mass_freeze, n_boxes, measure=_count):
    from lifelike_tpu.ops import scalar_phys as SP
    from lifelike_tpu.physics import engine
    from lifelike_tpu.robot.model import build_max_model

    sm = SP.build_scalar_model(build_max_model())
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps,
                                  mass_freeze=mass_freeze)
    target = tuple((z, z + 0.5, z + 1.5) for z in [jnp.zeros((1, 1), jnp.float32)] * 4)
    bx = _boxes(n_boxes) if n_boxes else None
    return measure(lambda s: SP.control_step(sm, params, s, target, boxes=bx), _state())


def traversal_stage_ops(n_boxes, measure=_count):
    """The joystick traversal stage cost of _trav_kernel (no gait term)."""
    from lifelike_tpu.costs.traversal import TraversalWeights
    from lifelike_tpu.ops import traversal_pallas as TP

    w = TraversalWeights()
    bx = _boxes(n_boxes)

    def stage(s, tp, tspd):
        d, spd, spd_sg, align = TP._direction_terms(s, tp)
        r_rot = jnp.exp((align - 1.0) * 5.0)
        r_vel = jnp.exp(-jnp.abs(spd - tspd))
        cost = 1.0 - r_vel * r_rot
        cost = cost + w.velocity * jnp.abs(spd_sg - tspd) / (1.0 + tspd)
        cost = cost + w.heading * (1.0 - align)
        cost = cost + TP._posture_cost(s, w)
        cost = cost + w.fall * TP._fall_mask(s).astype(cost.dtype)
        return cost + w.clearance * TP._clearance_cost(s, bx, w.crawl_gap)

    z = jnp.zeros((1, 1), jnp.float32)
    return measure(stage, _state(), (z + 3.0, z), z + 1.5)


def chase_stage_ops(n_boxes, measure=_count):
    """The chase stage cost of _chase_kernel (one role mix, no gait term)."""
    from lifelike_tpu.costs.chase import ChaseWeights
    from lifelike_tpu.ops import scalar_phys as SP
    from lifelike_tpu.ops import traversal_pallas as TP

    w = ChaseWeights()
    bx = _boxes(n_boxes)

    def stage(s, opp, fp, chaser_m):
        dx = opp[0] - s.pb[0]
        dy = opp[1] - s.pb[1]
        d_opp = jnp.sqrt(dx * dx + dy * dy)
        inv = 1.0 / jnp.maximum(d_opp, 1e-8)
        m = SP.quat_to_mat(s.q)
        fx, fy = m[0][0], m[1][0]
        fnorm = jnp.maximum(jnp.sqrt(fx * fx + fy * fy), 1e-8)
        align = (fx * dx * inv + fy * dy * inv) / fnorm
        r_rot = jnp.exp((align - 1.0) * 2.0)
        c_ch = w.distance * d_opp + w.heading * (1.0 - r_rot)
        fdx = fp[0] - s.pb[0]
        fdy = fp[1] - s.pb[1]
        d_flag = jnp.sqrt(fdx * fdx + fdy * fdy)
        c_es = -w.distance * d_opp + w.distance * d_flag
        cost = chaser_m * c_ch + (1.0 - chaser_m) * c_es
        cost = cost + w.fall * TP._fall_mask(s).astype(cost.dtype)
        cost = cost + TP._posture_cost(s, w)
        return cost + 0.5 * TP._clearance_cost(s, bx)

    z = jnp.zeros((1, 1), jnp.float32)
    return measure(stage, _state(), (z + 1.0, z), (z, z + 2.0), z + 1.0)


def _count_nested(jaxpr, mult=1):
    """_count's rule through scan / pjit bodies (a scan body counts
    `length` times); dot_general: 2K - 1 operations per output of a
    length-K contraction."""
    n = 0
    for eqn in jaxpr.eqns:
        sub = eqn.params.get("jaxpr", eqn.params.get("call_jaxpr"))
        if sub is not None:
            n += _count_nested(getattr(sub, "jaxpr", sub), mult * eqn.params.get("length", 1))
            continue
        size = sum(int(np.prod(ov.aval.shape)) for ov in eqn.outvars)
        if eqn.primitive.name in ARITH:
            n += mult * size
        elif eqn.primitive.name == "dot_general":
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            k = int(np.prod([eqn.invars[0].aval.shape[i] for i in lhs_c]))
            n += mult * size * (2 * k - 1)
    return n


def pgs_ops(with_boxes):
    """Operations and dependency depth (a dot one level) of one PGS sweep
    (iterations 1) of one element: the flat 60-row or the box-scene 129-row
    system."""
    from lifelike_tpu.physics import impulse as JI

    idx = JI._MU_IDX_BOX if with_boxes else JI._MU_IDX
    r, nv = idx.shape[0], JI.NV

    def sweep(v, lam, J, MinvJT, d, b, lo, hi):
        return JI._pgs(JI.ImpulseParams(iterations=1), v, lam, J, MinvJT, d, b, lo, hi,
                       mu_idx=idx)

    z = lambda *shape: jnp.zeros(shape, jnp.float32)
    args = (z(nv), z(r), z(r, nv), z(r, nv), z(r), z(r), z(r), z(r))
    return (r, _count_nested(jax.make_jaxpr(sweep)(*args).jaxpr),
            _depth(sweep, *args, levels=ARITH | REDUCE | DOT))


def riccati_ops(n=37, m=12):
    """(operations, float32 bytes, dependency depth with a dot one level) of
    one Riccati backward step of one scenario: the Pallas kernel's
    _backward_step traced at (n, m)."""
    from lifelike_tpu.solver import riccati_pallas as RP

    def step(A, Bm, cx, cu, Cxx, Cuu, Vx, Vxx):
        return RP._backward_step(A, Bm, cx, cu, Cxx, Cuu, Vx, Vxx, 1e-3, m)

    z = lambda *shape: jnp.zeros(shape, jnp.float32)
    args = (z(n, n), z(n, m), z(n, 1), z(m, 1), z(n, n), z(m, m), z(n, 1), z(n, n))
    ops = _count_nested(jax.make_jaxpr(step)(*args).jaxpr)
    # A, B, cx, cu, Cxx, Cuu in; k, K out
    nbytes = 4 * (n * n + n * m + n + m + n * n + m * m + m + m * n)
    return ops, nbytes, _depth(step, *args, levels=ARITH | REDUCE | DOT)


def main():
    ops, nbytes, depth = riccati_ops()
    print(json.dumps({"config": "K6 Riccati backward step, n 37, m 12, per scenario per step",
                      "ops": ops, "bytes_f32": nbytes, "depth": depth}))
    for boxes in (False, True):
        r, n, depth = pgs_ops(boxes)
        print(json.dumps({"config": f"K5 PGS sweep, {r} rows, per element per iteration",
                          "ops": n, "per_row": n / r, "depth": depth,
                          "depth_per_row": depth / r}))
    both = lambda fn, *a: (fn(*a), fn(*a, measure=_depth))
    rows = []
    for mf in (10, 1):  # the headline setting and the closed loops' default plant
        rows.append((f"K1 plane, substeps 10, mass_freeze {mf}", both(physics_ops, 10, mf, 0),
                     (0, 0)))
        rows.append((f"K2 8 boxes, substeps 10, mass_freeze {mf}", both(physics_ops, 10, mf, 8),
                     both(traversal_stage_ops, 8)))
    for sub, mf in ((10, 10), (20, 1)):
        phys = both(physics_ops, sub, mf, 4)
        rows.append((f"K3 4 boxes, substeps {sub}, mass_freeze {mf}", phys, (0, 0)))
        rows.append((f"K4 4 boxes, substeps {sub}, mass_freeze {mf}", phys,
                     both(chase_stage_ops, 4)))
    for name, (phys, phys_d), (stage, stage_d) in rows:
        print(json.dumps({"config": name, "physics_ops": phys, "stage_ops": stage,
                          "total": phys + stage, "physics_depth": phys_d,
                          "stage_depth": stage_d}))


if __name__ == "__main__":
    main()

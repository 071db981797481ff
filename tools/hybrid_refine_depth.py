#!/usr/bin/env python
"""Does the MPPI->iLQR hybrid's refinement improve its seeds at a given
depth? The JAX reference's make_hybrid_controller (oracle sweep) and the
port's, side by side on the CPU in float64 with the same injected MPPI
noise, one PMC solve from the synthetic clip's frame at t 0.3 s.

  JAX_PLATFORMS=cpu python tools/hybrid_refine_depth.py --horizon=20 --substeps=10

Prints, per package, the solve's wall time, the seeds' costs (the MPPI
weighted plan and its n_refine cheapest raw candidates under the smooth
cost) and the refined costs, then the largest relative difference of the
seeds' costs between the packages; then the port's weighted plan rolled
under the smooth cost three ways: by the port, by JAX's jitted
ilqr._rollout, and by JAX op by op. At H 20 / substeps 10 the JAX compile
takes about a minute.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lifelike_tpu.motion import motion_lib as jml  # noqa: E402
from lifelike_tpu.physics import batched as JB  # noqa: E402
from lifelike_tpu.physics import engine as jengine  # noqa: E402
from lifelike_tpu.physics.dynamics import RobotState as JRobotState  # noqa: E402
from lifelike_tpu.robot.model import build_max_model as j_build_max_model  # noqa: E402
from lifelike_tpu.solver import hybrid as jhybrid  # noqa: E402
from lifelike_tpu.solver import ilqr as jilqr  # noqa: E402
from lifelike_tpu.solver import mppi as jmppi  # noqa: E402
from lifelike_tpu_torch.compat import from_jax  # noqa: E402
from lifelike_tpu_torch.physics import batched as B  # noqa: E402
from lifelike_tpu_torch.robot.model import build_max_model  # noqa: E402
from lifelike_tpu_torch.solver import hybrid, ilqr, mppi, mppi_tl, rollout_tl  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--substeps", type=int, default=10)
    p.add_argument("--population", type=int, default=128)
    p.add_argument("--n_refine", type=int, default=7)
    p.add_argument("--ilqr_iterations", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    H, f64 = args.horizon, torch.float64
    mcfg = jmppi.MPPIConfig(horizon=H, population=args.population, iterations=1)
    icfg = jilqr.ILQRConfig(iterations=args.ilqr_iterations)
    jp = jengine.PhysicsParams(substeps=args.substeps)
    # float64 frames, so that neither package rounds the clip's velocities
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jclips = jclips._replace(frames=jnp.asarray(jclips.frames, jnp.float64))
    jmodel, model = j_build_max_model(), build_max_model()
    jctrl = jhybrid.make_hybrid_controller(jmodel, JB.tl_constants(jmodel, dtype=jnp.float64),
                                           jp, jclips, mcfg, icfg, n_refine=args.n_refine,
                                           use_pallas=False)
    t0 = jnp.asarray(0.3, jnp.float64)
    frame = jml.sample_frame(jclips, jnp.asarray(0), t0)
    jrobot = JRobotState(*(jnp.asarray(x, jnp.float64) for x in frame))
    key = jax.random.PRNGKey(args.seed)
    start = time.perf_counter()
    _, _, jd = jctrl(key, jrobot, jnp.asarray(0), t0, jnp.zeros((H, 4, 3)))
    jseeds = np.asarray(jd["seed_costs"])
    print(f"jax (compile included) {time.perf_counter() - start:.1f} s | seeds "
          f"{jseeds.tolist()} | refined {np.asarray(jd['refined_costs']).tolist()}", flush=True)

    lanes = 128 if args.population % 128 == 0 else args.population
    shape = (H, 4, 3, args.population // lanes, lanes)  # mppi_tl's candidate layout
    eps = [torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
           for k in jax.random.split(key, mcfg.iterations)]
    ctrl = hybrid.make_hybrid_controller(
        model, B.tl_constants(model, dtype=f64, device="cpu"), from_jax.physics_params(jp),
        from_jax.motion_clips(jclips, device="cpu"), mppi.MPPIConfig(*mcfg),
        from_jax.ilqr_config(icfg), n_refine=args.n_refine, device="cpu")
    start = time.perf_counter()
    _, _, d = ctrl(None, from_jax.robot_state(jrobot, "cpu", f64), torch.tensor(0),
                   torch.tensor(0.3, dtype=f64), torch.zeros((H, 4, 3), dtype=f64), eps=eps)
    seeds = d["seed_costs"].numpy()
    print(f"port {time.perf_counter() - start:.1f} s | seeds {seeds.tolist()} | refined "
          f"{d['refined_costs'].tolist()}")
    print(f"seeds' costs: max relative difference between the packages "
          f"{float(np.max(np.abs(seeds - jseeds) / np.abs(jseeds))):.3e}")

    # the port's MPPI weighted plan (the first seed) under the smooth cost
    policy_dt = jp.dt * jp.substeps
    clips = from_jax.motion_clips(jclips, device="cpu")
    t = torch.tensor(0.3, dtype=f64)
    robot = from_jax.robot_state(jrobot, "cpu", f64)
    ref = rollout_tl.precompute_reference(model, clips, torch.tensor(0), t, H, policy_dt)
    u_opt, _ = mppi_tl.mppi_step(B.tl_constants(model, dtype=f64, device="cpu"),
                                 from_jax.physics_params(jp), mppi.MPPIConfig(*mcfg), None,
                                 B.tl_from_state(B.map_state(lambda x: x[None], robot)),
                                 torch.zeros((H, 4, 3), dtype=f64), ref, eps=eps)
    u = u_opt.reshape(H, 12)
    step_fn, cost_fn = ilqr.make_problem(model, from_jax.physics_params(jp), clips,
                                         torch.tensor(0), t)
    port_cost = float(ilqr._rollout(step_fn, cost_fn, ilqr.flatten_state(robot), u)[2])
    jstep, jcost = jilqr.make_problem(jmodel, jp, jclips, jnp.asarray(0), t0)
    x0, ju = jilqr.flatten_state(jrobot), jnp.asarray(u.numpy())
    jit_cost = float(jax.jit(lambda uu: jilqr._rollout(jstep, jcost, x0, uu)[2])(ju))
    x, eager_cost = x0, 0.0
    for i in range(H):
        ti = jnp.asarray(float(i), jnp.float64)
        eager_cost += float(jcost(x, ju[i], ti))
        x = jstep(x, ju[i], ti)
    print(f"the port's weighted plan under the smooth cost: port {port_cost!r} | JAX jitted "
          f"{jit_cost!r} | JAX op by op {eager_cost!r}")


if __name__ == "__main__":
    main()

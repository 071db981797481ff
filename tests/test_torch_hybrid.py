"""The MPPI->iLQR hybrid of lifelike_tpu_torch (solver/hybrid.py) vs the JAX
reference, on the CPU.

The first item holds the port's PMC make_hybrid_controller to JAX's
make_hybrid_controller(use_pallas=False) in float64 with the normals JAX
draws injected: population 128, H 2, substeps 1, n_refine 1 (S = 2
scenarios), one iLQR iteration, two solves from two states. u_exec,
u_next, the refined costs and the seeds' costs are held at 1e-8 (one JAX
compile covers the MPPI stage, ilqr_solve_batch and its oracle sweep).

The second item runs the traversal and chase hybrids on the port alone,
at tests/test_hybrid_tasks.py's shapes, scenes and invariants (its MPPI
noise comes from a torch generator, so it cannot match JAX's draws): a
refined cost never exceeds its seed's, the winner strictly improves on
the best seed on the hurdles, the outputs are finite and shaped; and
`run_mpc --hybrid --device=cpu` closes the loop for all three tasks at
tiny shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import arena_gen as jarena_gen
from lifelike_tpu.scene import playground_gen as jplayground_gen
from lifelike_tpu.solver import hybrid as jhybrid
from lifelike_tpu.solver import ilqr as jilqr
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu_torch.bin import run_mpc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import hybrid, ilqr, mppi, riccati_cuda

from tests.torch_port_util import CPU, F64, STAND_POSE, assert_close, np_of, random_robot_state

JMODEL = j_build_max_model()
MODEL = build_max_model()


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def test_hybrid_controller_matches_reference_with_same_noise():
    mcfg = jmppi.MPPIConfig(horizon=2, population=128, iterations=1)
    icfg = jilqr.ILQRConfig(iterations=1)
    jp = jengine.PhysicsParams(substeps=1)
    # float64 frames: jitted XLA rounds the float32 clip's velocities 1 ulp
    # apart from the eager port (see tests/test_torch_ilqr.py)
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jclips = jclips._replace(frames=jnp.asarray(jclips.frames, jnp.float64))
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    jctrl = jhybrid.make_hybrid_controller(JMODEL, jc, jp, jclips, mcfg, icfg, n_refine=1,
                                           use_pallas=False)
    clips = from_jax.motion_clips(jclips, device=CPU)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    ctrl = hybrid.make_hybrid_controller(MODEL, c, from_jax.physics_params(jp), clips,
                                         mppi.MPPIConfig(*mcfg), from_jax.ilqr_config(icfg),
                                         n_refine=1, device=CPU)
    rng = np.random.default_rng(3)
    shape = (mcfg.horizon, 4, 3, 1, 128)
    launches = riccati_cuda.riccati_sweep.launches
    u0 = 0.05 * rng.standard_normal((mcfg.horizon, 4, 3))
    for i, t in enumerate((0.3, 0.42)):
        d = random_robot_state(rng, vel_noise=0.1)
        jrobot = JRobotState(**{k: jnp.asarray(v) for k, v in d.items()})
        key = jax.random.PRNGKey(20 + i)
        jt = jnp.asarray(t, jnp.float64)
        ju_exec, ju_next, jdiag = jctrl(key, jrobot, jnp.asarray(0), jt, jnp.asarray(u0))
        eps = [torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
               for k in jax.random.split(key, mcfg.iterations)]
        robot = RobotState(**{k: T(v) for k, v in d.items()})
        u_exec, u_next, diag = ctrl(None, robot, torch.tensor(0), T(t), T(u0), eps=eps)
        assert u_exec.shape == (12,) and u_next.shape == (mcfg.horizon, 4, 3)
        assert_close(u_exec, ju_exec, rtol=1e-8, atol=1e-8)
        assert_close(u_next, ju_next, rtol=1e-8, atol=1e-8)
        for k in ("refined_cost", "refined_costs", "seed_costs", "best_cost", "weighted_cost",
                  "cost_topk"):
            assert_close(diag[k], jdiag[k], rtol=1e-8, atol=1e-8)
        assert "u_topk" not in diag
        u0 = np_of(u_next)
    # on CPU tensors the sweep runs its plain version: no kernel launch
    assert riccati_cuda.riccati_sweep.launches == launches


def _stand_robot(pos=(0.0, 0.0, 0.33), yaw=0.0):
    return RobotState(T(pos), T([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)]),
                      torch.zeros(3, dtype=F64), torch.zeros(3, dtype=F64), T(STAND_POSE),
                      torch.zeros(12, dtype=F64))


def _check_traversal_hybrid():
    """tests/test_hybrid_tasks.py::test_hybrid_traversal_refines_seed_on_hurdles
    on the port (its scene, carried across)."""
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=5)
    jscene = jplayground_gen.generate(jax.random.PRNGKey(5),
                                      jplayground_gen.PlaygroundConfig(element_id=1))
    scene = from_jax.box_scene(jscene, CPU, F64)
    mcfg = mppi.MPPIConfig(horizon=5, population=64, iterations=1, sigma=0.15)
    ctrl = hybrid.make_hybrid_traversal_controller(MODEL, c, params, mcfg,
                                                   ilqr.ILQRConfig(iterations=2), n_refine=3,
                                                   use_pallas=False, device=CPU)
    u_exec, u_next, diag = ctrl(torch.Generator().manual_seed(7), _stand_robot(), scene,
                                scene.target_pos, 1.5, torch.zeros((5, 4, 3), dtype=F64))
    seeds, refined = np_of(diag["seed_costs"]), np_of(diag["refined_costs"])
    assert seeds.shape == refined.shape == (4,)
    assert np.all(refined <= seeds + 1e-9), (refined, seeds)
    assert float(diag["refined_cost"]) < float(seeds.min()), (diag["refined_cost"], seeds)
    assert torch.isfinite(u_exec).all() and u_exec.shape == (12,)
    assert u_next.shape == (5, 4, 3)


def _check_chase_hybrid():
    """tests/test_hybrid_tasks.py::test_hybrid_chase_refines_both_roles on
    the port (its arena, carried across)."""
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=5)
    scene = from_jax.box_scene(jarena_gen.generate(jax.random.PRNGKey(1),
                                                   jarena_gen.ArenaConfig()), CPU, F64)
    mcfg = mppi.MPPIConfig(horizon=4, population=32, iterations=1, sigma=0.15)
    solver = hybrid.make_hybrid_chase_solver(MODEL, c, params, mcfg,
                                             ilqr.ILQRConfig(iterations=1), n_refine=2,
                                             use_pallas=False, device=CPU)
    chaser = _stand_robot(pos=(-1.0, 0.0, 0.33))
    escapee = _stand_robot(pos=(1.0, 0.0, 0.33), yaw=np.pi)
    robots = RobotState(*(torch.stack([a, b]) for a, b in zip(chaser, escapee)))
    u_exec, u_next, diag = solver(torch.Generator().manual_seed(3), robots, scene,
                                  T([0.0, 1.5, 0.25]), torch.tensor([True, False]),
                                  torch.zeros((2, 4, 4, 3), dtype=F64))
    for i in (0, 1):
        assert float(diag[f"refined_cost_{i}"]) <= float(diag[f"seed_cost_{i}"]) + 1e-9, (i, diag)
        assert diag[f"cost_topk_{i}"].shape == (2,)
    assert torch.isfinite(u_exec).all() and u_exec.shape == (2, 12)
    assert u_next.shape == (2, 4, 4, 3)


def _check_run_mpc_hybrid_cpu():
    for task in ("pmc", "epmc", "sepmc"):
        out = run_mpc.main([f"--task={task}", "--device=cpu", "--hybrid", "--population=128",
                            "--horizon=2", "--steps=1", "--ilqr_iterations=1", "--n_refine=1"])
        assert np.isfinite(out["step_rewards"]).all() and len(out["t_solve"]) == 1
        assert len(out["refined_cost"]) == 1 and np.isfinite(out["refined_cost"]).all()
        if task == "sepmc":  # per robot: the refined cost and its MPPI plan's seed cost
            assert np.all(np.array(out["refined_cost"]) <= np.array(out["seed_costs"]) + 1e-5)
        else:  # the winner against the best of the n_refine + 1 seeds
            assert out["refined_cost"][0] <= min(out["seed_costs"][0]) + 1e-5


# Each test file of the port holds at most two test items (ROADMAP.md ground
# rules): the checks are plain helpers called in turn.


def test_task_hybrids_refine_their_seeds():
    _check_traversal_hybrid()
    _check_chase_hybrid()
    _check_run_mpc_hybrid_cpu()

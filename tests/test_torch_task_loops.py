"""The EPMC playground and SEPMC Chase Tag closed loops of lifelike_tpu_torch
vs the same loops built from the JAX package, step by step, on the CPU.

Each loop is bin/run_mpc's: the controller solves from the env state, the
env steps on the executed targets. Three control steps at population 128,
H 3, one substep (plant and rollouts alike: a JAX solver compiles fast at
one substep; the physics is held in the other files), float64. Both
packages start from one state: a JAX reset (its hurdle course or arena) with the robots placed
by the test, the push mid-interval and no joystick re-target or flag grab
due, so that no random draw of the plant acts; the port's controllers are
fed the normals the JAX controllers draw from their keys. Targets, plans,
costs, rewards and the final states are held at 1e-8 (the PMC loop is held
in tests/test_torch_run_mpc.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.envs import chase_tag as jchase_tag
from lifelike_tpu.envs import playground as jplayground
from lifelike_tpu.envs import randomizer as jrandomizer
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import playground_gen as jplayground_gen
from lifelike_tpu.solver import mpc_tasks as jmpc_tasks
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import chase_tag, playground
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import playground_gen
from lifelike_tpu_torch.solver import mpc_tasks, mppi

from tests.torch_port_util import CPU, F64, STAND_POSE, assert_close, assert_tree_close

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, L, STEPS, SUBSTEPS, TOL = 3, 128, 3, 1, 1e-8
MCFG = jmppi.MPPIConfig(horizon=H, population=L, iterations=1, sigma=0.15)


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, tree)


@functools.partial(jax.jit, static_argnums=1)
def _jnormals(k, rounds):
    shape = (H, 4, 3, 1, L)
    if rounds == 0:
        return [jax.random.normal(ki, shape, jnp.float64)
                for ki in jax.random.split(k, MCFG.iterations)]
    out = []
    for _ in range(rounds):
        k, ki = jax.random.split(k)
        out.append([jax.random.normal(kk, shape, jnp.float64)
                    for kk in jax.random.split(ki, MCFG.iterations)])
    return out


def _normals(k, rounds):
    """The normals a JAX solve with key k draws (one jit): MPPI's split of
    its key per iteration (rounds 0); the chase solver first splits once per
    update (rounds updates)."""
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x)), _jnormals(k, rounds))


def _close(pairs):
    for name, got, want in pairs:
        np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                                   np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)


def _playground_start(jcfg):
    """A JAX reset on the hurdle course, float64, the robot standing at the
    start facing +x at 0.5 m/s; step 5 of a 100-step re-target period, the
    push 3 steps into its active interval."""
    s, _ = jax.jit(lambda k: jplayground.reset(JMODEL, jcfg, k))(jax.random.PRNGKey(3))
    s = _f64(s)
    robot = s.robot._replace(
        base_pos=jnp.asarray([0.0, 0.0, 0.36]), base_orn=jnp.asarray([0.0, 0.0, 0.0, 1.0]),
        base_lin_vel=jnp.asarray([0.5, 0.0, 0.0]), base_ang_vel=jnp.zeros(3),
        joint_pos=jnp.asarray(STAND_POSE), joint_vel=jnp.zeros(12))
    return s._replace(robot=robot, counter=jnp.asarray(5, jnp.int32),
                      cmd_vary_freq=jnp.asarray(100, jnp.int32),
                      push=jrandomizer.PushState(count=jnp.asarray(3, jnp.int32),
                                                 force=jnp.asarray([10.0, -5.0, 2.0])))


def _check_playground_loop():
    jcfg = jplayground.PlaygroundConfig(
        params=jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=SUBSTEPS),
        scene=jplayground_gen.PlaygroundConfig(element_id=1))
    cfg = playground.PlaygroundConfig(params=from_jax.physics_params(jcfg.params),
                                      scene=playground_gen.PlaygroundConfig(element_id=1))
    assert cfg.reward_type == jcfg.reward_type == "average_speed"
    jctrl = jmpc_tasks.make_traversal_controller(
        JMODEL, JB.tl_constants(JMODEL, dtype=jnp.float64), jcfg.params, MCFG,
        reward_type=jcfg.reward_type, max_steps=jcfg.max_steps)
    ctrl = mpc_tasks.make_traversal_controller(
        MODEL, B.tl_constants(MODEL, dtype=F64, device=CPU), cfg.params, mppi.MPPIConfig(*MCFG),
        reward_type=cfg.reward_type, max_steps=cfg.max_steps, device=CPU)
    jstep = jax.jit(lambda st, a, k: jplayground.step(JMODEL, jcfg, st, a, k))
    js = _playground_start(jcfg)
    s = from_jax.playground_state(js, CPU, F64)
    ju, u = jnp.zeros((H, 4, 3)), torch.zeros((H, 4, 3), dtype=F64)
    key = jax.random.PRNGKey(11)
    for i in range(STEPS):
        key, k, ke, _ = jax.random.split(key, 4)
        jtgt, ju, jdiag = jctrl(k, js.robot, js.scene, js.target_pos, js.target_spd, ju)
        tgt, u, diag = ctrl(None, s.robot, s.scene, s.target_pos, s.target_spd, u,
                            eps=_normals(k, rounds=0))
        js, _, jr, jdone, jinfo = jstep(js, jtgt - js.robot.joint_pos, ke)
        s, _, r, done, info = playground.step(MODEL, cfg, s, tgt - s.robot.joint_pos,
                                              torch.Generator())
        _close([(f"step {i} target", tgt, jtgt), (f"step {i} plan", u, ju),
                (f"step {i} best cost", diag["best_cost"], jdiag["best_cost"]),
                (f"step {i} weighted cost", diag["weighted_cost"], jdiag["weighted_cost"]),
                (f"step {i} reward", r, jr)])
        assert not bool(done) and not bool(jdone), i
        for k_ in jinfo:
            assert_close(info[k_], jinfo[k_], rtol=TOL, atol=TOL)
    assert_tree_close(s.robot, js.robot, rtol=TOL, atol=TOL)
    for f in ("counter", "target_pos", "target_spd", "last_pos_diff", "total_spd", "max_spd"):
        assert_close(getattr(s, f), getattr(js, f), rtol=TOL, atol=TOL)
    assert_tree_close(s.push, js.push, rtol=TOL, atol=TOL)
    assert float(u.abs().max()) > 1e-3  # the plans moved


def _chase_start(jcfg):
    """A JAX reset of the V4 arena, float64: the robots 2.5 m apart facing
    each other, robot 0 the chaser, the flag far from the escapee; step 7,
    the push 3 steps into its active interval."""
    s, _ = jax.jit(lambda k: jchase_tag.reset(JMODEL, jcfg, k))(jax.random.PRNGKey(5))
    s = _f64(s)
    pose = np.tile(STAND_POSE, (2, 1))
    robots = s.robots._replace(
        base_pos=jnp.asarray([[-1.25, 0.0, 0.36], [1.25, 0.2, 0.36]]),
        base_orn=jnp.asarray([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 0.0]]),
        base_lin_vel=jnp.asarray([[0.4, 0.0, 0.0], [-0.2, 0.1, 0.0]]),
        base_ang_vel=jnp.zeros((2, 3)), joint_pos=jnp.asarray(pose), joint_vel=jnp.zeros((2, 12)))
    return s._replace(robots=robots, with_flag=jnp.asarray([True, False]),
                      flag_pos=jnp.asarray([-1.8, -1.8, 0.25]),
                      counter=jnp.asarray(7, jnp.int32),
                      push=jrandomizer.PushState(count=jnp.asarray(3, jnp.int32),
                                                 force=jnp.asarray([-8.0, 4.0, 1.0])))


def _check_chase_loop():
    jcfg = jchase_tag.ChaseTagConfig(
        params=jchase_tag.ChaseTagConfig().params._replace(substeps=SUBSTEPS))
    cfg = from_jax.chase_tag_config(jcfg)
    jsolve = jmpc_tasks.make_chase_solver(JMODEL, JB.tl_constants(JMODEL, dtype=jnp.float64),
                                          jcfg.params, MCFG, n_best_response=1)
    solve = mpc_tasks.make_chase_solver(MODEL, B.tl_constants(MODEL, dtype=F64, device=CPU),
                                        cfg.params, mppi.MPPIConfig(*MCFG), n_best_response=1,
                                        device=CPU)
    jstep = jax.jit(lambda st, a, k: jchase_tag.step(JMODEL, jcfg, st, a, k))
    js = _chase_start(jcfg)
    s = from_jax.chase_tag_state(js, CPU, F64)
    ju, u = jnp.zeros((2, H, 4, 3)), torch.zeros((2, H, 4, 3), dtype=F64)
    key = jax.random.PRNGKey(13)
    for i in range(STEPS):
        key, k, ke, _ = jax.random.split(key, 4)
        jtgt, ju, jdiag = jsolve(k, js.robots, js.scene, js.flag_pos, js.with_flag, ju)
        tgt, u, diag = solve(None, s.robots, s.scene, s.flag_pos, s.with_flag, u,
                             eps=_normals(k, rounds=2))
        js, _, jr, jdone, jinfo = jstep(js, jtgt - js.robots.joint_pos, ke)
        s, _, r, done, info = chase_tag.step(MODEL, cfg, s, tgt - s.robots.joint_pos,
                                             torch.Generator())
        _close([(f"step {i} targets", tgt, jtgt), (f"step {i} plans", u, ju),
                (f"step {i} best cost", diag["best_cost"], jdiag["best_cost"]),
                (f"step {i} weighted cost", diag["weighted_cost"], jdiag["weighted_cost"]),
                (f"step {i} rewards", r, jr)])
        assert not bool(done) and not bool(jdone), i
        for k_ in jinfo:
            assert_close(info[k_], jinfo[k_], rtol=TOL, atol=TOL)
    assert_tree_close(s.robots, js.robots, rtol=TOL, atol=TOL)
    for f in ("counter", "with_flag", "flag_pos", "total_spd", "max_spd"):
        assert_close(getattr(s, f), getattr(js, f), rtol=TOL, atol=TOL)
    assert_tree_close(s.push, js.push, rtol=TOL, atol=TOL)
    assert float(u.abs().max()) > 1e-3


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_epmc_playground_loop_matches_reference_step_by_step():
    _check_playground_loop()


def test_sepmc_chase_loop_matches_reference_step_by_step():
    _check_chase_loop()

"""The Chase Tag environment of lifelike_tpu_torch vs the JAX reference, on
the CPU.

The deterministic parts are held against lifelike_tpu.envs.chase_tag in
float64 at 1e-9 from states carried over by compat.from_jax: the
observation of a reset, and a step of three games — a flag grab that swaps
the roles, a catch, and robots close enough for the trunk-trunk impulse —
with the push mid-interval, so that no random draw acts except the flag's
new position, which is copied across before the observation is compared.
Visibility is held on a config-sized arena table with the occluding wall in
one of its own slots (the reference's test writes slot 10 of a 4-row table:
ROADMAP.md note R1). The random parts (arena, spawn, roles, pushes, reset of
finished games) draw from a torch.Generator, which never agrees with
jax.random: they are held by their invariants. The SEPMC closed loop
(bin/run_mpc --task=sepmc) runs on the CPU's plain versions, and the
gait-prior chase solver is held against the JAX one with injected noise over
two solves with a role switch at 1e-8: its gait term reads the clip's
float32 finite-difference joint velocities, which XLA's jitted reference
rounds differently (see tests/test_torch_traversal.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.envs import chase_tag as jchase_tag
from lifelike_tpu.envs import randomizer as jrandomizer
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import arena_gen as jarena_gen
from lifelike_tpu_torch.bin import run_mpc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import chase_tag
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_gen

from tests.test_torch_chase import check_chase_solver
from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close

JMODEL = j_build_max_model()
MODEL = build_max_model()


def _configs(arena=jarena_gen.ArenaConfig(rand_cube=True, hurdle=True)):
    jcfg = jchase_tag.ChaseTagConfig(
        params=jchase_tag.ChaseTagConfig().params._replace(substeps=2), arena=arena)
    return jcfg, from_jax.chase_tag_config(jcfg)


def _jax_reset(jcfg, seed, batch):
    """A JAX reset (jitted: op by op it takes ~20 s), float leaves in float64."""
    s, _ = jax.jit(lambda k: jchase_tag.reset(JMODEL, jcfg, k, batch=batch))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, s)


def _games(rng):
    """Three games (batch (3,)) from a JAX reset, float64: game 0's escapee
    stands on the flag, game 1's robots stand 0.2 m apart (a catch), game
    2's robot 1 hangs 0.47 m above robot 0 (the trunk spheres overlap, no
    link touches the other robot); the push is 3 steps into its active
    interval; the robots stand upright, facing +x."""
    jcfg, cfg = _configs()
    s = _jax_reset(jcfg, 7, (3,))
    chaser0 = np.array([True, False, True])
    with_flag = np.stack([chaser0, ~chaser0], -1)
    flag = np.array([[0.5, 0.5, 0.25], [1.8, 1.8, 0.25], [-1.8, 1.8, 0.25]])
    pos = np.array([[[-1.0, -1.0, 0.33], [0.5, 0.5, 0.33]],  # robot 1 (escapee) on the flag
                    [[0.0, -1.0, 0.33], [0.2, -1.0, 0.33]],
                    [[-0.5, 0.9, 0.33], [-0.5, 0.9, 0.8]]])
    vel = 0.2 * rng.standard_normal((3, 2, 3))
    vel[2] = [[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]  # game 2's robots close on each other
    robots = s.robots._replace(base_pos=jnp.asarray(pos), base_lin_vel=jnp.asarray(vel),
                               base_orn=jnp.asarray(np.tile([0.0, 0.0, 0.0, 1.0], (3, 2, 1))),
                               joint_vel=jnp.asarray(0.1 * rng.standard_normal((3, 2, 12))))
    push = jrandomizer.PushState(count=jnp.full((3,), 3, jnp.int32),
                                 force=jnp.asarray(rng.uniform(-20, 20, (3, 3))))
    js = s._replace(robots=robots, push=push, with_flag=jnp.asarray(with_flag),
                    flag_pos=jnp.asarray(flag), counter=jnp.full((3,), 7, jnp.int32),
                    total_spd=jnp.asarray(rng.uniform(0, 2, (3, 2))),
                    max_spd=jnp.asarray(rng.uniform(0, 1, (3, 2))))
    return jcfg, cfg, js


def _check_step_matches_reference(rng):
    jcfg, cfg, js = _games(rng)
    s = from_jax.chase_tag_state(js, CPU, F64)
    jobserve = jax.jit(lambda st: jchase_tag._observe(JMODEL, jcfg, st))
    assert_tree_close(chase_tag._observe(MODEL, cfg, s), jobserve(js), rtol=1e-9, atol=1e-9)

    jstep = jax.jit(lambda st, a: jchase_tag.step(JMODEL, jcfg, st, a, jax.random.PRNGKey(0)))
    a = 0.05 * rng.standard_normal((3, 2, 12))
    js2, jobs, jr, jdone, jinfo = jstep(js, jnp.asarray(a))
    s2, _, r, done, info = chase_tag.step(MODEL, cfg, s, {"A_LLC": torch.as_tensor(a)},
                                          torch.Generator())
    assert_tree_close(s2.robots, js2.robots, rtol=1e-9, atol=1e-9)
    assert_close(r, jr, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k in jinfo:
        assert_close(info[k], jinfo[k], rtol=1e-9, atol=1e-9)
    for f in ("counter", "with_flag", "total_spd", "max_spd", "prop_hist", "act_hist"):
        assert_close(getattr(s2, f), getattr(js2, f), rtol=1e-9, atol=1e-9)
    assert_tree_close(s2.push, js2.push, rtol=1e-9, atol=1e-9)
    # the grab moved game 0's flag (a draw of each generator); the others stay
    assert_close(s2.flag_pos[1:], js2.flag_pos[1:], rtol=0, atol=0)
    assert float((s2.flag_pos[0] - s.flag_pos[0]).abs().max()) > 0.0
    assert bool((s2.flag_pos[0, :2].abs() <= 2.0).all()) and float(s2.flag_pos[0, 2]) == 0.25
    obs = chase_tag._observe(MODEL, cfg, s2._replace(flag_pos=torch.as_tensor(
        np.array(js2.flag_pos))))
    assert_tree_close(obs, jobs, rtol=1e-9, atol=1e-9)
    # game 0: the escapee grabbed the flag and became the chaser (+1 / -1);
    # game 1: robot 0 caught robot 1 (+1 for the chaser, game over);
    # game 2: the trunk spheres pushed the robots apart, the game goes on
    np.testing.assert_array_equal(s2.with_flag.numpy(), [[False, True], [False, True],
                                                        [True, False]])
    assert_close(r[0], [-1.0, 1.0], rtol=0, atol=0)
    assert bool(done[1]) and bool(info["caught"][1]) and not bool(done[2])
    assert_close(r[1], [-1.0, 1.0], rtol=0, atol=0)
    dv = chase_tag._robot_contact_impulse(MODEL, cfg, s.robots._replace(
        base_lin_vel=s.robots.base_lin_vel))
    assert float(dv[2, 0, 2]) < 0.0 and float(dv[2, 1, 2]) > 0.0  # pushed apart along z
    assert not bool(dv[0].any())
    return js


def _check_visibility():
    """Occlusion on a config-sized table: the hurdle config's 5th (hurdle)
    row becomes a wall between the robots."""
    jcfg, cfg = _configs(jarena_gen.ArenaConfig(hurdle=True))
    js = _jax_reset(jcfg, 6, ())
    pos = np.array([[-1.0, 0.0, 0.5], [1.0, 0.0, 0.5]])
    js = js._replace(robots=js.robots._replace(
        base_pos=jnp.asarray(pos), base_orn=jnp.asarray([[0.0, 0.0, 0.0, 1.0]] * 2)))
    assert js.scene.center.shape[0] == 5
    jobserve = jax.jit(lambda st: jchase_tag._observe(JMODEL, jcfg, st))

    def with_wall(z_lo, z_hi):
        zc, zh = 0.5 * (z_lo + z_hi), 0.5 * (z_hi - z_lo)
        sc = js.scene
        sc = sc._replace(center=sc.center.at[4].set(jnp.asarray([0.0, 0.0, zc])),
                         half=sc.half.at[4].set(jnp.asarray([0.05, 2.5, zh])))
        jst = js._replace(scene=sc)
        obs = chase_tag._observe(MODEL, cfg, from_jax.chase_tag_state(jst, CPU, F64))
        assert_tree_close(obs, jobserve(jst), rtol=1e-9, atol=1e-9)
        return obs

    open_ = with_wall(0.0, 0.0)  # a flat box: nothing occludes
    assert float(open_.oppo_info[0, 0]) == 1.0 and float(open_.oppo_info[1, 0]) == 1.0
    full = with_wall(0.0, 2.0)
    assert float(full.oppo_info[0, 0]) == 0.0 and not bool(full.oppo_info[0].any())
    assert float(full.oppo_info_cheat[0, 1:].abs().max()) > 0.0  # the cheat state still sees
    # a floating wall hides the bases and heads; the ray fan finds the feet
    assert float(with_wall(0.45, 2.0).oppo_info[0, 0]) == 1.0


def _check_catch_geometry(js):
    """Robot 0's links against robot 1 (random yaws of a reset) 3 m and
    0.25 m apart, and the convex point sets, against the reference."""
    jr = js.robots._replace(base_pos=jnp.asarray(
        [[[-1.5, 0.0, 0.33], [1.5, 0.0, 0.33]], [[-0.125, 0.0, 0.33], [0.125, 0.0, 0.33]],
         [[0.0, 0.0, 0.33], [0.0, 3.0, 0.33]]]))
    jcatch, jpts = jax.jit(lambda r: (jchase_tag._link_catch(JMODEL, r),
                                      jchase_tag._convex_points(JMODEL, r)[0]))(jr)
    r = from_jax.robot_state(jr, CPU, F64)
    np.testing.assert_array_equal(chase_tag._link_catch(MODEL, r).numpy(), np.asarray(jcatch))
    np.testing.assert_array_equal(np.asarray(jcatch), [False, True, False])
    assert_close(chase_tag._convex_points(MODEL, r)[0], jpts, rtol=1e-12, atol=1e-12)


def _check_reset_and_autoreset():
    cfg = chase_tag.ChaseTagConfig(
        params=chase_tag.ChaseTagConfig().params._replace(substeps=2),
        arena=arena_gen.ArenaConfig(rand_cube=True, hurdle=True, hole=True), max_steps=50)
    gen = torch.Generator().manual_seed(3)
    s, obs = chase_tag.reset(MODEL, cfg, gen, batch=(64,), dtype=F64)
    assert tuple(s.scene.center.shape) == (64, arena_gen.capacity(cfg.arena), 3)
    assert bool((s.with_flag.sum(-1) == 1).all())  # exactly one chaser per game
    assert 16 < int(s.with_flag[:, 0].sum()) < 48
    xy = s.robots.base_pos[..., :2]
    assert bool((xy.abs() <= 2.0).all()) and bool((s.robots.base_pos[..., 2] >= 0.5).all())
    assert bool((s.flag_pos[:, :2].abs() <= 2.0).all()) and bool((s.flag_pos[:, 2] == 0.25).all())
    for x, (lo, hi) in ((s.friction, cfg.friction_range), (s.control_spd, cfg.control_spd_range)):
        assert bool(((x >= lo) & (x < hi)).all())
    assert s.push.count.unique().tolist() == [-int(cfg.push.start_time / cfg.policy_dt)]
    assert tuple(obs.prop.shape) == (64, 2, 99) and tuple(obs.oppo_info.shape) == (64, 2, 15)
    assert tuple(obs.flag_info.shape) == (64, 2, 7) and tuple(obs.with_flag.shape) == (64, 2, 2)
    assert tuple(obs.percept_1d.shape) == (64, 2, 128)
    s2, _, r, done, _ = chase_tag.step_autoreset(
        MODEL, cfg, s._replace(counter=torch.full_like(s.counter, cfg.max_steps - 1)),
        torch.zeros(64, 2, 12, dtype=F64), gen)
    assert bool(done.all()) and not bool(s2.counter.any())  # every game timed out and restarted
    assert bool(torch.isfinite(r).all())
    # the fixed arena versions (GameManager parity) reach scene.arena_fixed
    s3, _ = chase_tag.reset(MODEL, cfg._replace(version="v2"), gen, dtype=F64)
    assert tuple(s3.scene.center.shape) == (24, 3) and int(s3.scene.active.sum()) == 12


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_chase_tag_env_matches_reference():
    rng = np.random.default_rng(71)
    js = _check_step_matches_reference(rng)
    _check_visibility()
    _check_catch_geometry(js)


def test_chase_tag_reset_and_sepmc_controllers():
    _check_reset_and_autoreset()
    check_chase_solver(gait_prior=True, n_best_response=1, tol=1e-8)
    out = run_mpc.main(["--task=sepmc", "--device=cpu", "--population=128", "--horizon=3",
                        "--steps=2", "--seed=1"])
    assert len(out["step_rewards"]) == 2 and np.isfinite(out["step_rewards"]).all()
    assert len(out["t_solve"]) == 2 and math.isfinite(out["final_dist"])

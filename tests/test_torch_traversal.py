"""The EPMC traversal rollout (K2) and controllers of lifelike_tpu_torch vs
the JAX reference, on the CPU.

The kernel's plain version (ops.traversal_cuda.rollout_traversal_plain,
i.e. solver.rollout_tasks.rollout_traversal_gait per scenario) and the
readable cost oracles are held against the JAX package's functions of the
same names — the function the Pallas kernel is itself pinned to in
tests/test_traversal_pallas.py — on a scene where box contact fires on the
feet, the wheels and the trunk from the first substep: float64 at 1e-9
(both reward types, crawl_gap weights, mass_freeze 2) and one float32 case
at the Pallas kernel's own 2e-4. The wrapper on CPU tensors is its plain
version; with gait_weight 0 and a constant reference at the current joints
it is rollout_traversal. Both controllers are held against the JAX
controllers with injected noise (the normals JAX draws): the raw-delta
controller at 1e-9, the gait controller at 1e-8 (see there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.costs import traversal as jtraversal
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import engine_tl as jengine_tl
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu.solver import mpc_tasks as jmpc_tasks
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import rollout_tasks as jrollout_tasks
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.costs import traversal
from lifelike_tpu_torch.ops import rollout_cuda, traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine_tl
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mpc_tasks, mppi, rollout_tasks

from tests.torch_port_util import (
    CPU,
    F64,
    assert_close,
    assert_tree_close,
    contact_scene,
    stand_state,
)

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, L = 3, 128  # horizon, population 128
CRAWL = dict(height_min=0.08, pose=0.0, crawl_gap=0.18, ceiling=0.3)


@functools.lru_cache(maxsize=None)
def _jclips():
    return jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)


def _scene_np():
    """The contact scene plus four active boxes away from the robot (the
    corridor prune drops three of them), 16 slots."""
    d = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)), capacity=16)
    far = [[-3.0, 0.0, 0.2], [-4.0, 0.5, 0.2], [3.0, 3.0, 0.2], [6.0, 0.0, 0.2]]
    d["center"][7:11] = far
    d["half"][7:11] = 0.2
    d["active"][7:11] = True
    return d


def _inputs(rng):
    """(JAX inputs, port inputs), float64: one start state (perturbed stand
    at 0.36 m, in contact with the scene), controls 0.05 N(0, 1), the scene,
    the gait reference, target and speed."""
    st = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0))
    st["joint_pos"] = st["joint_pos"] + 0.01 * rng.standard_normal(12)
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    sd = _scene_np()
    u = 0.05 * rng.standard_normal((H, 4, 3, 1, L))
    jstate = JRobotState(**{k: jnp.asarray(v[None]) for k, v in st.items()})
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    jref = jax.jit(lambda t0: jrollout_tl.precompute_reference(
        JMODEL, _jclips(), jnp.asarray(0), t0, H, 0.004))(jnp.asarray(0.2, jnp.float64))
    j = dict(tl=JB.tl_from_state(jstate), u=jnp.asarray(u), scene=jscene, ref=jref,
             tp=jscene.target_pos, spd=jnp.asarray(1.2))
    p = dict(tl=from_jax.tl_state(j["tl"], CPU, F64), u=torch.as_tensor(u),
             scene=from_jax.box_scene(jscene, CPU, F64), ref=from_jax.ref_traj(jref, CPU),
             tp=torch.as_tensor(sd["target_pos"]), spd=torch.tensor(1.2, dtype=F64))
    return j, p


def _params(mass_freeze, substeps=2):
    jp = jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps, mass_freeze=mass_freeze)
    return jp, from_jax.physics_params(jp)


# (reward_type, weights, substeps, mass_freeze, gait_weight or None for
# rollout_traversal); one substep where the case adds nothing to the physics
# the others cover (each substep is ~2 s of XLA compile)
CASES = (
    ("joystick", {}, 2, 1, 1.0),
    ("average_speed", CRAWL, 2, 2, 0.7),
    ("average_speed", {}, 1, 1, None),
)


def _jax_reference(j):
    """Every JAX result of the rollout checks (one jit)."""
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)

    @jax.jit
    def run(j):
        tl = jax.tree.map(lambda x: jnp.broadcast_to(x, x.shape[:-2] + (1, L)), j["tl"])
        ts = jengine_tl.tl_scene(j["scene"])
        out = []
        for reward_type, w, substeps, mf, gait in CASES:
            jp = _params(mf, substeps)[0]
            wt = jtraversal.TraversalWeights(**w)
            if gait is None:
                out.append(jrollout_tasks.rollout_traversal(
                    jc, jp, tl, j["u"], ts, j["tp"], j["spd"], reward_type, 1000, wt))
            else:
                out.append(jrollout_tasks.rollout_traversal_gait(
                    jc, jp, tl, j["u"], ts, j["ref"], j["tp"], j["spd"], reward_type, 1000, wt,
                    gait_weight=gait))
        # the stage-cost oracles on the final states of the first rollout
        s = JB.state_from_tl(out[0][1])
        wt = jtraversal.TraversalWeights(**CRAWL)
        oracles = dict(
            posture=jtraversal.posture_cost(s, wt),
            joystick=jtraversal.joystick_cost(s, j["tp"], j["spd"]),
            progress=jtraversal.progress_cost(s, j["tp"], 1.0)[0],
            clearance=jtraversal.clearance_cost(j["scene"], s, crawl_gap=0.18),
            joystick_tl=jrollout_tasks.joystick_cost_tl(out[0][1], j["tp"][:, None, None],
                                                        j["spd"]),
            clearance_tl=jrollout_tasks.clearance_cost_tl(ts, out[0][1].base_pos, crawl_gap=0.18),
        )
        return out, oracles

    return run(j)


def _check_rollouts_float64(rng):
    j, p = _inputs(rng)
    want, oracles = _jax_reference(j)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    ts = engine_tl.tl_scene(p["scene"])
    for (reward_type, w, substeps, mf, gait), (wcost, wfinal) in zip(CASES, want):
        pp = _params(mf, substeps)[1]
        wt = traversal.TraversalWeights(**w)
        if gait is None:
            cost, final = rollout_tasks.rollout_traversal(
                c, pp, p["tl"], p["u"], ts, p["tp"], p["spd"], reward_type, 1000, wt)
        else:
            cost, final = rollout_tasks.rollout_traversal_gait(
                c, pp, p["tl"], p["u"], ts, p["ref"], p["tp"], p["spd"], reward_type, 1000, wt,
                gait_weight=gait)
        assert_close(cost, wcost, rtol=1e-9, atol=1e-9)
        assert_tree_close(final, wfinal, rtol=1e-9, atol=1e-9)
        if gait is not None:  # the wrapper on CPU tensors is its plain version
            before = traversal_cuda.rollout_traversal_fused.launches
            got = traversal_cuda.rollout_traversal_fused(
                c, pp, p["tl"], p["u"], p["scene"], p["ref"], p["tp"], p["spd"], reward_type,
                1000, wt, gait_weight=gait)
            assert_close(got, wcost, rtol=1e-9, atol=1e-9)
            assert traversal_cuda.rollout_traversal_fused.launches == before
        else:  # gait_weight 0 + a constant reference at q0 is rollout_traversal
            rows = traversal_cuda.constant_reference(p["tl"].joint_pos, H)
            got = traversal_cuda.rollout_traversal_fused(
                c, pp, p["tl"], p["u"], p["scene"], rows, p["tp"], p["spd"], reward_type, 1000,
                wt, gait_weight=0.0)
            assert_close(got, cost, rtol=1e-12, atol=1e-12)
            # the gait term is skipped, not multiplied by 0: a non-finite
            # reference joint cannot turn the cost into NaN
            rows[:, 12:36] = float("inf")
            bad = traversal_cuda.rollout_traversal_fused(
                c, pp, p["tl"], p["u"], p["scene"], rows, p["tp"], p["spd"], reward_type, 1000,
                wt, gait_weight=0.0)
            assert_close(bad, got, rtol=0, atol=0)

    # readable oracles and tile stage costs on the first rollout's final states
    s = B.state_from_tl(final_of_first := rollout_tasks.rollout_traversal_gait(
        c, _params(1)[1], p["tl"], p["u"], ts, p["ref"], p["tp"], p["spd"], "joystick")[1])
    wt = traversal.TraversalWeights(**CRAWL)
    got = dict(
        posture=traversal.posture_cost(s, wt),
        joystick=traversal.joystick_cost(s, p["tp"], p["spd"]),
        progress=traversal.progress_cost(s, p["tp"], 1.0)[0],
        clearance=traversal.clearance_cost(p["scene"], s, crawl_gap=0.18),
        joystick_tl=rollout_tasks.joystick_cost_tl(final_of_first, p["tp"][:, None, None],
                                                   p["spd"]),
        clearance_tl=rollout_tasks.clearance_cost_tl(ts, final_of_first.base_pos,
                                                     crawl_gap=0.18),
    )
    for k, v in got.items():
        assert_close(v, oracles[k], rtol=1e-9, atol=1e-9)
    return c, p, want


def _check_rollout_float32(p, want):
    """The port in float32 (inputs rounded to float32) against the float64
    reference of the gait case with crawl_gap weights and mass_freeze 2, at
    the Pallas kernel's 2e-4."""
    reward_type, w, substeps, mf, gait = CASES[1]
    f32 = torch.float32
    c = B.tl_constants(MODEL, dtype=f32, device=CPU)
    tl = B.map_state(lambda x: x.to(f32), p["tl"])
    scene = p["scene"]._replace(center=p["scene"].center.to(f32), half=p["scene"].half.to(f32),
                                target_pos=p["scene"].target_pos.to(f32))
    got = traversal_cuda.rollout_traversal_fused(
        c, _params(mf, substeps)[1], tl, p["u"].to(f32), scene, p["ref"], p["tp"].to(f32),
        p["spd"].to(f32), reward_type, 1000, traversal.TraversalWeights(**w), gait_weight=gait)
    assert got.dtype == f32
    assert_close(got, want[1][0], rtol=2e-4, atol=2e-4)


def _check_scenarios(c, p):
    """S = 2 scenario blocks (own box table, reference rows and target each)
    equal one call per scenario."""
    pp = _params(1)[1]
    tab = traversal_cuda.pack_boxes(p["scene"])
    tab2 = tab.clone()
    tab2[:, 0] += 0.05  # the second scenario's boxes shifted along x
    rows = rollout_cuda.pack_reference(p["ref"]).to(F64)
    u = torch.cat([p["u"], 0.5 * p["u"]], dim=3)  # (H, 4, 3, 2, L)
    tps = torch.stack([p["tp"], p["tp"] + 1.0])
    spds = torch.tensor([1.2, 0.8], dtype=F64)
    both = traversal_cuda.rollout_traversal_fused(
        c, pp, p["tl"], u, torch.stack([tab, tab2]), torch.stack([rows, 2.0 * rows]), tps, spds,
        "average_speed")
    for k, (t, r) in enumerate(((tab, rows), (tab2, 2.0 * rows))):
        one = traversal_cuda.rollout_traversal_fused(
            c, pp, p["tl"], u[:, :, :, k:k + 1].contiguous(), t, r, tps[k], spds[k],
            "average_speed")
        assert_close(both[k:k + 1], one, rtol=0, atol=0)
    assert not torch.equal(both[0], both[1])


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_traversal_rollouts_match_reference():
    c, p, want = _check_rollouts_float64(np.random.default_rng(51))
    _check_scenarios(c, p)
    _check_rollout_float32(p, want)


def test_traversal_controllers_match_reference_with_injected_noise():
    """Two solves of each controller (the second from the first's warm
    start) against the JAX controllers fed the same normals."""
    rng = np.random.default_rng(52)
    jp, pp = _params(1, substeps=1)  # the physics is held above; one substep compiles fast
    cfg = jmppi.MPPIConfig(horizon=H, population=L, iterations=1, sigma=0.15)
    pcfg = mppi.MPPIConfig(*cfg)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    st = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0))
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    sd = _scene_np()
    jrobot = JRobotState(**{k: jnp.asarray(v) for k, v in st.items()})
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    robot = from_jax.robot_state(jrobot, CPU, F64)
    scene = from_jax.box_scene(jscene, CPU, F64)
    tp, spd = jscene.target_pos, jnp.asarray(1.2)
    shape = (H, 4, 3, 1, L)

    def eps_of(k):
        return [torch.as_tensor(np.array(jax.random.normal(ki, shape, jnp.float64)))
                for ki in jax.random.split(k, cfg.iterations)]

    jctrl = jmpc_tasks.make_traversal_controller(JMODEL, jc, jp, cfg,
                                                 reward_type="average_speed")
    ctrl = mpc_tasks.make_traversal_controller(MODEL, c, pp, pcfg, reward_type="average_speed",
                                               device=CPU)
    clips = from_jax.motion_clips(_jclips(), device=CPU)
    jgait = jmpc_tasks.make_gait_traversal_controller(JMODEL, jc, jp, cfg, _jclips(),
                                                      reward_type="joystick")
    gait = mpc_tasks.make_gait_traversal_controller(MODEL, c, pp, pcfg, clips,
                                                    reward_type="joystick", device=CPU)
    ju = jnp.zeros((H, 4, 3))
    u = torch.zeros((H, 4, 3), dtype=F64)
    jg, g = ju, u
    for i in range(2):
        k = jax.random.PRNGKey(10 + i)
        jtgt, ju, jdiag = jctrl(k, jrobot, jscene, tp, spd, ju)
        tgt, u, diag = ctrl(None, robot, scene, torch.as_tensor(np.array(tp)),
                            torch.tensor(1.2, dtype=F64), u, eps=eps_of(k))
        for got, want in ((tgt, jtgt), (u, ju), (diag["best_cost"], jdiag["best_cost"]),
                          (diag["weighted_cost"], jdiag["weighted_cost"])):
            assert_close(got, want, rtol=1e-9, atol=1e-9)
        # clip time in float64 on both sides (a weakly typed jnp scalar would
        # make JAX interpolate the float32 clip in float32)
        t_clip = 0.3 + 0.002 * i
        jtgt, jg, jdiag = jgait(k, jrobot, jscene, tp, spd, jnp.asarray(t_clip, jnp.float64), jg)
        tgt, g, diag = gait(None, robot, scene, torch.as_tensor(np.array(tp)),
                            torch.tensor(1.2, dtype=F64), torch.tensor(t_clip, dtype=F64), g,
                            eps=eps_of(k))
        # 1e-8, as the PMC closed loop of tests/test_torch_run_mpc.py: the
        # gait term reads the clip's float32 finite-difference joint
        # velocities, which XLA's jitted reference rounds differently from an
        # op-by-op evaluation (2.4e-7; the cause of the 1e-6 reference
        # tolerance of tests/test_torch_rollout.py), and costs, plans and
        # targets then differ by 1e-9 to 1e-8 relative. Run op by op
        # (jax.disable_jit) the JAX controller agrees at 1e-9, at 35 s
        # instead of 5.
        for got, want in ((tgt, jtgt), (g, jg), (diag["best_cost"], jdiag["best_cost"]),
                          (diag["weighted_cost"], jdiag["weighted_cost"])):
            assert_close(got, want, rtol=1e-8, atol=1e-8)
    assert float(u.abs().max()) > 1e-3 and float(g.abs().max()) > 1e-3  # the plans moved

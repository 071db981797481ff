"""The SEPMC chase arenas, costs, rollouts (K3, K4) and solvers of
lifelike_tpu_torch vs the JAX reference, on the CPU.

Arena tables are held exactly: the fixed arenas V1-V3 and the procedural V4
table built from the JAX arena's own random numbers. The chase costs and
the six chase / plan rollouts are held against the JAX functions of the same
names — the functions the Pallas kernels are pinned to in
tests/test_traversal_pallas.py — in float64 at 1e-9, on a scene carried over
by compat.from_jax where box contact fires on the feet, the wheels and the
trunk from the first substep, and one float32 case at the Pallas kernels'
own 2e-4. The kernels' plain versions (ops.traversal_cuda.rollout_plan_plain
and rollout_chase_plain, which the wrappers run for CPU tensors) equal the
rollouts, scenario-batched too; the kernels' launch geometry (lanes per
candidate, candidates per block, grid, the refused scenario blocks) is
checked in pure Python. The raw-delta chase solver is held against
the JAX solver with injected noise (the normals JAX draws) over two solves
with a role switch at 1e-9; `check_chase_solver` also serves
tests/test_torch_chase_env.py, which holds the gait solver.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.costs import chase as jchase
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import engine_tl as jengine_tl
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import arena_fixed as jarena_fixed
from lifelike_tpu.scene import arena_gen as jarena_gen
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu.solver import mpc_tasks as jmpc_tasks
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import rollout_tasks as jrollout_tasks
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.costs import chase
from lifelike_tpu_torch.ops import rollout_cuda, traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine_tl
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_fixed, arena_gen
from lifelike_tpu_torch.solver import mpc_tasks, mppi, rollout_tasks

from tests.torch_port_util import (
    CPU,
    F64,
    assert_close,
    assert_tree_close,
    contact_scene,
    random_robot_state,
    stand_state,
)

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, L = 3, 128  # horizon, population 128


@functools.lru_cache(maxsize=None)
def _jclips():
    return jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)


def _draws_of(scene, cfg):
    """The random numbers behind a JAX V4 arena table (halves are exact
    halvings, so twice them is the draw)."""
    c, h = np.asarray(scene.center), np.asarray(scene.half)
    d, idx = {}, 4
    if cfg.rand_cube:
        rows = slice(idx, idx + 6)
        d.update(cube_h=2 * h[rows, 2], cube_xy=c[rows, :2], cube_len=2 * h[rows, 0],
                 cube_wid=2 * h[rows, 1])
        idx += 6
    if cfg.hurdle:
        d["hurdle_h"] = 2 * h[idx, 2]
        idx += 1
    if cfg.hole:
        d["hole_gap"] = c[idx, 2] - 0.15
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def _check_arenas():
    A = arena_gen.ArenaConfig
    for i, cfg in enumerate((A(), A(True, True, True), A(hurdle=True), A(rand_cube=True, hole=True))):
        js = jarena_gen.generate(jax.random.PRNGKey(3 + i), jarena_gen.ArenaConfig(*cfg),
                                 jnp.float64)
        got = arena_gen.assemble(cfg, _draws_of(js, cfg), F64, CPU)
        assert got.center.shape[0] == arena_gen.capacity(cfg) == js.center.shape[0]
        assert_tree_close(got, from_jax.box_scene(js, CPU, F64), rtol=0, atol=0)
        # the port's own draws: same table layout, draws in range
        gen = torch.Generator().manual_seed(i)
        scenes = [arena_gen.generate(gen, cfg, F64) for _ in range(64)]
        act = torch.stack([s.active for s in scenes])
        np.testing.assert_array_equal(act.numpy(), np.broadcast_to(np.asarray(js.active),
                                                                   act.shape))
        for s in scenes:
            assert_close(s.center[:4], np.asarray(js.center[:4]), rtol=0, atol=0)
        if cfg.rand_cube:
            h = 2 * torch.stack([s.half[4:10] for s in scenes])
            xy = torch.stack([s.center[4:10, :2] for s in scenes])
            assert bool(((h[..., 2] >= 0.05) & (h[..., 2] <= 0.25)).all())
            assert bool(((h[..., :2] >= 0.5) & (h[..., :2] <= 1.0)).all())
            assert bool((xy.abs() <= 2.0).all()) and abs(float(xy.mean())) < 0.15
    # fixed arenas: the static tables and their scenes
    for name, kw in (("arena_v1", {}), ("arena_v1", {"small": True}), ("arena_v2", {}),
                     ("arena_v2", {"holes": True}), ("arena_v3", {})):
        got, want = getattr(arena_fixed, name)(**kw), getattr(jarena_fixed, name)(**kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for version in ("v1", "v2", "v3"):
        want = jarena_fixed.make_arena(version, holes=True, dtype=jnp.float64)
        got = arena_fixed.make_arena(version, holes=True, dtype=F64, device=CPU)
        assert_tree_close(got, from_jax.box_scene(want, CPU, F64), rtol=0, atol=0)
    # randomize_height: elements move in range, walls never
    arena = arena_fixed.arena_v2(holes=True)
    s = arena_fixed.to_scene(arena, torch.Generator().manual_seed(1), (0.0, 0.1), (32,), F64)
    off = (s.center[..., 2] - torch.as_tensor(arena.centers[:, 2], dtype=F64)).numpy()
    assert (off[:, ~arena.element] == 0).all()
    assert ((off[:, arena.element] >= 0) & (off[:, arena.element] <= 0.1)).all()
    assert off[:, arena.element].std() > 0.02


def _check_costs(rng):
    st = random_robot_state(rng, (16,))
    # a quarter of the robots rolled over, so the fall term fires
    st["base_orn"][:4] = [np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]
    opp = rng.uniform(-2, 2, (16, 3))
    flag = rng.uniform(-2, 2, 3)
    jstate = JRobotState(**{k: jnp.asarray(v) for k, v in st.items()})
    want = jax.jit(lambda s, o, f: (jchase.chaser_cost(s, o), jchase.escapee_cost(s, o, f, 0.5)))(
        jstate, jnp.asarray(opp), jnp.asarray(flag))
    state = from_jax.robot_state(jstate, CPU, F64)
    got = (chase.chaser_cost(state, torch.as_tensor(opp)),
           chase.escapee_cost(state, torch.as_tensor(opp), torch.as_tensor(flag), 0.5))
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-9, atol=1e-9)
    assert float(got[0][:4].min()) > 5.0  # fallen: + fall weight


def _inputs(rng):
    """(JAX inputs, port inputs), float64: one start state (perturbed stand
    at 0.36 m, in contact with the scene), candidates and a plan 0.05 N(0, 1),
    the scene, the gait reference, the opponent's path and the flag."""
    st = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0))
    st["joint_pos"] = st["joint_pos"] + 0.01 * rng.standard_normal(12)
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    sd = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)))
    u = 0.05 * rng.standard_normal((H, 4, 3, 1, L))
    plan = 0.05 * rng.standard_normal((H, 4, 3))
    s = np.linspace(0.0, 1.0, H)
    opp = np.stack([1.0 + 0.5 * s, 0.2 - 0.2 * s, np.full(H, 0.3)], -1)[..., None, None]
    flag = np.array([2.0, -1.0, 0.3])
    jstate = JRobotState(**{k: jnp.asarray(v[None]) for k, v in st.items()})
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    jref = jax.jit(lambda t0: jrollout_tl.precompute_reference(
        JMODEL, _jclips(), jnp.asarray(0), t0, H, 0.004))(jnp.asarray(0.2, jnp.float64))
    j = dict(tl=JB.tl_from_state(jstate), u=jnp.asarray(u), plan=jnp.asarray(plan),
             scene=jscene, ref=jref, opp=jnp.asarray(opp), flag=jnp.asarray(flag))
    p = dict(tl=from_jax.tl_state(j["tl"], CPU, F64), u=torch.as_tensor(u),
             plan=torch.as_tensor(plan), scene=from_jax.box_scene(jscene, CPU, F64),
             ref=from_jax.ref_traj(jref, CPU), opp=torch.as_tensor(opp),
             flag=torch.as_tensor(flag))
    return j, p


def _params(mass_freeze, substeps):
    jp = jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps, mass_freeze=mass_freeze)
    return jp, from_jax.physics_params(jp)


# (rollout, role or None for a plan, substeps, mass_freeze, gait_weight);
# one substep where a case adds nothing to the physics the others cover
CASES = (
    ("rollout_chase", True, 1, 1, None),
    ("rollout_chase_gait", False, 2, 2, 0.8),
    ("rollout_plan", None, 1, 1, None),
    ("rollout_plan_gait", None, 1, 1, None),
)


def _jax_reference(j):
    """Every JAX result of the rollout checks (one jit)."""
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)

    @jax.jit
    def run(j):
        tl = jax.tree.map(lambda x: jnp.broadcast_to(x, x.shape[:-2] + (1, L)), j["tl"])
        ts = jengine_tl.tl_scene(j["scene"])
        out = []
        for name, role, substeps, mf, gait in CASES:
            jp = _params(mf, substeps)[0]
            fn = getattr(jrollout_tasks, name)
            if name == "rollout_chase":
                out.append(fn(jc, jp, tl, j["u"], ts, j["opp"], j["flag"], jnp.asarray(role)))
            elif name == "rollout_chase_gait":
                out.append(fn(jc, jp, tl, j["u"], ts, j["ref"], j["opp"], j["flag"],
                              jnp.asarray(role), gait_weight=gait))
            elif name == "rollout_plan":
                out.append(fn(jc, jp, j["tl"], j["plan"], ts))
            else:
                out.append(fn(jc, jp, j["tl"], j["plan"], ts, j["ref"]))
        final = out[0][1]
        stage = (jrollout_tasks.chaser_cost_tl(final, j["opp"][-1]),
                 jrollout_tasks.escapee_cost_tl(final, j["opp"][-1], j["flag"][:, None, None],
                                                0.5))
        return out, stage

    return run(j)


def _check_rollouts_float64(rng):
    j, p = _inputs(rng)
    want, want_stage = _jax_reference(j)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    ts = engine_tl.tl_scene(p["scene"])
    const = traversal_cuda.constant_reference(p["tl"].joint_pos, H)
    for (name, role, substeps, mf, gait), w in zip(CASES, want):
        pp = _params(mf, substeps)[1]
        fn = getattr(rollout_tasks, name)
        if name == "rollout_chase":
            cost, final = fn(c, pp, p["tl"], p["u"], ts, p["opp"], p["flag"], role)
            # gait_weight 0 + a constant reference at q0 is rollout_chase
            got = traversal_cuda.rollout_chase_fused(c, pp, p["tl"], p["u"], p["scene"], const,
                                                     p["opp"], p["flag"], role, gait_weight=0.0)
            assert_close(got, cost, rtol=1e-12, atol=1e-12)
            bad = const.clone()
            bad[:, 12:36] = float("inf")  # the gait term is skipped, not multiplied by 0
            assert_close(traversal_cuda.rollout_chase_fused(
                c, pp, p["tl"], p["u"], p["scene"], bad, p["opp"], p["flag"], role,
                gait_weight=0.0), got, rtol=0, atol=0)
        elif name == "rollout_chase_gait":
            cost, final = fn(c, pp, p["tl"], p["u"], ts, p["ref"], p["opp"], p["flag"],
                             torch.tensor(role), gait_weight=gait)
            before = traversal_cuda.rollout_chase_fused.launches
            got = traversal_cuda.rollout_chase_fused(c, pp, p["tl"], p["u"], p["scene"], p["ref"],
                                                     p["opp"], p["flag"], torch.tensor(role),
                                                     gait_weight=gait)
            assert_close(got, w[0], rtol=1e-9, atol=1e-9)
            assert traversal_cuda.rollout_chase_fused.launches == before  # plain version
        if role is not None:
            assert_close(cost, w[0], rtol=1e-9, atol=1e-9)
            assert_tree_close(final, w[1], rtol=1e-9, atol=1e-9)
            continue
        if name == "rollout_plan":
            traj = fn(c, pp, p["tl"], p["plan"], ts)
            fused = traversal_cuda.rollout_plan_fused(c, pp, p["tl"], p["plan"], p["scene"], const)
        else:
            traj = fn(c, pp, p["tl"], p["plan"], ts, p["ref"])
            fused = traversal_cuda.rollout_plan_fused(c, pp, p["tl"], p["plan"], p["scene"],
                                                      p["ref"])
        assert tuple(traj.shape) == (H, 3, 1, 1)
        assert_close(traj, w, rtol=1e-9, atol=1e-9)
        assert_close(fused, w, rtol=1e-9, atol=1e-9)
    s = rollout_tasks.rollout_chase(c, _params(1, 1)[1], p["tl"], p["u"], ts, p["opp"],
                                    p["flag"], True)[1]
    got = (rollout_tasks.chaser_cost_tl(s, p["opp"][-1]),
           rollout_tasks.escapee_cost_tl(s, p["opp"][-1], p["flag"][:, None, None], 0.5))
    for g, w in zip(got, want_stage):
        assert_close(g, w, rtol=1e-9, atol=1e-9)
    return c, p, want


def _check_scenarios(c, p):
    """K4's S = 4 scenario blocks (own box table, reference rows, opponent
    path, flag and role each) equal one call per scenario; K3's S = 4 plans
    (own start states, tables and references) equal one call per plan."""
    pp = _params(1, 1)[1]
    S = 4
    tab = traversal_cuda.pack_boxes(p["scene"])
    tabs = torch.stack([tab + 0.0] * S)
    tabs[:, :, 0] += 0.05 * torch.arange(S, dtype=F64)[:, None]
    rows = rollout_cuda.pack_reference(p["ref"]).to(F64)
    refs = torch.stack([rows * (1.0 + 0.01 * k) for k in range(S)])
    u = torch.cat([p["u"] * (1.0 - 0.2 * k) for k in range(S)], dim=3)  # (H, 4, 3, S, L)
    opps = torch.stack([p["opp"].reshape(H, 3) + 0.3 * k for k in range(S)])
    flags = torch.stack([p["flag"] * (1.0 - 0.5 * k) for k in range(S)])
    roles = torch.tensor([True, False, False, True])
    all_ = traversal_cuda.rollout_chase_fused(c, pp, p["tl"], u, tabs, refs, opps, flags, roles,
                                              gait_weight=0.5)
    for k in range(S):
        one = traversal_cuda.rollout_chase_fused(c, pp, p["tl"], u[:, :, :, k:k + 1].contiguous(),
                                                 tabs[k], refs[k], opps[k], flags[k], roles[k],
                                                 gait_weight=0.5)
        assert_close(all_[k:k + 1], one, rtol=0, atol=0)
    assert len({float(x) for x in all_[:, 0]}) == S

    states = B.map_state(lambda x: torch.cat([x + 0.01 * k for k in range(S)], dim=-2), p["tl"])
    plans = torch.stack([p["plan"] * (1.0 + 0.5 * k) for k in range(S)])
    traj = traversal_cuda.rollout_plan_fused(c, pp, states, plans, tabs, refs)
    assert tuple(traj.shape) == (H, 3, S, 1)
    for k in range(S):
        one = traversal_cuda.rollout_plan_plain(c, pp, B.map_state(lambda x: x[..., k:k + 1, :],
                                                                   states),
                                                plans[k], tabs[k], refs[k])
        assert_close(traj[:, :, k:k + 1], one, rtol=1e-12, atol=1e-12)
    # what the kernels cannot take is refused, not broadcast
    with pytest.raises(ValueError, match="batch"):  # K4: one start state per launch
        traversal_cuda.rollout_chase_fused(c, pp, states, u, tabs, refs, opps, flags, roles)
    with pytest.raises(ValueError, match="tables"):  # K3: one table per plan
        traversal_cuda.rollout_plan_fused(c, pp, states, plans, tabs[:2], refs)


def _check_rollout_float32(p, want):
    """The port in float32 (inputs rounded to float32) against the float64
    reference of the gait escapee case (substeps 2, mass_freeze 2), at the
    Pallas kernels' 2e-4."""
    name, role, substeps, mf, gait = CASES[1]
    f32 = torch.float32
    c = B.tl_constants(MODEL, dtype=f32, device=CPU)
    tl = B.map_state(lambda x: x.to(f32), p["tl"])
    scene = p["scene"]._replace(center=p["scene"].center.to(f32), half=p["scene"].half.to(f32))
    got = traversal_cuda.rollout_chase_fused(c, _params(mf, substeps)[1], tl, p["u"].to(f32),
                                             scene, p["ref"], p["opp"].to(f32), p["flag"].to(f32),
                                             role, gait_weight=gait)
    assert got.dtype == f32
    assert_close(got, want[1][0], rtol=2e-4, atol=2e-4)


def _check_launch_geometry():
    """The wrappers' launch geometry (pure Python, no kernel): K4 rolls each
    candidate on four lanes, eight candidates per one-warp block, so 2048
    candidates make 256 blocks; K3 rolls each plan on eight lanes of a warp;
    K2 rolls each candidate on eight lanes, four candidates per one-warp
    block, so the EPMC solve's 4096 candidates make 1024 blocks. A scenario
    block must hold whole blocks of candidates, or the launch is refused."""
    tc = traversal_cuda
    assert tc.launch_geometry(tc.CHASE_KERNEL, 2048) == (4, 32, 8, 256)
    assert tc.launch_geometry(tc.CHASE_KERNEL, 2048, 4).blocks == 256
    assert tc.launch_geometry(tc.CHASE_KERNEL, 20).blocks == 3  # a ragged last block
    assert tc.launch_geometry(tc.PLAN_KERNEL, 16) == (8, 32, 1, 16)
    assert tc.launch_geometry(tc.KERNEL, 4096, 4) == (8, 32, 4, 1024)
    assert tc.launch_geometry(tc.KERNEL, 250).blocks == 63
    with pytest.raises(ValueError, match="multiple of 8"):
        tc.launch_geometry(tc.CHASE_KERNEL, 16, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.launch_geometry(tc.KERNEL, 24, 4)
    with pytest.raises(ValueError, match="scenarios"):
        tc.launch_geometry(tc.CHASE_KERNEL, 10, 4)


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_chase_arenas_costs_and_rollouts_match_reference():
    rng = np.random.default_rng(61)
    _check_arenas()
    _check_costs(rng)
    c, p, want = _check_rollouts_float64(rng)
    _check_scenarios(c, p)
    _check_rollout_float32(p, want)
    _check_launch_geometry()


def check_chase_solver(gait_prior, n_best_response, tol):
    """Two solves of make_chase_solver (or, gait_prior, of
    make_gait_chase_solver at gait weight 0.7) — the second from the first's
    warm start, with the roles swapped — against the JAX solver fed the same
    normals, at tol. Shared with tests/test_torch_chase_env.py, which holds
    the gait solver (each JAX solve takes 8-14 s to compile)."""
    rng = np.random.default_rng(62)
    jp, pp = _params(1, 1)  # the physics is held above; one substep compiles fast
    cfg = jmppi.MPPIConfig(horizon=H, population=L, iterations=1, sigma=0.15)
    pcfg = mppi.MPPIConfig(*cfg)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    st = [stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0)),
          stand_state(pos=(0.8, 0.3, 0.36), vel=(0.0, 0.2, 0.0), yaw=2.5)]
    robots_np = {k: np.stack([s[k] for s in st]) for k in st[0]}
    robots_np["joint_vel"] = 0.1 * rng.standard_normal((2, 12))
    sd = contact_scene(MODEL, st[0])
    jrobots = JRobotState(**{k: jnp.asarray(v) for k, v in robots_np.items()})
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    robots = from_jax.robot_state(jrobots, CPU, F64)
    scene = from_jax.box_scene(jscene, CPU, F64)
    flag = np.array([2.0, -1.0, 0.25])
    shape = (H, 4, 3, 1, L)

    @jax.jit
    def normals(k):
        """The normals of the JAX solve with key k: one split per update,
        then one per MPPI iteration."""
        out = []
        for _ in range(n_best_response * 2):
            k, ki = jax.random.split(k)
            out.append([jax.random.normal(kk, shape, jnp.float64)
                        for kk in jax.random.split(ki, cfg.iterations)])
        return out

    if gait_prior:
        clips = from_jax.motion_clips(_jclips(), device=CPU)
        jsolve = jmpc_tasks.make_gait_chase_solver(JMODEL, jc, jp, cfg, _jclips(),
                                                   n_best_response=n_best_response,
                                                   gait_weight=0.7)
        solve = mpc_tasks.make_gait_chase_solver(MODEL, c, pp, pcfg, clips,
                                                 n_best_response=n_best_response,
                                                 gait_weight=0.7, device=CPU)
    else:
        jsolve = jmpc_tasks.make_chase_solver(JMODEL, jc, jp, cfg,
                                              n_best_response=n_best_response)
        solve = mpc_tasks.make_chase_solver(MODEL, c, pp, pcfg, n_best_response=n_best_response,
                                            device=CPU)
    ju = jnp.zeros((2, H, 4, 3))
    u = torch.zeros((2, H, 4, 3), dtype=F64)
    launches = (traversal_cuda.rollout_plan_fused.launches,
                traversal_cuda.rollout_chase_fused.launches)
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        role = np.array([i == 0, i != 0])  # the roles swap between the solves
        jargs = (k, jrobots, jscene, jnp.asarray(flag), jnp.asarray(role))
        args = (None, robots, scene, torch.as_tensor(flag), torch.as_tensor(role))
        if gait_prior:
            t_clip = 0.3 + 0.04 * i  # float64 on both sides, see test_torch_traversal.py
            jargs += (jnp.asarray(t_clip, jnp.float64),)
            args += (torch.tensor(t_clip, dtype=F64),)
        jtgt, ju, jdiag = jsolve(*jargs, ju)
        eps = [[torch.as_tensor(np.array(e)) for e in upd] for upd in normals(k)]
        tgt, u, diag = solve(*args, u, eps=eps)
        for got, want in ((tgt, jtgt), (u, ju), (diag["best_cost"], jdiag["best_cost"]),
                          (diag["weighted_cost"], jdiag["weighted_cost"])):
            assert_close(got, want, rtol=tol, atol=tol)
    assert float(u.abs().max()) > 1e-3  # the plans moved
    # on CPU tensors the wrappers run their plain versions: no kernel launch
    assert (traversal_cuda.rollout_plan_fused.launches,
            traversal_cuda.rollout_chase_fused.launches) == launches


def test_chase_solver_matches_reference_with_injected_noise():
    """The raw-delta solver over two best-response rounds (the second reads
    the plans of the first) at 1e-9."""
    check_chase_solver(gait_prior=False, n_best_response=2, tol=1e-9)

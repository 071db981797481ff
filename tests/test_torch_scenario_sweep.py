"""The SEPMC scenario sweep of lifelike_tpu_torch (parallel.scenario_sweep)
vs the JAX reference, on the CPU (where K3 / K4's wrappers run their plain
versions).

Shapes are the reference test's (tests/test_scenario_sweep.py): S 2
scenarios with randomized cubes, H 3, population 32 per robot, substeps 2,
kd 1, max_tau 16, sigma 0.15, float64. The port's scenarios are assembled
from the JAX generator's own random numbers and equal JAX's exactly, once
JAX's robots are stood on any cube under their spawn footprint (the port's
spawn_height, computed here with the JAX package's heightmap_at); the
tiled sweep is fed the normals JAX draws (its per-scenario key schedule)
and held at rtol = atol = 1e-8 over 1 and 2 best-response rounds. JAX's
tiled sweep (`_tiled_from_keys` on split(key, S), what sweep_scenarios_tiled
runs) is compiled once for one round; its second round is a second call
with the keys advanced as the two-round sweep advances them (its two
per-robot splits) and the first round's plans as the warm start.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.parallel import scenario_sweep as jsweep
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import arena_gen as jarena_gen
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.ops import traversal_cuda
from lifelike_tpu_torch.parallel import scenario_sweep
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import arena_gen
from lifelike_tpu_torch.solver import mppi_tl, rollout_tasks
from lifelike_tpu_torch.solver.mppi import MPPIConfig

from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close

JPARAMS = jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=2)
PARAMS = from_jax.physics_params(JPARAMS)
JCFG = jmppi.MPPIConfig(horizon=3, population=32, iterations=1, sigma=0.15)
CFG = MPPIConfig(*JCFG)
ARENA = arena_gen.ArenaConfig(rand_cube=True)
TOL = dict(rtol=1e-8, atol=1e-8)


def _jax_draws(key, n, dtype=jnp.float64):
    """jsweep.generate_scenarios' random numbers in scenario_sweep.draw's
    form (its key schedule, jarena_gen.generate's for each arena): a dict
    of arrays, with the arenas' stacked under "arena"."""
    k_arena, k_start, k_flag, k_role = jax.random.split(key, 4)
    arenas = []
    for ka in jax.random.split(k_arena, n):
        kk = jax.random.split(jax.random.split(ka, 3)[0], 4)
        arenas.append(dict(
            cube_h=jax.random.uniform(kk[0], (6,), dtype, 0.05, 0.25),
            cube_xy=jax.random.uniform(kk[1], (6, 2), dtype, -2.0, 2.0),
            cube_len=jax.random.uniform(kk[2], (6,), dtype, 0.5, 1.0),
            cube_wid=jax.random.uniform(kk[3], (6,), dtype, 0.5, 1.0)))
    ks = jax.random.split(k_start, 4)
    raw = dict(x0=jax.random.uniform(ks[0], (n,), dtype, -2.0, -1.0),
               x1=jax.random.uniform(ks[1], (n,), dtype, 1.0, 2.0),
               ys=jax.random.uniform(ks[2], (n, 2), dtype, -1.5, 1.5),
               flag_xy=jax.random.uniform(k_flag, (n, 2), dtype, -2.0, 2.0),
               chaser0=jax.random.bernoulli(k_role, 0.5, (n,)))
    raw["arena"] = {k: jnp.stack([a[k] for a in arenas]) for k in arenas[0]}
    return raw


def _stand_on_cubes(jscen):
    """JAX's scenarios with each robot STAND_HEIGHT above the highest box
    top under its spawn footprint (scenario_sweep.spawn_height's rule)."""
    fp = jnp.asarray(scenario_sweep._FOOTPRINT)
    xy = jscen.robots.base_pos[..., :2]  # (S, 2, 2)
    pts = (xy[..., None, :] + fp).reshape(xy.shape[0], -1, 2)
    h = jboxes.heightmap_at(jscen.scene, pts).reshape(xy.shape[:-1] + (-1,)).max(-1)
    pos = jscen.robots.base_pos.at[..., 2].set(scenario_sweep.STAND_HEIGHT + h)
    return jscen._replace(robots=jscen.robots._replace(base_pos=pos))


@functools.partial(jax.jit, static_argnums=1)
def _jax_scenarios(key, n):
    """JAX's scenarios stood on their cubes, and their random numbers (one
    compile for both)."""
    jscen = jsweep.generate_scenarios(key, n, jarena_gen.ArenaConfig(rand_cube=True),
                                      dtype=jnp.float64)
    return _stand_on_cubes(jscen), _jax_draws(key, n)


def _advance(keys):
    """The tiled sweep's per-robot key step: keys <- split(keys)[:, 0]."""
    return jax.vmap(jax.random.split)(keys)[:, 0]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_normals(keys, n_rounds, shape):
    """The raw normals the JAX tiled sweep draws from per-scenario keys, in
    scenario_sweep.draw_noise's layout (one iteration per update)."""
    out = []
    for _ in range(n_rounds):
        for _ in (0, 1):
            split = jax.vmap(jax.random.split)(keys)
            keys, k_solve = split[:, 0], split[:, 1]
            k_it = jax.vmap(lambda k: jax.random.split(k, 1))(k_solve)[:, 0]
            eps = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(k_it)
            out.append(jnp.moveaxis(eps, 0, -3).reshape(shape[:3] + (-1, shape[-1])))
    return out


def _check_tiled_sweep_matches_reference():
    key, n = jax.random.PRNGKey(7), 2
    jscen, draws = _jax_scenarios(key, n)
    draws = jax.tree.map(lambda x: torch.as_tensor(np.array(x)), draws)
    scen = scenario_sweep.assemble(ARENA, draws, F64, CPU)
    want = from_jax.scenario_batch(jscen, CPU, F64)
    for got_t, want_t in ((scen.scene, want.scene), (scen.robots, want.robots)):
        assert_tree_close(got_t, want_t, rtol=0, atol=0)
    assert_close(scen.flag_pos, want.flag_pos, rtol=0, atol=0)
    assert torch.equal(scen.with_flag, want.with_flag)

    jc = JB.tl_constants(j_build_max_model(), dtype=jnp.float64)
    one_round = jax.jit(lambda k, s, uw: jsweep._tiled_from_keys(jc, JPARAMS, JCFG, k, s, uw, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ju1, jcost1 = one_round(keys, jscen, jnp.zeros((n, 2, 3, 4, 3)))
    ju2, jcost2 = one_round(_advance(_advance(keys)), jscen, ju1)
    eps = [[torch.as_tensor(np.array(e))] for e in _jax_normals(keys, 2, (3, 4, 3, 1, 32))]

    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    for rounds, ju, jcost in ((1, ju1, jcost1), (2, ju2, jcost2)):
        u, cost = scenario_sweep.sweep_scenarios_tiled(c, PARAMS, CFG, None, scen,
                                                       n_rounds=rounds, eps=eps, device=CPU)
        assert u.shape == (n, 2, 3, 4, 3) and cost.shape == (n, 2)
        assert_close(u, ju, **TOL)
        assert_close(cost, jcost, **TOL)


def test_tiled_sweep_matches_reference_with_same_noise():
    _check_tiled_sweep_matches_reference()


def _check_generate_scenarios():
    """The reference test's checks (tests/test_scenario_sweep.py:32-52) on
    the port's own draws."""
    gen = torch.Generator()
    gen.manual_seed(7)
    scen = scenario_sweep.generate_scenarios(gen, 4, ARENA, F64, device=CPU)
    assert scen.scene.center.shape == (4, 10, 3)
    assert scen.robots.base_pos.shape == (4, 2, 3)
    assert scen.flag_pos.shape == (4, 3)
    assert torch.all(scen.with_flag[:, 0] ^ scen.with_flag[:, 1])
    assert torch.all(scen.robots.base_pos[:, 0, 0] < 0)
    assert torch.all(scen.robots.base_pos[:, 1, 0] > 0)
    assert torch.all(scen.robots.base_pos[..., :2].abs() < 2.5)
    assert not torch.allclose(scen.scene.center[0], scen.scene.center[1])
    # the role is drawn per scenario: both roles occur over 64 scenarios
    many = scenario_sweep.generate_scenarios(gen, 64, ARENA, F64, device=CPU)
    assert 0 < int(many.with_flag[:, 0].sum()) < 64
    # robots stand on a cube under their footprint, else on the ground
    z = many.robots.base_pos[..., 2]
    h = scenario_sweep.spawn_height(many.scene, many.robots.base_pos[..., :2])
    assert torch.equal(z, scenario_sweep.STAND_HEIGHT + h)
    assert bool((h == 0).any()) and bool((h > 0.05).any())


def _score(c, scen, u, s):
    """Both robots' total cost of the plans u (S, 2, H, 4, 3) in scenario s,
    re-scored through the deterministic rollouts (rollout_tasks)."""
    ts = traversal_cuda._scene_tl(traversal_cuda.pack_boxes(
        type(scen.scene)(*(x[s] for x in scen.scene)))[None])
    states = [B.tl_from_state(type(scen.robots)(*(x[s:s + 1, i] for x in scen.robots)))
              for i in (0, 1)]
    total = 0.0
    for r in (0, 1):
        opp = rollout_tasks.rollout_plan(c, PARAMS, states[1 - r], u[s, 1 - r], ts)
        cc, _ = rollout_tasks.rollout_chase(c, PARAMS, states[r], u[s, r][..., None, None], ts,
                                            opp, scen.flag_pos[s], scen.with_flag[s, r])
        total += float(cc[0, 0])
    return total


def _check_oracle_equals_tiled_and_improves():
    gen = torch.Generator()
    gen.manual_seed(3)
    scen = scenario_sweep.generate_scenarios(gen, 2, ARENA, F64, device=CPU)
    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    eps = scenario_sweep.draw_noise(gen, CFG, 2, 2, F64, CPU)
    u, cost = scenario_sweep.sweep_scenarios_tiled(c, PARAMS, CFG, None, scen, n_rounds=2,
                                                   eps=eps, device=CPU)
    u_o, cost_o = scenario_sweep.sweep_scenarios(c, PARAMS, CFG, None, scen, n_rounds=2, eps=eps,
                                                 device=CPU)
    assert_close(u_o, u, rtol=1e-9, atol=1e-9)
    assert_close(cost_o, cost, rtol=1e-9, atol=1e-9)
    assert torch.isfinite(cost).all()
    # one generator seed gives both forms the same noise
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    u_g, _ = scenario_sweep.sweep_scenarios_tiled(c, PARAMS, CFG, g1, scen, device=CPU)
    u_go, _ = scenario_sweep.sweep_scenarios(c, PARAMS, CFG, g2, scen, device=CPU)
    assert_close(u_go, u_g, rtol=1e-9, atol=1e-9)
    # the solved plans beat the zero warm start they improved on (the
    # reference test's headroom: MPPI's weighted mean is not guaranteed to)
    zeros = torch.zeros_like(u)
    for s in range(2):
        z = _score(c, scen, zeros, s)
        assert _score(c, scen, u, s) < z + 0.1 * abs(z) + 0.05


def _check_blown_up_candidates_get_no_weight():
    """A candidate whose cost is not finite gets softmax weight 0 in an MPPI
    update (mppi_tl.finite_costs), here one NaN and one inf among 32."""
    gen = torch.Generator()
    gen.manual_seed(1)
    eps = [torch.randn((3, 4, 3, 1, 32), generator=gen, dtype=F64)]
    cost = torch.rand((1, 32), generator=gen, dtype=F64)
    bad = cost.clone()
    bad[0, 3], bad[0, 7] = float("nan"), float("inf")
    dropped = cost.clone()
    dropped[0, 3] = dropped[0, 7] = 1e6  # weight exp(-2e7): exactly 0
    u0 = torch.zeros((3, 4, 3), dtype=F64)
    u_bad, d_bad = mppi_tl.mppi_update(CFG, None, u0, lambda u: bad, eps=eps)
    u_ref, d_ref = mppi_tl.mppi_update(CFG, None, u0, lambda u: dropped, eps=eps)
    assert_close(u_bad, u_ref, rtol=1e-12, atol=1e-12)
    assert_close(d_bad["best_cost"], d_ref["best_cost"], rtol=0, atol=0)
    assert_close(d_bad["weighted_cost"], d_ref["weighted_cost"], rtol=1e-12, atol=1e-12)


def _check_refusals():
    gen = torch.Generator()
    scen = scenario_sweep.generate_scenarios(gen, 2, ARENA, F64, device=CPU)
    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    # 12 candidates per scenario: not a multiple of K4's 8-candidate block
    with pytest.raises(ValueError, match="multiple of 8"):
        scenario_sweep.sweep_scenarios_tiled(c, PARAMS, CFG._replace(population=12), gen, scen,
                                             device=CPU)
    with pytest.raises(ValueError, match="sweep device"):
        scenario_sweep.sweep_scenarios_tiled(c, PARAMS, CFG, gen, scen, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            scenario_sweep.generate_scenarios(gen, 2, ARENA)


def test_port_sweep_oracle_generation_and_refusals():
    _check_generate_scenarios()
    _check_oracle_equals_tiled_and_improves()
    _check_blown_up_candidates_get_no_weight()
    _check_refusals()

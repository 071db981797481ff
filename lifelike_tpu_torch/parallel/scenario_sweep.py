"""SEPMC scenario sweep, on one device or sharded over ranks.

Port of lifelike_tpu.parallel.scenario_sweep: a
batch of S independent Chase-Tag scenarios — a randomized V4 arena per
scenario, two robots facing off from opposite halves, a flag and the chaser
role — and, for every scenario, alternating-best-response rounds of the
chase solve (solver.mpc_tasks.make_chase_solver's math).

`sweep_scenarios_tiled` is the main path: the scenarios are K3 / K4's
scenario blocks. Each scenario's population fills (Bs, L) candidate rows;
the S scenarios stack along the row axis (row r belongs to scenario r // Bs),
each block with its own box table, start state, opponent path, flag and
role. One round (both robots, one MPPI iteration) is two launches of
ops.traversal_cuda.rollout_plan_fused (K3, all S opponent plans at once)
and two of rollout_chase_fused (K4, all S x population candidates at once),
plus one batched softmax and weighted mean per robot. `sweep_scenarios` is
its oracle: the same solves one scenario at a time, one scenario per
launch. On CPU tensors both run the kernels' plain versions.
`sharded_scenario_sweep` shards the scenarios over the ranks of a
parallel.mesh.Mesh, each rank running the tiled sweep on its S / W
scenario blocks with normals drawn per GLOBAL scenario index
(`scenario_noise`), so its results do not depend on the world size.

Two deliberate differences from the reference. A robot stands on whatever
cube lies under its spawn footprint (`spawn_height`, the remedy
envs.chase_tag's reset applies at its spawn point): the reference stands
every robot at 0.33 m, inside any cube there, where the compliant box
contact ejects it and its rollouts blow up to non-finite costs, which the
softmax spreads over the whole scenario (a candidate that still blows up
gets weight 0 in the update, as in every port MPPI update). And there is no
`fused` switch: the reference drops its
Pallas kernels below a population of 1024 (a TPU block-shape limit) for an
XLA path; K4 takes any population that is a multiple of 8 candidates per
scenario, and a population it cannot take is refused (ValueError).
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.ops import traversal_cuda
from lifelike_tpu_torch.parallel import distributed as D
from lifelike_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_rows
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.scene import arena_gen
from lifelike_tpu_torch.scene.boxes import BoxScene, heightmap_at
from lifelike_tpu_torch.solver import mppi_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig

STAND_Q = (-0.028, -0.779, 1.687) * 4
STAND_HEIGHT = 0.33  # base height of the standing pose above its support
# Spawn footprint: a 3 x 3 grid over +-0.3 m x +-0.2 m about the base (the
# robots face +-x), covering the feet and wheels of the standing pose; no
# cube (footprint >= 0.5 m) fits between its points.
_FOOTPRINT = tuple((dx, dy) for dx in (-0.3, 0.0, 0.3) for dy in (-0.2, 0.0, 0.2))


class ScenarioBatch(NamedTuple):
    """A batch of S independent Chase-Tag scenarios (leading axis S).

    scene:     BoxScene with tensors (S, N, 3) / (S, N) / (S, 3)
    robots:    RobotState with leading (S, 2): agent axis after scenario
    flag_pos:  (S, 3)
    with_flag: (S, 2) bool, True = that robot is the chaser this round
    """

    scene: BoxScene
    robots: RobotState
    flag_pos: torch.Tensor
    with_flag: torch.Tensor


def _uniform(gen, shape, lo, hi, dtype):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u


def draw(generator, n, cfg: arena_gen.ArenaConfig = arena_gen.ArenaConfig(rand_cube=True),
         dtype=torch.float32) -> dict:
    """The random numbers of n scenarios, on the generator's device: each
    arena's draws (arena_gen.draw) stacked on a leading axis n, robot 0's x
    in [-2, -1], robot 1's x in [1, 2], both robots' y in [-1.5, 1.5]
    (n, 2), the flag's x, y in [-2, 2] (n, 2) and whether robot 0 is the
    chaser (n,) bool."""
    g = generator
    arenas = [arena_gen.draw(g, cfg, dtype) for _ in range(n)]
    out = {"arena": {k: torch.stack([a[k] for a in arenas]) for k in arenas[0]}}
    out["x0"] = _uniform(g, (n,), -2.0, -1.0, dtype)
    out["x1"] = _uniform(g, (n,), 1.0, 2.0, dtype)
    out["ys"] = _uniform(g, (n, 2), -1.5, 1.5, dtype)
    out["flag_xy"] = _uniform(g, (n, 2), -2.0, 2.0, dtype)
    out["chaser0"] = torch.rand((n,), generator=g, device=g.device) < 0.5
    return out


def spawn_height(scene: BoxScene, xy):
    """Height of the highest box top under each spawn footprint: scene with
    leading (S,), xy (S, R, 2) base positions -> (S, R)."""
    fp = torch.tensor(_FOOTPRINT, dtype=xy.dtype, device=xy.device)
    pts = (xy[..., None, :] + fp).reshape(xy.shape[0], -1, 2)  # (S, R * 9, 2)
    return heightmap_at(scene, pts).reshape(xy.shape[:-1] + (len(_FOOTPRINT),)).amax(-1)


def assemble(cfg: arena_gen.ArenaConfig, draws: dict, dtype=torch.float32,
             device="cpu") -> ScenarioBatch:
    """The scenario batch from its random numbers (see `draw`): robot 0
    faces +x, robot 1 faces -x (yaw pi), both standing STAND_HEIGHT above the
    highest cube under their footprint (spawn_height; the ground where none
    is); the flag at 0.25 m."""
    dev = torch.device(device)
    d = {k: v.to(dev) for k, v in draws.items() if k != "arena"}
    n = d["x0"].shape[0]
    scenes = [arena_gen.assemble(cfg, {k: v[s] for k, v in draws["arena"].items()}, dtype, dev)
              for s in range(n)]
    scene = BoxScene(*(torch.stack(leaf) for leaf in zip(*scenes)))
    x0, x1, ys = (d[k].to(dtype) for k in ("x0", "x1", "ys"))
    xy = torch.stack([torch.stack([x0, ys[:, 0]], dim=-1),
                      torch.stack([x1, ys[:, 1]], dim=-1)], dim=1)  # (n, 2, 2)
    z = STAND_HEIGHT + spawn_height(scene, xy)
    base_pos = torch.cat([xy, z[..., None]], dim=-1)  # (n, 2, 3)
    orn = torch.tensor([[0, 0, 0, 1], [0, 0, 1, 0]], dtype=dtype, device=dev)
    zeros = torch.zeros((n, 2, 3), dtype=dtype, device=dev)
    robots = RobotState(
        base_pos=base_pos,
        base_orn=orn.expand(n, 2, 4).clone(),
        base_lin_vel=zeros,
        base_ang_vel=zeros.clone(),
        joint_pos=torch.tensor(STAND_Q, dtype=dtype, device=dev).expand(n, 2, 12).clone(),
        joint_vel=torch.zeros((n, 2, 12), dtype=dtype, device=dev),
    )
    flag = torch.cat([d["flag_xy"].to(dtype), torch.full((n, 1), 0.25, dtype=dtype, device=dev)],
                     dim=-1)
    chaser0 = d["chaser0"]
    return ScenarioBatch(scene, robots, flag, torch.stack([chaser0, ~chaser0], dim=1))


def generate_scenarios(generator, n: int,
                       arena_cfg: arena_gen.ArenaConfig = arena_gen.ArenaConfig(rand_cube=True),
                       dtype=torch.float32, device="cuda") -> ScenarioBatch:
    """n randomized scenarios on `device` (the generator must live there):
    a V4 arena per scenario, the robots facing off from opposite halves, the
    flag uniform in the central region and the chaser role drawn per
    scenario (reference chase_tag reset: with_flag = randint(0, 2)). The
    distributions are the reference's, the numbers not."""
    dev = _device.resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    return assemble(arena_cfg, draw(generator, n, arena_cfg, dtype), dtype, dev)


def _layout(cfg: MPPIConfig):
    """(Bs, L) candidate rows of one scenario's population: mppi_tl's
    (K / 128, 128) when 128 divides K, else (1, K)."""
    lanes = 128 if cfg.population % 128 == 0 else cfg.population
    return cfg.population // lanes, lanes


def draw_noise(generator, cfg: MPPIConfig, n_scen, n_rounds, dtype, device):
    """Raw standard normals of a sweep, in the order the sweep uses them:
    [round 0 robot 0, round 0 robot 1, round 1 robot 0, ...], each a list
    of cfg.iterations tensors (H, 4, 3, S * Bs, L) (row r of scenario
    r // Bs)."""
    Bs, L = _layout(cfg)
    shape = (cfg.horizon, 4, 3, n_scen * Bs, L)
    return [[torch.randn(shape, generator=generator, dtype=dtype, device=device)
             for _ in range(cfg.iterations)] for _ in range(2 * n_rounds)]


def _scenario_tables(scen: ScenarioBatch, horizon):
    """K3 / K4's per-scenario tables: box tables (S, N, 8), each robot's
    constant reference rows (S, H, 64) at its start joints (the raw-delta
    nominal q0 + u), flag x, y (S, 2) and each robot's role (S,)."""
    sc, dtype = scen.scene, scen.flag_pos.dtype
    act = sc.active.to(dtype)[..., None]
    boxes = torch.cat([sc.center, sc.half, act, torch.zeros_like(act)], dim=-1).contiguous()
    S = boxes.shape[0]
    refs, roles = [], []
    for i in (0, 1):
        r = sc.center.new_zeros((S, horizon, traversal_cuda._REF_WIDTH))
        r[:, :, :12] = scen.robots.joint_pos[:, i, None, :]
        refs.append(r)
        roles.append(scen.with_flag[:, i].to(dtype))
    return boxes, refs, scen.flag_pos[:, :2].contiguous(), roles


def _check_sweep(c, scen: ScenarioBatch, cfg: MPPIConfig, u_warm, device):
    dev = _device.resolve_device(device)
    for name, t in (("constants", c.joint_offset), ("scenarios", scen.flag_pos)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} on {t.device}, sweep device {dev}")
    S, dtype = scen.flag_pos.shape[0], scen.flag_pos.dtype
    if u_warm is None:
        u_warm = torch.zeros((S, 2, cfg.horizon, 4, 3), dtype=dtype, device=scen.flag_pos.device)
    return S, u_warm


def sweep_scenarios_tiled(c: B.TLConstants, params, cfg: MPPIConfig, generator,
                          scen: ScenarioBatch, u_warm=None, n_rounds: int = 1, eps=None,
                          device="cuda"):
    """Every scenario's alternating best response, n_rounds rounds, with the
    S scenarios as K3 / K4's scenario blocks (see the module docstring).

    u_warm: (S, 2, H, 4, 3) or None (zeros). eps: optional raw normals in
    draw_noise's layout, used instead of drawing from `generator` (pass the
    normals another implementation drew). A candidate whose cost is not
    finite gets weight 0 (mppi_tl.finite_costs). The population per
    scenario must be a multiple of K4's block (8 candidates) when S > 1
    (ValueError).
    Returns (u (S, 2, H, 4, 3), best_cost (S, 2)): each robot's plan after
    its last update and that update's lowest candidate cost."""
    S, u_warm = _check_sweep(c, scen, cfg, u_warm, device)
    Bs, L = _layout(cfg)
    H, dtype, dev = cfg.horizon, scen.flag_pos.dtype, scen.flag_pos.device
    traversal_cuda.launch_geometry(traversal_cuda.CHASE_KERNEL, S * Bs * L, S)
    boxes, refs, flag, roles = _scenario_tables(scen, H)
    states = [B.tl_from_state(RobotState(*(x[:, i] for x in scen.robots)))
              for i in (0, 1)]  # batch (S, 1)
    u = [u_warm[:, 0], u_warm[:, 1]]
    cost = [None, None]
    shape = (H, 4, 3, S * Bs, L)
    for rnd in range(n_rounds):
        for i in (0, 1):
            j = 1 - i
            opp = traversal_cuda.rollout_plan_fused(c, params, states[j], u[j], boxes, refs[j])
            opp = opp[..., 0].permute(2, 0, 1)[..., :2]  # (H, 3, S, 1) -> (S, H, 2)
            for it in range(cfg.iterations):
                noise = mppi_tl._smooth_noise_tl(
                    generator, shape, cfg.beta, dtype, dev,
                    eps=None if eps is None else eps[2 * rnd + i][it])
                u_cand = (u[i].permute(1, 2, 3, 0)[..., None, None]
                          + cfg.sigma * noise.view(H, 4, 3, S, Bs, L)).reshape(shape).contiguous()
                total = traversal_cuda.rollout_chase_fused(
                    c, params, states[i], u_cand, boxes, refs[i], opp, flag, roles[i],
                    gait_weight=0.0)  # (S * Bs, L)
                cg = mppi_tl.finite_costs(total).reshape(S, Bs * L)
                c_min = torch.amin(cg, dim=1, keepdim=True)
                w = torch.softmax(-(cg - c_min) / cfg.temperature, dim=1)
                u[i] = torch.einsum("hjksp,sp->shjk", u_cand.view(H, 4, 3, S, Bs * L), w)
                cost[i] = c_min[:, 0]
    return torch.stack(u, dim=1), torch.stack(cost, dim=1)


def sweep_scenarios(c: B.TLConstants, params, cfg: MPPIConfig, generator, scen: ScenarioBatch,
                    u_warm=None, n_rounds: int = 1, eps=None, device="cuda"):
    """The oracle of sweep_scenarios_tiled: each scenario solved on its own
    (solver.mppi_tl.mppi_update per robot and round, one scenario per K3 /
    K4 launch), from the same normals (draw_noise's, drawn first when eps is
    None, so one generator seed gives both forms the same noise). Same
    arguments and returns as sweep_scenarios_tiled."""
    S, u_warm = _check_sweep(c, scen, cfg, u_warm, device)
    Bs, _ = _layout(cfg)
    dtype, dev = scen.flag_pos.dtype, scen.flag_pos.device
    if eps is None:
        eps = draw_noise(generator, cfg, S, n_rounds, dtype, dev)
    boxes, refs, flag, roles = _scenario_tables(scen, cfg.horizon)
    u_out, cost_out = [], []
    for s in range(S):
        states = [B.tl_from_state(RobotState(*(x[s:s + 1, i] for x in scen.robots)))
                  for i in (0, 1)]  # batch (1, 1)
        u = [u_warm[s, 0], u_warm[s, 1]]
        cost = [None, None]
        for rnd in range(n_rounds):
            for i in (0, 1):
                j = 1 - i
                opp = traversal_cuda.rollout_plan_fused(c, params, states[j], u[j], boxes[s],
                                                        refs[j][s])

                def score(u_cand, i=i, opp=opp):
                    return traversal_cuda.rollout_chase_fused(
                        c, params, states[i], u_cand, boxes[s], refs[i][s], opp, flag[s],
                        roles[i][s], gait_weight=0.0)

                rows = slice(s * Bs, (s + 1) * Bs)
                u[i], diag = mppi_tl.mppi_update(
                    cfg, None, u[i], score, eps=[e[..., rows, :] for e in eps[2 * rnd + i]])
                cost[i] = diag["best_cost"]
        u_out.append(torch.stack(u))
        cost_out.append(torch.stack(cost))
    return torch.stack(u_out), torch.stack(cost_out)


def scenario_noise(seed: int, cfg: MPPIConfig, scenarios, n_rounds: int, dtype, device):
    """Raw normals of the scenarios with the GLOBAL indices `scenarios`, in
    draw_noise's layout (their rows in the order given): scenario s's own
    from a generator seeded by distributed.rank_seed(seed, s), drawn in
    draw_noise's order, so a scenario's normals do not depend on which
    rank sweeps it."""
    Bs, L = _layout(cfg)
    per = []
    for s in scenarios:
        g = torch.Generator(device=device).manual_seed(D.rank_seed(seed, s))
        per.append(draw_noise(g, cfg, 1, n_rounds, dtype, device))
    return [[torch.cat([p[u][it] for p in per], dim=3) for it in range(cfg.iterations)]
            for u in range(2 * n_rounds)]


def sharded_scenario_sweep(mesh: Mesh, c: B.TLConstants, params, cfg: MPPIConfig, seed,
                           scen: ScenarioBatch, u_warm=None, n_rounds: int = 1, eps=None,
                           device="cuda"):
    """The sweep with the scenario axis sharded over the ranks of `mesh`:
    each rank runs sweep_scenarios_tiled (K3 / K4 over its S / W scenario
    blocks) on its slice of the global batch `scen` (the same on every
    rank) and keeps its scenarios' plans and costs; the summary is reduced.

    The normals are keyed by the global scenario index: scenario_noise(seed,
    ...) when eps is None, else eps in draw_noise's layout for all S
    scenarios (each rank takes its rows). S must divide over the ranks
    (ValueError). Returns (u (S / W, 2, H, 4, 3), best_cost (S / W, 2),
    {mean_cost, min_cost} over all S scenarios, the same on every rank)."""
    S = scen.flag_pos.shape[0]
    rows = shard_rows(mesh, S)
    local = shard_batch(mesh, scen)
    if u_warm is not None:
        u_warm = shard_batch(mesh, u_warm)
    dtype, dev = scen.flag_pos.dtype, scen.flag_pos.device
    Bs, _ = _layout(cfg)
    if eps is None:
        eps = scenario_noise(seed, cfg, range(rows.start, rows.stop), n_rounds, dtype, dev)
    else:
        cut = slice(rows.start * Bs, rows.stop * Bs)
        eps = [[e[..., cut, :] for e in upd] for upd in eps]
    u, cost = sweep_scenarios_tiled(c, params, cfg, None, local, u_warm, n_rounds, eps=eps,
                                    device=device)
    mean_c = D.all_sum(cost.sum().reshape(1), mesh)[0] / cost.new_tensor(2.0 * S)
    min_c = D.all_min(cost.min().reshape(1), mesh)[0]
    return u, cost, {"mean_cost": mean_c, "min_cost": min_c}

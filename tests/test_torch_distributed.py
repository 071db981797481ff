"""The port's multi-process layer (lifelike_tpu_torch/parallel/{mesh,
distributed,sharded_solve}.py, scenario_sweep.sharded_scenario_sweep) on
the CPU.

The port's ranks are two gloo processes (tests/torch_dist_worker.py,
launched as tools/launch_multihost launches them), importing torch and the
port only. The sharded MPPI solve is held to JAX's on a 2-device mesh (the
virtual CPU devices of tests/conftest.py; one jit), rank r fed the raw
normals JAX's device r draws (split(key, 2), then split(key_d,
iterations)), float64, at 1e-9: the global weighted mean is a sum of
per-rank partial sums, so 2 ranks agree with 1 to rounding. The sharded
hybrid is held to the port's single-process iLQR on each rank's seeds, the
sharded sweep to the port's single-process tiled sweep (which
tests/test_torch_scenario_sweep.py holds to JAX's). The replicated outputs
are bitwise equal across the ranks.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.parallel import mesh as jmesh
from lifelike_tpu.parallel import sharded_solve as jsharded
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.parallel import distributed, mesh as meshlib, scenario_sweep, sharded_solve
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import ilqr, mppi_tl, rollout_tl
from lifelike_tpu_torch.solver.mppi import MPPIConfig
from lifelike_tpu_torch.tools import launch_multihost

from tests.test_torch_scenario_sweep import ARENA
from tests.test_torch_scenario_sweep import PARAMS as SWEEP_PARAMS
from tests.torch_port_util import CPU, F64, assert_close, random_robot_state, run_ranks

JMODEL = j_build_max_model()
MODEL = build_max_model()
TOL = dict(rtol=1e-9, atol=1e-9)
PER_RANK = 16


def _check_no_fallback(monkeypatch):
    """initialize() raises where it cannot do what it is asked, before any
    process group exists; a world of one with no backend creates none."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.initialize(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                                   device="cuda")
    assert distributed.initialize(num_processes=1, process_id=0, device=CPU) is False
    assert distributed.global_mesh(CPU).world == 1 and not dist.is_initialized()

    def no_group(*a, **k):
        raise AssertionError("a process group was created")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(dist, "init_process_group", no_group)
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        distributed.initialize(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                               backend="nccl", device=CPU)
    # NCCL on two ranks of one card: refused on both ranks before the group
    # exists; on two hosts of one card each: the group is created
    monkeypatch.setattr(distributed, "_MESH", None)
    monkeypatch.setattr(distributed.socket, "gethostname",
                        lambda: threading.current_thread().name.split("/")[0])

    def nccl_ranks(hosts):
        port, raised, threads = launch_multihost.free_port(), {}, []

        def rank(r):
            try:
                distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                                       process_id=r, backend="nccl", timeout_s=30)
            except Exception as e:  # noqa: BLE001 - each rank's outcome is checked below
                raised[r] = e

        for r, host in enumerate(hosts):
            threads.append(threading.Thread(target=rank, args=(r,), name=f"{host}/{r}"))
            threads[-1].start()
        for t in threads:
            t.join()
        return raised

    raised = nccl_ranks(["host", "host"])
    assert sorted(raised) == [0, 1], raised
    assert all(isinstance(e, ValueError) and "--backend=gloo" in str(e)
               for e in raised.values()), raised
    raised = nccl_ranks(["host_a", "host_b"])
    assert sorted(raised) == [0, 1], raised
    assert all("a process group was created" in str(e) for e in raised.values()), raised


def _check_rank_generators():
    """Each rank's generator draws its own numbers on the CPU (whose
    generator keeps only a seed's low 32 bits), rank 0's those of the seed."""
    draws = [torch.randn(4, generator=distributed.rank_generator(
        5, meshlib.Mesh(None, r, 4, torch.device(CPU), None))) for r in range(4)]
    assert torch.equal(draws[0], torch.randn(4, generator=torch.Generator().manual_seed(5)))
    assert all(not torch.equal(draws[i], draws[j]) for i in range(4) for j in range(i))


def _solve_inputs():
    jcfg = jmppi.MPPIConfig(horizon=3, population=2 * PER_RANK, iterations=2, sigma=0.1)
    jp = jengine.PhysicsParams(substeps=2)
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    rng = np.random.default_rng(5)
    d = random_robot_state(rng, batch=(1,), vel_noise=0.05)
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    t0 = jnp.asarray(0.3, jnp.float64)
    jref = jrollout_tl.precompute_reference(JMODEL, jclips, jnp.asarray(0), t0, jcfg.horizon,
                                            jp.dt * jp.substeps)
    u0 = 0.05 * rng.standard_normal((jcfg.horizon, 4, 3))
    key = jax.random.PRNGKey(7)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    mesh2 = jmesh.make_mesh(2)
    want, jdiag = jax.jit(lambda k, u: jsharded.sharded_mppi_step(
        mesh2, jc, jp, jcfg, k, jtl, u, jref))(key, jnp.asarray(u0))
    # the normals JAX's device d draws: split(key, 2)[d], then one key per iteration
    shape = (jcfg.horizon, 4, 3, 1, PER_RANK)
    eps = [[torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
            for k in jax.random.split(kd, jcfg.iterations)] for kd in jax.random.split(key, 2)]
    inputs = dict(params=from_jax.physics_params(jp), cfg=MPPIConfig(*jcfg),
                  state=from_jax.tl_state(jtl, CPU, F64), u0=torch.as_tensor(u0),
                  ref=from_jax.ref_traj(jref, CPU, F64), eps=eps,
                  clips=from_jax.motion_clips(jclips, CPU), t0=torch.tensor(0.3, dtype=F64),
                  icfg=ilqr.ILQRConfig(iterations=1))
    return inputs, want, jdiag


def _expected_hybrid(inp, c):
    """sharded_hybrid_step's plan from the port's single-process pieces:
    stage 1 on the whole population (world of one), then ilqr_solve_batch
    on {the global plan, rank r's cheapest candidate} for each rank, the
    cheapest refined plan of all."""
    cfg, params, state, ref = inp["cfg"], inp["params"], inp["state"], inp["ref"]
    eps = [torch.cat([inp["eps"][0][0], inp["eps"][1][0]], dim=-1)]
    u_w, _ = sharded_solve.sharded_mppi_step(meshlib.make_mesh(CPU), c, params,
                                             cfg._replace(iterations=1), None, state, inp["u0"],
                                             ref, eps=eps)
    step_fn, cost_fn = ilqr.make_problem(MODEL, params, inp["clips"], 0, inp["t0"])
    robot = B.state_from_tl(state, batch_shape=())
    x0 = ilqr.flatten_state(robot).expand(2, ilqr.STATE_DIM)
    best = []
    for r in (0, 1):
        noise = cfg.sigma * mppi_tl._smooth_noise_tl(None, None, cfg.beta, F64, CPU,
                                                     eps=inp["eps"][r][0])
        u_cand = inp["u0"][..., None, None] + noise
        cost = rollout_tl.rollout_tracking(c, params, state, u_cand, ref)[0].reshape(-1)
        u_loc = u_cand.reshape(3, 4, 3, -1)[..., int(torch.argmin(cost))]
        us = torch.stack([u_w.reshape(3, 12), u_loc.reshape(3, 12)])
        u_ref, info = ilqr.ilqr_solve_batch(step_fn, cost_fn, x0, us, inp["icfg"])
        j = int(torch.argmin(info["final_cost"]))
        best.append((float(info["final_cost"][j]), u_ref[j], float(info["initial_cost"].min())))
    return min(best, key=lambda b: b[0])


def test_helpers_no_fallback_and_sharded_solves(tmp_path, monkeypatch):
    _check_no_fallback(monkeypatch)
    monkeypatch.undo()
    _check_rank_generators()
    inp, want, jdiag = _solve_inputs()
    outs = run_ranks("solve", tmp_path, inp)
    for o in outs:
        assert "differ across the 2 ranks" in o["fetch_refused"]
    # replicated outputs: bitwise equal on both ranks
    for k in ("u", "best_cost", "weighted_cost", "hybrid_u", "refined", "hybrid_best"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    u = outs[0]["u"]
    assert_close(u, want, **TOL)
    assert_close(outs[0]["best_cost"], jdiag["best_cost"], **TOL)
    assert_close(outs[0]["weighted_cost"], jdiag["weighted_cost"], **TOL)
    # a world of one: the port's mppi_step under the two ranks' normals side by side
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    eps1 = [torch.cat([a, b], dim=-1) for a, b in zip(*inp["eps"])]
    one, diag1 = sharded_solve.sharded_mppi_step(meshlib.make_mesh(CPU), c, inp["params"],
                                                 inp["cfg"], None, inp["state"], inp["u0"],
                                                 inp["ref"], eps=eps1)
    ref_u, ref_diag = mppi_tl.mppi_step(c, inp["params"], inp["cfg"], None, inp["state"],
                                        inp["u0"], inp["ref"], eps=eps1)
    assert_close(one, ref_u, rtol=1e-12, atol=1e-12)
    assert_close(diag1["weighted_cost"], ref_diag["weighted_cost"], rtol=1e-12, atol=1e-12)
    assert_close(one, u, rtol=1e-12, atol=1e-12)
    # the hybrid: held to the port's single-process iLQR on each rank's seeds
    cost, u_best, seed_min = _expected_hybrid(inp, c)
    assert_close(outs[0]["refined"], cost, **TOL)
    assert_close(outs[0]["hybrid_u"], u_best.reshape(3, 4, 3), **TOL)
    assert float(outs[0]["refined"]) <= seed_min + 1e-12


def test_sharded_scenario_sweep_matches_single_process(tmp_path):
    """sharded_scenario_sweep on 2 ranks, its normals drawn per global
    scenario index from a seed, against the single-process tiled sweep
    (held to JAX's by tests/test_torch_scenario_sweep.py) under the same
    normals: JAX's sharded sweep costs a ~20 s compile here."""
    n, seed = 4, 3
    cfg = MPPIConfig(horizon=3, population=16, iterations=1, sigma=0.15)
    scen = scenario_sweep.generate_scenarios(torch.Generator().manual_seed(7), n, ARENA, F64,
                                             device=CPU)
    outs = run_ranks("sweep", tmp_path, dict(params=SWEEP_PARAMS, cfg=cfg, scen=scen,
                                             seed=seed))
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    eps = scenario_sweep.scenario_noise(seed, cfg, range(n), 1, F64, CPU)
    assert not torch.equal(eps[0][0][..., 0, :], eps[0][0][..., 1, :])  # own normals per scenario
    u, cost = scenario_sweep.sweep_scenarios_tiled(c, SWEEP_PARAMS, cfg, None, scen, eps=eps,
                                                   device=CPU)
    assert_close(torch.cat([o["u"] for o in outs]), u, **TOL)
    assert_close(torch.cat([o["cost"] for o in outs]), cost, **TOL)
    summary = {"mean_cost": cost.mean(), "min_cost": cost.min()}
    for k in ("mean_cost", "min_cost"):
        assert torch.equal(outs[0]["summary"][k], outs[1]["summary"][k]), k
        assert_close(outs[0]["summary"][k], summary[k], **TOL)
    for o in outs:
        assert "does not divide over 2 ranks" in o["refused"]

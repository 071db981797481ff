"""The port's closed loop (MPPI controller on the envs.primitive plant) vs
the same loop built from the JAX package, plus the entry point's contract.

The loop is 5 control steps at population 128, H 3, substeps 2 in float64;
both controllers see the same noise (the port is fed the normals JAX draws
from its key). Rewards and executed targets are held at rtol = atol = 1e-8.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.envs import primitive as jprimitive
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import mppi_tl as jmppi_tl
from lifelike_tpu_torch.bin import profile_mpc, run_mpc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import primitive
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mppi, mppi_tl
from lifelike_tpu_torch.utils import trajectory

from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMODEL = j_build_max_model()
MODEL = build_max_model()


def _jax_env0(jclips, jcfg, t0):
    """Episode start on the clip at t0, every float field in float64."""
    f = jml.sample_frame(jclips, jnp.asarray(0), jnp.asarray(t0))
    robot = JRobotState(*(jnp.asarray(x, jnp.float64) for x in f))
    prop = jprimitive._proprioception(robot)
    return jprimitive.PrimitiveEnvState(
        robot=robot, t=jnp.asarray(t0, jnp.float64), clip_idx=jnp.asarray(0, jnp.int32),
        prop_hist=jnp.repeat(prop[None], jprimitive.STACK, axis=0),
        act_hist=jnp.zeros((jprimitive.STACK, jprimitive.ACTION_SIZE)),
        steps=jnp.asarray(0, jnp.int32), ep_ret=jnp.asarray(0.0),
    )


def test_closed_loop_matches_reference_with_same_noise():
    steps = 5
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jcfg = jprimitive.PrimitiveEnvConfig(params=jengine.PhysicsParams(substeps=2))
    mcfg = jmppi.MPPIConfig(horizon=3, population=128, iterations=1)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    jctrl = jmppi_tl.make_mpc_controller(JMODEL, jc, jcfg.params, jclips, mcfg)
    jstep = jax.jit(lambda e, a: jprimitive.step(JMODEL, jclips, jcfg, e, a))

    clips = from_jax.motion_clips(jclips, device=CPU)
    cfg = primitive.PrimitiveEnvConfig(params=from_jax.physics_params(jcfg.params))
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    ctrl = mppi_tl.make_mpc_controller(MODEL, c, cfg.params, clips, mppi.MPPIConfig(*mcfg),
                                       device=CPU)

    jenv = _jax_env0(jclips, jcfg, 0.5)
    env = from_jax.primitive_env_state(jenv, CPU, F64)
    ju = jnp.zeros((mcfg.horizon, 4, 3))
    u = torch.zeros((mcfg.horizon, 4, 3), dtype=F64)
    shape = (mcfg.horizon, 4, 3, 1, 128)
    base = jax.random.PRNGKey(3)
    launches = rollout_cuda.rollout_tracking_fused.launches
    for i in range(steps):
        k = jax.random.fold_in(base, i)
        jtgt, ju, _ = jctrl(k, jenv.robot, jenv.clip_idx, jenv.t, ju)
        jenv, _, jr, jdone, _ = jstep(jenv, jtgt - jenv.robot.joint_pos)
        eps = [torch.as_tensor(np.array(jax.random.normal(ki, shape, jnp.float64)))
               for ki in jax.random.split(k, mcfg.iterations)]
        tgt, u, _ = ctrl(None, env.robot, env.clip_idx, env.t, u, eps=eps)
        env, _, r, done, _ = primitive.step(MODEL, clips, cfg, env, tgt - env.robot.joint_pos)
        assert_close(tgt, jtgt, rtol=1e-8, atol=1e-8)
        assert_close(u, ju, rtol=1e-8, atol=1e-8)
        assert_close(r, jr, rtol=1e-8, atol=1e-8)
        assert bool(done) == bool(jdone)
    assert_tree_close(env.robot, jenv.robot, rtol=1e-8, atol=1e-8)
    assert float(r) > 0.5  # still tracking after 5 steps
    # on CPU tensors the wrapper runs the plain version: no kernel launch
    assert rollout_cuda.rollout_tracking_fused.launches == launches


def _check_run_mpc_cpu_reports_finite_rewards(tmp_path):
    """The PMC loop on the CPU, its --dump written with the reference's keys
    (utils.trajectory) and rendered by tools/plot_traj.py."""
    path = str(tmp_path / "traj.npz")
    out = run_mpc.main(["--task=pmc", "--device=cpu", "--population=128", "--horizon=3",
                        "--steps=2", "--seed=1", f"--dump={path}"])
    assert len(out["step_rewards"]) == 2 and np.isfinite(out["step_rewards"]).all()
    assert len(out["t_solve"]) == 2
    assert run_mpc._report("PMC", [1.0], [2], [0.1, 0.2]).startswith("PMC MPC eval: 1 episodes")
    assert out["dump"] == path
    data = trajectory.load(path)
    assert sorted(data) == sorted(list(JRobotState._fields) + ["reward", "solve_ms"])
    assert data["base_pos"].shape == (2, 3) and data["joint_pos"].shape == (2, 12)
    np.testing.assert_allclose(data["reward"], out["step_rewards"], rtol=1e-6)
    png = str(tmp_path / "traj.png")
    proc = subprocess.run([sys.executable, "tools/plot_traj.py", path, "-o", png], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.getsize(png) > 10_000


def _check_profile_mpc_cpu():
    # horizon 1 keeps the profiler's event tables small
    for task in ("pmc", "epmc"):
        out = profile_mpc.main([f"--task={task}", "--device=cpu", "--population=128",
                                "--horizon=1", "--steps=1"])
        assert out["solve_ms"] > 0 and "aten::" in out["host_top"]
        # device figures exist only on the card
        assert out["device_ms"] is None and out["idle_share"] is None


def _check_run_mpc_without_device_cpu_raises():
    for task in ("pmc", "epmc", "sepmc"):
        for hybrid in ([], ["--hybrid"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run_mpc.main([f"--task={task}", "--steps=1"] + hybrid)


def _check_port_imports_no_jax_and_no_reference_package():
    """In a fresh interpreter: import every module of the port and
    chip_smoke.py, and, where no card is present, run chip_smoke's main,
    which must fail without a result line."""
    code = r"""
import contextlib, importlib, importlib.util, io, pkgutil, sys
import lifelike_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lifelike_tpu_torch.__path__, "lifelike_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
if not torch.cuda.is_available():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = smoke.main()
    assert rc != 0 and '"ok": true' not in out.getvalue(), (rc, out.getvalue())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "absl", "flax", "optax", "lifelike_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
for m in ("envs.chase_tag", "scene.arena_gen", "scene.arena_fixed", "costs.chase",
          "ops.traversal_cuda", "solver.mpc_tasks", "physics.impulse", "ops.pgs_cuda",
          "envs.factory", "physics.oracle_traces", "solver.ilqr", "solver.riccati_cuda",
          "solver.hybrid", "parallel.scenario_sweep", "_native", "utils.obstacle",
          "utils.trajectory", "solver.mppi", "solver.rollout", "models.layers", "models.params",
          "models.pmc", "models.epmc", "models.sepmc", "compat.tleague_import",
          "learning.registry", "bin.run_eval", "entry", "learning.ppo", "learning.replay",
          "learning.learner", "learning.recurrent", "learning.freeze", "bin.run_learner",
          "robot.ik", "motion.bvh", "motion.retarget", "models.z_net", "learning.distill",
          "utils.profiling", "tools.make_eval", "tools.debug_traversal",
          "tools.distill_prior", "parallel.mesh", "parallel.distributed",
          "parallel.sharded_solve", "tools.launch_multihost", "tools.multihost_worker"):
    assert "lifelike_tpu_torch." + m in names, m
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _check_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lone.write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_entry_point_contract(tmp_path):
    """run_mpc (with --dump) and profile_mpc (both tasks) on the CPU; no
    JAX / absl / flax / optax / lifelike_tpu in the port's imports; chip_smoke.py alone in
    a directory fails; and, where no card is present, run_mpc without
    --device=cpu and chip_smoke.py in the repo fail."""
    _check_run_mpc_cpu_reports_finite_rewards(tmp_path)
    _check_profile_mpc_cpu()
    _check_port_imports_no_jax_and_no_reference_package()
    _check_chip_smoke_fails_alone(tmp_path)
    if not torch.cuda.is_available():
        _check_run_mpc_without_device_cpu_raises()

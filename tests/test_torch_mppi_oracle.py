"""The batch-leading MPPI oracle of lifelike_tpu_torch (solver.mppi,
solver.rollout.rollout_tracking on the readable engine) vs the JAX
reference, and the frozen-mass fidelity of the tile-layout engine.

mppi_step is deterministic given its noise: the port is fed the standard
normals JAX's mppi_step draws (jax.random.split(key, iterations)), at
population 16, H 3, substeps 2, 2 iterations, in float64; the improved
plan, its diagnostics and rollout_tracking's costs and final state are held
at rtol = atol = 1e-8. One jitted JAX function serves the whole check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import rollout as jrollout
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine, engine_tl
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mppi, rollout

from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close, random_robot_state

TOL = dict(rtol=1e-8, atol=1e-8)


def _check_mppi_step_and_rollout_match_reference():
    jmodel, model = j_build_max_model(), build_max_model()
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jparams = jengine.PhysicsParams(substeps=2)
    cfg = jmppi.MPPIConfig(horizon=3, population=16, iterations=2, sigma=0.1)
    rng = np.random.default_rng(5)
    s0 = random_robot_state(rng)
    jstate = JRobotState(*(jnp.asarray(s0[f]) for f in JRobotState._fields))
    u0 = 0.05 * rng.standard_normal((3, 12))
    ctrl = 0.1 * rng.standard_normal((4, 3, 12))
    t0 = jnp.asarray(0.5, jnp.float64)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def reference(key, state, u0, ctrl):
        u, diag = jmppi.mppi_step(jmodel, jparams, jclips, cfg, key, state, 0, t0, u0)
        st_k = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), state)
        roll = jrollout.rollout_tracking(jmodel, jparams, jclips, st_k, jnp.zeros(4, jnp.int32),
                                         jnp.broadcast_to(t0, (4,)), ctrl)
        eps = [jax.random.normal(k, (16, 3, 12), jnp.float64)
               for k in jax.random.split(key, cfg.iterations)]
        return u, diag, roll, eps

    ju, jdiag, (jtotal, jfinal, jcosts), jeps = reference(key, jstate, jnp.asarray(u0),
                                                          jnp.asarray(ctrl))

    clips = from_jax.motion_clips(jclips, device=CPU)
    params = from_jax.physics_params(jparams)
    state = from_jax.robot_state(jstate, CPU, F64)
    eps = [torch.as_tensor(np.array(e)) for e in jeps]
    ctl = mppi.make_mpc_controller(model, params, clips, mppi.MPPIConfig(*cfg), device=CPU)
    u_exec, u_next, diag = ctl(None, state, 0, torch.tensor(0.5, dtype=F64),
                               torch.as_tensor(u0), eps=eps)
    assert_close(u_exec, np.asarray(ju)[0], **TOL)
    assert_close(u_next, jmppi.shift_warm_start(ju), **TOL)
    for k in ("best_cost", "weighted_cost"):
        assert_close(diag[k], jdiag[k], **TOL)

    st_k = RobotState(*(x.expand((4,) + tuple(x.shape)) for x in state))
    total, final, costs = rollout.rollout_tracking(model, params, clips, st_k,
                                                   torch.zeros(4, dtype=torch.long),
                                                   torch.full((4,), 0.5, dtype=F64),
                                                   torch.as_tensor(ctrl))
    assert costs.shape == (4, 3) and final.base_pos.shape == (4, 3)
    assert_close(total, jtotal, **TOL)
    assert_close(costs, jcosts, **TOL)
    assert_tree_close(final, jfinal, **TOL)
    # the sampler draws from a generator when no normals are given
    gen = torch.Generator()
    gen.manual_seed(0)
    u_g, _, _ = ctl(gen, state, 0, 0.5, torch.as_tensor(u0))
    assert torch.isfinite(u_g).all() and u_g.dtype == F64


def test_batch_leading_mppi_oracle_matches_reference():
    _check_mppi_step_and_rollout_match_reference()


def test_mass_freeze_fidelity():
    """Twin of tests/test_batched_layout.py::test_mass_freeze_fidelity on
    the port's tile-layout engine: the frozen-mass path (mass_freeze =
    substeps) stays within the 1e-2 rad control-fidelity budget of the
    exact per-substep factorization over 10 control steps (0.2 s) from an
    in-envelope state (stand pose, walking-speed base motion)."""
    stand = np.asarray([-0.028, -0.779, 1.687] * 4)
    q0 = np.asarray([0.05, 0.02, 0.1, 0.99])
    q0 /= np.linalg.norm(q0)
    s = RobotState(*(torch.as_tensor(np.asarray(x, np.float64)) for x in (
        [[0.1, 0.0, 0.33], [0.0, 0.1, 0.30]],
        [q0, [0.0, 0.0, 0.0, 1.0]],
        [[0.8, 0.1, 0.0], [-0.3, 0.5, 0.1]],
        [[0.2, 0.1, 0.3], [0.0, -0.4, 0.2]],
        [stand, stand + 0.1],
        [np.full(12, 0.5), np.full(12, -1.0)])))
    tl = B.tl_from_state(s, batch2d=(1, 2))
    c = B.tl_constants(build_max_model(), dtype=F64, device=CPU)
    tgt = torch.as_tensor(stand).reshape(4, 3, 1, 1).expand(4, 3, 1, 2)
    p_exact = engine.PhysicsParams(substeps=5, mass_freeze=1)
    p_froz = engine.PhysicsParams(substeps=5, mass_freeze=5)
    se = sf = tl
    for _ in range(10):
        se = engine_tl.control_step(c, p_exact, se, tgt)
        sf = engine_tl.control_step(c, p_froz, sf, tgt)
    assert float((se.joint_pos - sf.joint_pos).abs().max()) < 1e-2
    assert float((se.base_pos - sf.base_pos).abs().max()) < 5e-3
    assert bool(torch.isfinite(sf.joint_vel).all())

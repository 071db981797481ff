"""lifelike_tpu_torch physics vs the JAX reference, float64.

The readable plant (physics.engine.control_step, the closed loop's plant)
and the tile-layout engine (physics.engine_tl.control_step, the plain
version of the CUDA kernel's physics) are held to the JAX functions of the
same name from perturbed standing states with live foot/wheel contact.
Tolerance: rtol = atol = 1e-9 (same float64 formulas; only the order of a
few sums differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import dynamics as jdyn
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import engine_tl as jengine_tl
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import dynamics, engine, engine_tl
from lifelike_tpu_torch.robot.model import build_max_model

from tests.torch_port_util import CPU, F64, STAND, assert_close, assert_tree_close, random_robot_state

JMODEL = j_build_max_model()
MODEL = build_max_model()
TOL = dict(rtol=1e-9, atol=1e-9)


def _pair(d):
    j = JRobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    return j, from_jax.robot_state(j, CPU, F64)


def _check_forward_kinematics_and_dynamics_terms():
    rng = np.random.default_rng(10)
    js, ps = _pair(random_robot_state(rng, batch=(3,)))

    @jax.jit
    def reference(js):
        jk = jdyn.forward_kinematics(JMODEL, js)
        return (jk, jdyn.mass_matrix_blocks(JMODEL, jk, js.base_pos, js.base_pos),
                jdyn.bias_forces(JMODEL, jk, js, js.base_pos))

    jk, (jMb, jF, jMl), jb = reference(js)
    pk = dynamics.forward_kinematics(MODEL, ps)
    assert_tree_close(pk, jk, **TOL)
    pMb, pF, pMl = dynamics.mass_matrix_blocks(MODEL, pk, ps.base_pos, ps.base_pos)
    for g, w in ((pMb, jMb), (pF, jF), (pMl, jMl)):
        assert_close(g, w, **TOL)
    pb = dynamics.bias_forces(MODEL, pk, ps, ps.base_pos)
    for g, w in zip(pb, jb):
        assert_close(g, w, **TOL)


def _check_engine_control_step_matches_reference():
    """The closed loop's plant: two control steps of 2 substeps each."""
    rng = np.random.default_rng(11)
    js, ps = _pair(random_robot_state(rng, batch=(4,)))
    tgt = STAND + 0.2 * rng.standard_normal((4, 12))
    jp = jengine.PhysicsParams(substeps=2, ext_force=np.array([1.0, -2.0, 0.5]))
    pp = from_jax.physics_params(jp)
    step = jax.jit(lambda s, u: jengine.control_step(JMODEL, jp, s, u))
    want = step(step(js, jnp.asarray(tgt)), jnp.asarray(tgt))
    got = ps
    for _ in range(2):
        got = engine.control_step(MODEL, pp, got, torch.as_tensor(tgt))
    assert_tree_close(got, want, **TOL)
    assert float(torch.min(got.base_pos[:, 2])) > 0.1  # still standing: contact held


def _check_engine_tl_control_step_matches_reference(mass_freeze):
    """The kernel's plain physics, exact (1) and frozen-mass (2) cadence."""
    rng = np.random.default_rng(12 + mass_freeze)
    d = random_robot_state(rng, batch=(8,))
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    pc = B.tl_constants(MODEL, dtype=F64, device=CPU)
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}),
                           batch2d=(2, 4))
    ptl = from_jax.tl_state(jtl, CPU, F64)
    tgt = (STAND + 0.2 * rng.standard_normal((8, 12))).T.reshape(4, 3, 2, 4)
    jp = jengine.PhysicsParams(substeps=2, mass_freeze=mass_freeze)
    pp = from_jax.physics_params(jp)
    want = jax.jit(lambda s, u: jengine_tl.control_step(jc, jp, s, u))(jtl, jnp.asarray(tgt))
    got = engine_tl.control_step(pc, pp, ptl, torch.as_tensor(tgt))
    assert_tree_close(got, want, **TOL)


def _check_engine_tl_agrees_with_readable_engine():
    """Port-internal: the two layouts are one engine (mass_freeze 1), at
    the layout tolerance of tests/test_batched_layout.py (2e-5: the two
    solvers regularize the 3x3 leg blocks differently)."""
    rng = np.random.default_rng(20)
    _, ps = _pair(random_robot_state(rng, batch=(4,)))
    tgt = torch.as_tensor(STAND + 0.2 * rng.standard_normal((4, 12)))
    pp = engine.PhysicsParams(substeps=3)
    pc = B.tl_constants(MODEL, dtype=F64, device=CPU)
    want = engine.control_step(MODEL, pp, ps, tgt)
    tl = engine_tl.control_step(
        pc, pp, B.tl_from_state(ps), B.tl_from_state(ps._replace(joint_pos=tgt)).joint_pos
    )
    assert_tree_close(B.state_from_tl(tl, batch_shape=(4,)), want, rtol=2e-5, atol=2e-5)


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_readable_engine_matches_reference():
    _check_forward_kinematics_and_dynamics_terms()
    _check_engine_control_step_matches_reference()
    _check_engine_tl_agrees_with_readable_engine()


def test_tile_engine_matches_reference():
    for mass_freeze in (1, 2):
        _check_engine_tl_control_step_matches_reference(mass_freeze)

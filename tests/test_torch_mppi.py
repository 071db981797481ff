"""MPPI of lifelike_tpu_torch vs the JAX reference.

mppi_step is deterministic given its noise: the port is fed the standard
normals that JAX's mppi_step draws from jax.random.split(key, iterations),
and the improved plan is held at 1e-9 (float64). The port's own sampler
(_smooth_noise_tl, a torch.Generator) is held to its statistics: AR(1)
coefficient beta and unit stationary variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import mppi_tl as jmppi_tl
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mppi, mppi_tl

from tests.torch_port_util import CPU, F64, assert_close, random_robot_state

JMODEL = j_build_max_model()
MODEL = build_max_model()


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_mppi_step_matches_reference_with_injected_noise():
    cfg = jmppi.MPPIConfig(horizon=3, population=128, iterations=2, sigma=0.1)
    jp = jengine.PhysicsParams(substeps=2)
    jc = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    rng = np.random.default_rng(5)
    d = random_robot_state(rng, batch=(1,), vel_noise=0.05)
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    jref = jrollout_tl.precompute_reference(JMODEL, jc, jnp.asarray(0), jnp.asarray(0.3),
                                            cfg.horizon, jp.dt * jp.substeps)
    u0 = 0.05 * rng.standard_normal((cfg.horizon, 4, 3))
    key = jax.random.PRNGKey(7)
    jcon = JB.tl_constants(JMODEL, dtype=jnp.float64)
    want, jdiag = jax.jit(lambda k, u: jmppi_tl.mppi_step(
        jcon, jp, cfg, k, jtl, u, jref))(key, jnp.asarray(u0))
    # the normals JAX drew: one (H, 4, 3, Bs, L) draw per iteration
    shape = (cfg.horizon, 4, 3, 1, 128)
    eps = [torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
           for k in jax.random.split(key, cfg.iterations)]

    pc = B.tl_constants(MODEL, dtype=F64, device=CPU)
    pp = from_jax.physics_params(jp)
    ptl = from_jax.tl_state(jtl, CPU, F64)
    pref = from_jax.ref_traj(jref, CPU, F64)
    pcfg = mppi.MPPIConfig(*cfg)
    got, diag = mppi_tl.mppi_step(pc, pp, pcfg, None, ptl, torch.as_tensor(u0), pref, eps=eps)
    assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert_close(diag["best_cost"], jdiag["best_cost"], rtol=1e-9, atol=1e-9)
    assert_close(diag["weighted_cost"], jdiag["weighted_cost"], rtol=1e-9, atol=1e-9)


def test_smooth_noise_statistics():
    """AR(1): lag-1 autocorrelation beta and unit stationary variance
    (after the zero start has decayed: beta^(2*16) < 1e-4)."""
    beta = 0.7
    gen = torch.Generator().manual_seed(0)
    x = mppi_tl._smooth_noise_tl(gen, (64, 4, 3, 16, 128), beta, F64, CPU)
    steady = x[16:]
    var = float(steady.var())
    rho = float((steady[1:] * steady[:-1]).mean() / steady.var())
    assert abs(var - 1.0) < 0.01, var
    assert abs(rho - beta) < 0.01, rho
    assert abs(float(steady.mean())) < 0.01
    # the first step carries only the innovation: variance 1 - beta^2
    assert abs(float(x[0].var()) - (1 - beta**2)) < 0.05
    # same generator seed -> same noise; injected normals reproduce it
    gen2 = torch.Generator().manual_seed(0)
    eps = torch.randn((64, 4, 3, 16, 128), generator=gen2, dtype=F64)
    again = mppi_tl._smooth_noise_tl(None, eps.shape, beta, F64, CPU, eps=eps)
    np.testing.assert_array_equal(again.numpy(), x.numpy())

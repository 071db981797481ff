"""The PMC candidate rollout (K1) of lifelike_tpu_torch vs the JAX reference.

On the CPU: the reference trajectory, the packed (H, 64) reference, and the
kernel's plain version solver.rollout_tl.rollout_tracking against
lifelike_tpu.solver.rollout_tl.rollout_tracking (the function the Pallas
kernel is pinned to in tests/test_rollout_pallas.py) — float64 at 1e-9 and
one float32 case at the Pallas kernel's own 2e-4. On a card (marker `cuda`,
skipped elsewhere): the CUDA kernel against that plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.ops import rollout_pallas
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import rollout_tl

from tests.torch_port_util import CPU, assert_close, assert_tree_close, random_robot_state

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, BS, L = 3, 1, 128  # population 128


def _clips():
    frames = jml.make_synthetic_clip(480)
    jc = jml.pack_clips([frames], frame_step=1.0 / 120.0)
    return jc, from_jax.motion_clips(jc, device=CPU)


@functools.lru_cache(maxsize=None)
def _jref(dtype, horizon, policy_dt):
    jc, _ = _clips()
    return jax.jit(
        lambda t0: jrollout_tl.precompute_reference(JMODEL, jc, jnp.asarray(0), t0,
                                                    horizon, policy_dt)
    )(jnp.asarray(0.2, getattr(jnp, dtype)))


def _setup(dtype, substeps=2, mass_freeze=1, seed=0, device=CPU, n_lanes=L, bs=BS,
           horizon=H):
    """Identical inputs for both packages (numpy seed): a perturbed standing
    state broadcast over the population, controls 0.05 * N(0, 1)."""
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jc, pc = _clips()
    d = random_robot_state(rng, batch=(1,), vel_noise=0.05)
    jstate = JB.tl_from_state(jax.tree.map(lambda x: jnp.asarray(x, jdt),
                                           JRobotState(**d)))
    u = (0.05 * rng.standard_normal((horizon, 4, 3, bs, n_lanes))).astype(dtype)
    jp = jengine.PhysicsParams(substeps=substeps, mass_freeze=mass_freeze)
    t0 = np.asarray(0.2, dtype)
    jref = _jref(dtype, horizon, jp.dt * jp.substeps)
    port = dict(
        c=B.tl_constants(MODEL, dtype=tdt, device=device),
        params=from_jax.physics_params(jp),
        state=from_jax.tl_state(jstate, device, tdt),
        controls=torch.as_tensor(u, device=device),
        ref=from_jax.ref_traj(jref, device, tdt),
    )
    # the reference's scan carries the population-wide state; the port
    # broadcasts the (1, 1) state itself
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, x.shape[:-2] + (bs, n_lanes)), jstate)
    ref = dict(c=JB.tl_constants(JMODEL, dtype=jdt), params=jp, state=jstate,
               controls=jnp.asarray(u), ref=jref)
    return port, ref, (pc, t0)


def _check_precompute_and_pack_reference(dtype):
    port, ref, (pc, t0) = _setup(dtype)
    got = rollout_tl.precompute_reference(MODEL, pc, 0, torch.as_tensor(t0), H,
                                          ref["params"].dt * ref["params"].substeps)
    # clip frames are float32 in both packages: the finite-difference
    # velocities are float32 arithmetic, which XLA's fused (jitted) reference
    # rounds differently from eager ops by an ulp
    assert_tree_close(got, ref["ref"], rtol=1e-6, atol=1e-6)
    packed = rollout_cuda.pack_reference(port["ref"])
    want = rollout_pallas.pack_reference(ref["ref"])
    assert packed.shape == (H, 64)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))


def _check_plain_rollout_matches_reference_f64(mass_freeze):
    port, ref, _ = _setup("float64", mass_freeze=mass_freeze)
    want, want_final = jax.jit(
        lambda s, u: jrollout_tl.rollout_tracking(ref["c"], ref["params"], s, u, ref["ref"])
    )(ref["state"], ref["controls"])
    got, got_final = rollout_tl.rollout_tracking(
        port["c"], port["params"], port["state"], port["controls"], port["ref"])
    assert got.shape == (BS, L)
    assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert_tree_close(got_final, want_final, rtol=1e-9, atol=1e-9)
    # the kernel wrapper on CPU tensors is exactly the plain version
    fused = rollout_cuda.rollout_tracking_fused(
        port["c"], port["params"], port["state"], port["controls"], port["ref"])
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


def _check_plain_rollout_matches_reference_f32():
    port, ref, _ = _setup("float32")
    want, _ = jax.jit(
        lambda s, u: jrollout_tl.rollout_tracking(ref["c"], ref["params"], s, u, ref["ref"])
    )(ref["state"], ref["controls"])
    got, _ = rollout_tl.rollout_tracking(
        port["c"], port["params"], port["state"], port["controls"], port["ref"])
    assert got.dtype == torch.float32
    assert_close(got, want, rtol=2e-4, atol=2e-4)


def _check_kernel_argument_packing():
    port, _, _ = _setup("float64")
    model = rollout_cuda.pack_model(port["c"])
    # ModelConst<T> of csrc/scalar_phys.cuh: 16 arrays + 4 scalars
    assert model.shape == (544,)
    assert float(model[-1]) == port["c"].total_mass
    hp = rollout_cuda.host_params(port["params"], rollout_tl.TrackingWeights(), H)
    assert hp.shape == (20,)
    np.testing.assert_allclose(hp[12:17].sum(), 1.0, rtol=1e-15)
    assert tuple(hp[17:]) == (2, 1, H)
    # every candidate starts from the solve's one state: a per-candidate
    # state is refused, not broadcast
    per_candidate = B.map_state(lambda x: x.expand(x.shape[:-2] + (BS, L)), port["state"])
    with pytest.raises(ValueError, match="batch"):
        rollout_cuda.rollout_tracking_fused(port["c"], port["params"], per_candidate,
                                            port["controls"], port["ref"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA rollout kernel has no CPU mode")
    return torch.device("cuda")


def _check_cuda_kernel_matches_plain(cuda_device, dtype, mass_freeze, tol):
    port, _, _ = _setup(dtype, mass_freeze=mass_freeze, device=cuda_device, bs=8)
    args = (port["c"], port["params"], port["state"], port["controls"], port["ref"])
    before = rollout_cuda.rollout_tracking_fused.launches
    got = rollout_cuda.rollout_tracking_fused(*args)
    torch.cuda.synchronize()
    assert rollout_cuda.rollout_tracking_fused.launches == before + 1
    want, _ = rollout_tl.rollout_tracking(*args)
    assert got.shape == (8, L) and bool(torch.isfinite(got).all())
    assert_close(got, want, rtol=tol, atol=tol)


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_reference_and_plain_rollout_match_reference():
    for dtype in ("float32", "float64"):
        _check_precompute_and_pack_reference(dtype)
    for mass_freeze in (1, 2):
        _check_plain_rollout_matches_reference_f64(mass_freeze)
    _check_plain_rollout_matches_reference_f32()
    _check_kernel_argument_packing()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    _check_cuda_kernel_matches_plain(cuda_device, "float32", 1, 2e-4)  # Pallas kernel's tolerance
    _check_cuda_kernel_matches_plain(cuda_device, "float64", 2, 1e-9)

"""The rollout kernels K1 (csrc/rollout_tracking.cu) and K2
(csrc/rollout_traversal.cu) against their plain versions, on the card.

Both kernels roll each candidate on a group of lanes of one warp
(csrc/scalar_phys.cuh substep_group). Gates are chip_smoke.py's phases 3-5.
K1 (plane contact): float32 2e-4 at H 3 (substeps 2, mass_freeze 1) over
250 candidates, so the last block is part-filled; float64 1e-6 at H 50
(substeps 10) at mass_freeze 10 and 1. K2 on a contact scene
(tests/torch_port_util.py contact_scene: feet, a wheel and the trunk proxy
touching boxes from the first substep, so the cross-lane sums of the
contact wrench and the trunk spheres' split over the lanes count): float32
2e-4 at H 3 for both reward types, gait weight 1 and 0, default and
crawl_gap weights; float64 1e-6 at H 3 over four scenario blocks (S 4)
with their own box tables, reference rows and targets; float64 1e-6 at H
50 (substeps 10, mass_freeze 10 with the gait prior, mass_freeze 1 with a
constant reference), gated over the values whose plain result does not
itself move beyond 1e-6 when the start shifts by 1e-10 m (contact chaos;
the count is asserted to leave most values gated). The wrapper refuses a
scenario block that is not a multiple of K2's candidates per block.

Marker `cuda`: skipped where there is no card. The module imports no JAX,
so the check also runs without pytest: `python3 -c "import torch;
from tests.test_torch_rollout_kernels import check_rollout_kernels as c;
c(torch.device('cuda'))"` from the repo root.
"""
import numpy as np
import pytest
import torch

from lifelike_tpu_torch.costs.traversal import TraversalWeights
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.ops import rollout_cuda, traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import rollout_tl

from tests.torch_port_util import contact_scene, screened_gate, shifted_start, stand_state

MODEL = build_max_model()


def _setup(dtype, device, horizon, substeps, mass_freeze, seed, pos=(0.0, 0.0, 0.36)):
    """Plant constants and parameters, a perturbed standing start (TLState,
    batch (1, 1)) with its contact table (K, 8) and the synthetic clip's
    reference from t = 0.2 s."""
    rng = np.random.default_rng(seed)
    st = stand_state(pos=pos, vel=(0.5, 0.0, 0.0))
    table = contact_scene(MODEL, st)
    st["joint_pos"] = st["joint_pos"] + 0.01 * rng.standard_normal(12)
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    state = RobotState(*(torch.as_tensor(np.asarray(st[f])[None], dtype=dtype, device=device)
                         for f in RobotState._fields))
    rows = np.concatenate([table["center"], table["half"], table["active"][:, None],
                           np.zeros((len(table["active"]), 1))], axis=1)
    boxes = torch.as_tensor(rows, dtype=dtype, device=device)
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps,
                                  mass_freeze=mass_freeze)
    c = B.tl_constants(MODEL, dtype=dtype, device=torch.device(device))
    clips = motion_lib.pack_clips(
        [motion_lib.make_synthetic_clip(int(120 * (horizon / 50.0 + 3)))],
        frame_step=1.0 / 120.0, device=device)
    ref = rollout_tl.precompute_reference(MODEL, clips, 0,
                                          torch.tensor(0.2, dtype=dtype, device=device), horizon,
                                          params.dt * substeps)
    return c, params, B.tl_from_state(state), state, boxes, ref, table["target_pos"], rng


def _controls(rng, horizon, shape, sigma, dtype, device):
    return torch.as_tensor(sigma * rng.standard_normal((horizon, 4, 3) + shape), dtype=dtype,
                           device=device)


def _check_tracking(device, dtype, horizon, substeps, mass_freeze, tol, shape):
    c, params, tl, _, _, ref, _, rng = _setup(dtype, device, horizon, substeps, mass_freeze, 1,
                                              pos=(0.0, 0.0, 0.33))
    u = _controls(rng, horizon, shape, 0.05, dtype, device)
    before = rollout_cuda.rollout_tracking_fused.launches
    got = rollout_cuda.rollout_tracking_fused(c, params, tl, u, ref)
    torch.cuda.synchronize()
    assert rollout_cuda.rollout_tracking_fused.launches == before + 1
    assert tuple(got.shape) == shape
    want, _ = rollout_tl.rollout_tracking(c, params, tl, u, ref)
    screened_gate(got, want, None, tol)


def _check_traversal(device, dtype, horizon, substeps, mass_freeze, tol, reward_type,
                     gait_weight, crawl=False, n_scen=1, screen=False, pop=256):
    c, params, tl, state, boxes, ref, target, rng = _setup(dtype, device, horizon, substeps,
                                                           mass_freeze, 2)
    if gait_weight == 0.0:  # the raw-delta rollout: controls on the current joints
        ref = traversal_cuda.constant_reference(state.joint_pos[0], horizon)
    u = _controls(rng, horizon, (pop // 64, 64), 0.1, dtype, device)
    target = torch.as_tensor(target, dtype=dtype, device=device)
    spd = 1.5
    if n_scen > 1:
        k = torch.arange(n_scen, dtype=dtype, device=device)
        boxes = boxes[None].repeat(n_scen, 1, 1)
        boxes[:, :, 0] += 0.002 * k[:, None]
        ref = torch.stack([rollout_cuda.pack_reference(ref).to(dtype) * (1.0 + 0.01 * i)
                           for i in range(n_scen)])
        target = target[None] + k[:, None]
        spd = 1.0 + 0.25 * k
    w = (TraversalWeights(height_min=0.08, pose=0.0, crawl_gap=0.18, ceiling=0.3) if crawl
         else TraversalWeights())
    args = (boxes, ref, target, spd, reward_type, 1000, w, gait_weight)
    before = traversal_cuda.rollout_traversal_fused.launches
    got = traversal_cuda.rollout_traversal_fused(c, params, tl, u, *args)
    torch.cuda.synchronize()
    assert traversal_cuda.rollout_traversal_fused.launches == before + 1
    assert tuple(got.shape) == (pop // 64, 64)
    want = traversal_cuda.rollout_traversal_plain(c, params, tl, u, *args)
    shifted = (traversal_cuda.rollout_traversal_plain(c, params, shifted_start(tl), u, *args)
               if screen else None)
    return screened_gate(got, want, shifted, tol), got.numel()


def check_rollout_kernels(device):
    f32, f64 = torch.float32, torch.float64
    _check_tracking(device, f32, 3, 2, 1, 2e-4, (2, 125))  # a ragged last block
    for mass_freeze in (10, 1):
        _check_tracking(device, f64, 50, 10, mass_freeze, 1e-6, (4, 64))
    for reward_type, gw, crawl in (("joystick", 1.0, False), ("average_speed", 0.0, False),
                                   ("joystick", 0.0, True), ("average_speed", 1.0, True)):
        _check_traversal(device, f32, 3, 2, 1, 2e-4, reward_type, gw, crawl)
    _check_traversal(device, f64, 3, 2, 1, 1e-6, "average_speed", 1.0, n_scen=4)
    for mass_freeze, reward_type, gw in ((10, "joystick", 1.0), (1, "average_speed", 0.0)):
        gated, total = _check_traversal(device, f64, 50, 10, mass_freeze, 1e-6, reward_type, gw,
                                        screen=True)
        assert gated >= total // 2, (gated, total)
    # a scenario block must hold whole blocks of candidates
    per_block = traversal_cuda.launch_geometry(traversal_cuda.KERNEL, 64).per_block
    c, params, tl, _, boxes, ref, target, _ = _setup(f32, device, 3, 2, 1, 2)
    u = torch.zeros((3, 4, 3, 4, per_block // 2), dtype=f32, device=device)
    with pytest.raises(ValueError, match=f"multiple of {per_block}"):
        traversal_cuda.rollout_traversal_fused(c, params, tl, u, boxes[None].repeat(4, 1, 1), ref,
                                               target, 1.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA rollout kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rollout_kernels_match_plain(cuda_device):
    check_rollout_kernels(cuda_device)

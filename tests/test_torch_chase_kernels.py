"""The SEPMC chase kernels K3 (csrc/rollout_plan.cu) and K4
(csrc/rollout_chase.cu) against their plain versions, on the card.

Both kernels roll a plan or candidate on a group of lanes of one warp
(csrc/scalar_phys.cuh substep_group: K4 four lanes, one leg each; K3 eight,
two per leg). The inputs put every kind of box contact to work from the
first substep (tests/torch_port_util.py contact_scene: feet, a wheel and
the trunk proxy), so the cross-lane sums of the contact wrench and the
trunk spheres' split over the lanes count. Gates
are chip_smoke.py's phases 6-7: float32 2e-4 at H 3 (K3 at S 1 and 16
plans; K4 both roles, gait weight 0.8 and 0, S 1 and 4 scenario blocks);
float64 1e-6 at H 50 on the chase plant (substeps 20, mass_freeze 1), gated
over the values whose plain result does not itself move beyond 1e-6 when
the start shifts by 1e-10 m (contact chaos; the count is asserted to leave
most values gated). The wrapper refuses a scenario block that is not a
multiple of K4's candidates per block.

Marker `cuda`: skipped where there is no card. The module imports no JAX,
so the check also runs without pytest: `python3 -c "import torch;
from tests.test_torch_chase_kernels import check_chase_kernels as c;
c(torch.device('cuda'))"` from the repo root.
"""
import numpy as np
import pytest
import torch

from lifelike_tpu_torch.ops import traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model

from tests.torch_port_util import contact_scene, screened_gate, shifted_start, stand_state

MODEL = build_max_model()


def _setup(dtype, device, horizon, substeps, mass_freeze, n_states=1, seed=0):
    """Plant constants and parameters, n_states start states 0.01 m apart in
    x (TLState with batch (n_states, 1)), the contact table (K, 8) and
    packed reference rows (H, 64) at the current joints with a little
    sinusoid on the targets."""
    rng = np.random.default_rng(seed)
    st = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0))
    table = contact_scene(MODEL, st)
    st["joint_pos"] = st["joint_pos"] + 0.01 * rng.standard_normal(12)
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    batch = {k: np.repeat(np.asarray(v, np.float64)[None], n_states, 0) for k, v in st.items()}
    batch["base_pos"][:, 0] += 0.01 * np.arange(n_states)
    state = RobotState(*(torch.as_tensor(batch[f], dtype=dtype, device=device)
                         for f in RobotState._fields))
    tl = B.tl_from_state(state)
    rows = np.concatenate([table["center"], table["half"], table["active"][:, None],
                           np.zeros((len(table["active"]), 1))], axis=1)
    boxes = torch.as_tensor(rows, dtype=dtype, device=device)
    ref = traversal_cuda.constant_reference(state.joint_pos[0], horizon)
    ref[:, :12] += 0.05 * torch.sin(torch.arange(horizon, dtype=dtype, device=device))[:, None]
    params = engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=substeps,
                                  mass_freeze=mass_freeze)
    c = B.tl_constants(MODEL, dtype=dtype, device=torch.device(device))
    return c, params, tl, boxes, ref, rng


def _check_plan(device, dtype, horizon, substeps, mass_freeze, n_scen, tol, screen):
    c, params, tl, boxes, ref, rng = _setup(dtype, device, horizon, substeps, mass_freeze, n_scen)
    plan = torch.as_tensor(0.05 * rng.standard_normal((n_scen, horizon, 4, 3)), dtype=dtype,
                           device=device)
    tabs = boxes[None].repeat(n_scen, 1, 1)
    tabs[:, :, 0] += 0.002 * torch.arange(n_scen, dtype=dtype, device=device)[:, None]
    refs = ref[None].repeat(n_scen, 1, 1)
    if n_scen == 1:
        plan, tabs, refs = plan[0], tabs[0], refs[0]
    before = traversal_cuda.rollout_plan_fused.launches
    got = traversal_cuda.rollout_plan_fused(c, params, tl, plan, tabs, refs)
    torch.cuda.synchronize()
    assert traversal_cuda.rollout_plan_fused.launches == before + 1
    assert tuple(got.shape) == (horizon, 3, n_scen, 1)
    want = traversal_cuda.rollout_plan_plain(c, params, tl, plan, tabs, refs)
    shifted = (traversal_cuda.rollout_plan_plain(c, params, shifted_start(tl), plan, tabs, refs)
               if screen else None)
    return screened_gate(got, want, shifted, tol), got.numel()


def _check_chase(device, dtype, horizon, substeps, mass_freeze, n_scen, tol, screen,
                 chaser, gait_weight, pop=256):
    c, params, tl, boxes, ref, rng = _setup(dtype, device, horizon, substeps, mass_freeze)
    u = torch.as_tensor(0.1 * rng.standard_normal((horizon, 4, 3, pop // 64, 64)), dtype=dtype,
                        device=device)
    s = torch.linspace(0.0, 1.0, horizon, dtype=dtype, device=device)
    opp = torch.stack([1.0 + 0.5 * s, 0.2 - 0.2 * s, torch.full_like(s, 0.3)], -1)
    flag = torch.tensor([2.0, -1.0, 0.3], dtype=dtype, device=device)
    role = torch.tensor(chaser, device=device)
    if n_scen > 1:
        k = torch.arange(n_scen, dtype=dtype, device=device)
        boxes = boxes[None].repeat(n_scen, 1, 1)
        boxes[:, :, 0] += 0.002 * k[:, None]
        ref = torch.stack([ref * (1.0 + 0.01 * i) for i in range(n_scen)])
        opp = opp[None] + 0.1 * k[:, None, None]
        flag = flag[None] + k[:, None]
        role = torch.arange(n_scen, device=device) % 2 == 0
    args = (boxes, ref, opp, flag, role)
    before = traversal_cuda.rollout_chase_fused.launches
    got = traversal_cuda.rollout_chase_fused(c, params, tl, u, *args, gait_weight=gait_weight)
    torch.cuda.synchronize()
    assert traversal_cuda.rollout_chase_fused.launches == before + 1
    assert tuple(got.shape) == (pop // 64, 64)
    want = traversal_cuda.rollout_chase_plain(c, params, tl, u, *args, gait_weight=gait_weight)
    shifted = (traversal_cuda.rollout_chase_plain(c, params, shifted_start(tl), u, *args,
                                                  gait_weight=gait_weight) if screen else None)
    return screened_gate(got, want, shifted, tol), got.numel()


def check_chase_kernels(device):
    f32, f64 = torch.float32, torch.float64
    for n in (1, 16):  # one plan; the scenario sweep's 16
        _check_plan(device, f32, 3, 2, 1, n, 2e-4, False)
    for n in (1, 16):
        gated, total = _check_plan(device, f64, 50, 20, 1, n, 1e-6, True)
        assert gated >= total // 2, (gated, total)
    for chaser in (True, False):
        for gw in (0.8, 0.0):
            _check_chase(device, f32, 3, 2, 1, 1, 2e-4, False, chaser, gw)
    _check_chase(device, f64, 3, 2, 1, 4, 1e-6, False, True, 0.8)  # four scenario blocks
    gated, total = _check_chase(device, f64, 50, 20, 1, 1, 1e-6, True, False, 0.0)
    assert gated >= total // 2, (gated, total)
    # a scenario block must hold whole blocks of candidates
    per_block = traversal_cuda.launch_geometry(traversal_cuda.CHASE_KERNEL, 64).per_block
    c, params, tl, boxes, ref, _ = _setup(f32, device, 3, 2, 1)
    u = torch.zeros((3, 4, 3, 4, per_block // 2), dtype=f32, device=device)
    tabs = boxes[None].repeat(4, 1, 1)
    with pytest.raises(ValueError, match=f"multiple of {per_block}"):
        traversal_cuda.rollout_chase_fused(c, params, tl, u, tabs, ref, torch.zeros(3, 3),
                                           torch.zeros(3), True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA chase kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chase_kernels_match_plain(cuda_device):
    check_chase_kernels(cuda_device)

"""Fused task rollouts with box contact on the card: the CUDA counterparts of
ops/traversal_pallas (K2, K3, K4).

  * `rollout_traversal_fused` (K2, csrc/rollout_traversal.cu) scores every
    MPPI candidate of an EPMC traversal solve: H control steps of the MAX
    quadruped with box contact against a pruned K-box table
    (csrc/scalar_phys.cuh) from the solve's one start state, plus the
    traversal stage cost: a group of lanes of one warp per candidate (two
    per leg, splitting its foot and wheel contact). With
    gait_weight = 0 and a constant reference equal to the current joints
    it computes solver.rollout_tasks.rollout_traversal.
  * `rollout_plan_fused` (K3, csrc/rollout_plan.cu) rolls one fixed plan per
    scenario and returns its base-position trajectory: the opponent's path
    of a chase solve. One warp per scenario, eight lanes of it rolling the
    plan (two per leg, splitting its foot and wheel contact;
    csrc/scalar_phys.cuh substep_group).
  * `rollout_chase_fused` (K4, csrc/rollout_chase.cu) scores the candidates
    of one robot of a SEPMC chase solve against the opponent's trajectory,
    either role by a mask: a group of four lanes per candidate (one leg
    each), eight candidates per one-warp block. A scenario sweep
    (parallel.scenario_sweep) passes S scenario blocks, each with its own
    start state.

Controls are deltas on the packed reference's target joints. Candidates (K2,
K4) may be split into S scenarios (Bs / S rows each), each with its own box
table, reference rows and task row; K3 takes S plans.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the kernel's plain PyTorch version (`rollout_traversal_plain`,
`rollout_plan_plain`, `rollout_chase_plain`). The kernels are built at first
use by ops.cuda_build.
"""
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch.costs.chase import ChaseWeights
from lifelike_tpu_torch.costs.traversal import STAND_POSE, TraversalWeights
from lifelike_tpu_torch.ops import cuda_build
from lifelike_tpu_torch.ops.rollout_cuda import (
    _REF_WIDTH,
    _STATE_LEN,
    _check,
    _check_state,
    _packed_model,
    pack_reference,
)
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine_tl
from lifelike_tpu_torch.solver import rollout_tasks, rollout_tl

_HEADERS = ("scalar_phys.cuh", "task_cost.cuh")
KERNEL = cuda_build.Kernel("rollout_traversal.cu", _HEADERS)  # K2
PLAN_KERNEL = cuda_build.Kernel("rollout_plan.cu", _HEADERS)  # K3
CHASE_KERNEL = cuda_build.Kernel("rollout_chase.cu", _HEADERS)  # K4
BOX_WIDTH = 8  # packed box row: cx cy cz hx hy hz active pad
TASK_WIDTH = 8  # packed task row: K2 target x y z, speed; K4 flag x y, chaser_m; pad
OFF_OPP = 61  # packed reference columns 61-62: the opponent's base x, y (K4)


class _Lib(NamedTuple):
    name: str  # C symbol stem: lifelike_rollout_<name>_f32, lifelike_<name>_attrs_f32, ...
    launch_args: tuple  # ctypes argument types of the launch function
    param_len: int  # host double parameter vector of the launch
    symbol: str  # kernel function name in the ptxas report
    group: int  # lanes per candidate (K3: per plan); checked against the library
    per_block: int  # candidates (K3: plans) per block of BLOCK threads


class LaunchGeometry(NamedTuple):
    group: int  # lanes per candidate (K3: per plan)
    threads: int  # threads per block
    per_block: int  # candidates (K3: plans) per block
    blocks: int  # grid size


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
BLOCK = 32  # threads per block of K2, K3 and K4: one warp
_LIB_SPECS = {
    KERNEL: _Lib("traversal", (_PTR,) * 4 + (_I32,) + (_PTR,) * 3 + (_I64, _I64, _PTR, _I32, _PTR),
                 43, "rollout_traversal_kernel", 8, 4),
    PLAN_KERNEL: _Lib("plan", (_PTR,) * 3 + (_I32,) + (_PTR,) * 3 + (_I32, _PTR, _I32, _PTR),
                      16, "rollout_plan_kernel", 8, 1),
    CHASE_KERNEL: _Lib("chase", (_PTR,) * 4 + (_I32,) + (_PTR,) * 3 + (_I64, _I64, _PTR, _I32, _PTR),
                       37, "rollout_chase_kernel", 4, 8),
}
_LOADED = {}  # Kernel -> (ctypes library, BuildInfo)


def build(kernel: cuda_build.Kernel = KERNEL) -> cuda_build.BuildInfo:
    """Compile (if needed) and load one kernel library of this module
    (KERNEL, PLAN_KERNEL or CHASE_KERNEL); idempotent."""
    if kernel in _LOADED:
        return _LOADED[kernel][1]
    spec = _LIB_SPECS[kernel]
    info = cuda_build.build(kernel)
    lib = ctypes.CDLL(info.path)
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"lifelike_rollout_{spec.name}_{dt}")
        fn.argtypes = list(spec.launch_args)
        fn.restype = _I32
        fn = getattr(lib, f"lifelike_{spec.name}_attrs_{dt}")
        fn.argtypes = [ctypes.POINTER(_I32)] * 4 + [_I32, _I32]
        fn.restype = _I32
    for stem in ("block_size", "group_size", "param_len"):
        getattr(lib, f"lifelike_{spec.name}_{stem}").argtypes = []
        getattr(lib, f"lifelike_{spec.name}_{stem}").restype = _I32
    if getattr(lib, f"lifelike_{spec.name}_param_len")() != spec.param_len:
        raise RuntimeError(f"{kernel.source}: parameter layout differs from ops/traversal_cuda.py")
    if (getattr(lib, f"lifelike_{spec.name}_block_size")(),
            getattr(lib, f"lifelike_{spec.name}_group_size")()) != (BLOCK, spec.group):
        raise RuntimeError(f"{kernel.source}: block / group size differs from ops/traversal_cuda.py")
    _LOADED[kernel] = (lib, info)
    return info


def _fn(kernel, dtype):
    build(kernel)
    spec = _LIB_SPECS[kernel]
    suffix = "f64" if dtype == torch.float64 else "f32"
    return getattr(_LOADED[kernel][0], f"lifelike_rollout_{spec.name}_{suffix}")


def launch_geometry(kernel: cuda_build.Kernel, n, n_scen=1) -> LaunchGeometry:
    """Block and grid of a launch of `kernel` over n candidates (K3: n
    plans, one block each) in n_scen scenario blocks. A block must lie inside
    one scenario: with more than one scenario, the candidates per scenario
    must be a multiple of the block's (ValueError otherwise)."""
    spec = _LIB_SPECS[kernel]
    if n <= 0 or n_scen <= 0 or n % n_scen:
        raise ValueError(f"{n} candidates in {n_scen} scenarios")
    if n_scen > 1 and (n // n_scen) % spec.per_block:
        raise ValueError(f"{n // n_scen} candidates per scenario: a multiple of {spec.per_block} "
                         "(one block) is needed when there is more than one scenario")
    return LaunchGeometry(spec.group, BLOCK, spec.per_block, -(-n // spec.per_block))


def ptxas_summary(text, kernel: cuda_build.Kernel = KERNEL):
    """ptxas registers / spills / stack of one kernel's instances."""
    return cuda_build.ptxas_summary(text, _LIB_SPECS[kernel].symbol)


def kernel_attributes(dtype=torch.float32, horizon=50, n_boxes=8,
                      kernel: cuda_build.Kernel = KERNEL):
    """Registers, local (spill) bytes per thread, block size, lanes per
    candidate (group), candidates per block and resident blocks per SM of a
    compiled kernel, from the CUDA runtime."""
    build(kernel)
    lib, spec = _LOADED[kernel][0], _LIB_SPECS[kernel]
    fn = getattr(lib, f"lifelike_{spec.name}_attrs_{'f64' if dtype == torch.float64 else 'f32'}")
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = fn(*(ctypes.byref(v) for v in vals), int(horizon), int(n_boxes))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes/occupancy failed: error {err}")
    regs, local, max_threads, blocks = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local, "max_threads": max_threads,
            "block": getattr(lib, f"lifelike_{spec.name}_block_size")(), "group": spec.group,
            "per_block": spec.per_block, "blocks_per_sm": blocks}


def pack_boxes(scene) -> torch.Tensor:
    """BoxScene / TLScene (one scenario) -> (K, 8) rows [center, half,
    active, 0] in the scene's dtype."""
    center = scene.center.reshape(-1, 3)
    half = scene.half.reshape(-1, 3)
    active = scene.active.reshape(-1, 1).to(center.dtype)
    return torch.cat([center, half, active, torch.zeros_like(active)], dim=1)


def constant_reference(joint_pos, horizon) -> torch.Tensor:
    """Packed (H, 64) reference rows whose target joints are `joint_pos`
    (12 values) at every step and whose tracking columns are zero: with
    gait_weight = 0 the task kernels then compute the raw-delta rollouts
    (rollout_traversal, rollout_chase, rollout_plan: controls as deltas on
    the current pose)."""
    rows = joint_pos.new_zeros((horizon, _REF_WIDTH))
    rows[:, :12] = joint_pos.reshape(1, 12)
    return rows


def _unpack_reference(rows) -> rollout_tl.RefTraj:
    """Packed rows (H, 64) or (S, H, 64) -> RefTraj with trailing (S, 1)
    batch axes (S = 1 for (H, 64))."""
    if rows.dim() == 2:
        rows = rows[None]
    S, H = rows.shape[0], rows.shape[1]
    r = rows.permute(1, 2, 0)  # (H, 64, S)

    def cols(a, shape):
        return r[:, a:a + int(np.prod(shape))].reshape((H,) + shape + (S, 1))

    return rollout_tl.RefTraj(
        target_joint=cols(0, (4, 3)), joint_pos=cols(12, (4, 3)), joint_vel=cols(24, (4, 3)),
        foot_pos=cols(36, (4, 3)), base_pos=cols(48, (3,)), base_orn=cols(51, (4,)),
        base_lin_vel=cols(55, (3,)), base_ang_vel=cols(58, (3,)),
    )


def _tables(dev, dtype, boxes, ref, horizon, n_scen=None):
    """Box tables (S, K, 8) and reference rows (S, H, 64), contiguous, in
    `dtype` on `dev`. boxes: (K, 8) / (S, K, 8) or a BoxScene / TLScene; ref:
    a RefTraj or packed (H, 64) / (S, H, 64) rows. S is n_scen, else the
    number of box tables."""
    if not torch.is_tensor(boxes):
        boxes = pack_boxes(boxes)
    boxes = boxes.to(device=dev, dtype=dtype)
    if boxes.dim() == 2:
        boxes = boxes[None]
    if boxes.dim() != 3 or boxes.shape[2] != BOX_WIDTH:
        raise ValueError(f"boxes: expected (S, K, {BOX_WIDTH}), got {tuple(boxes.shape)}")
    S = boxes.shape[0] if n_scen is None else n_scen
    if boxes.shape[0] not in (1, S):
        raise ValueError(f"boxes: {boxes.shape[0]} tables for {S} scenarios")
    boxes = boxes.expand((S,) + tuple(boxes.shape[1:]))
    rows = ref if torch.is_tensor(ref) else pack_reference(ref)
    rows = rows.to(device=dev, dtype=dtype)
    if rows.dim() == 2:
        rows = rows[None].expand((S,) + tuple(rows.shape))
    if rows.shape[0] != S or rows.shape[1:] != (horizon, _REF_WIDTH):
        raise ValueError(f"ref: expected ({S}, {horizon}, {_REF_WIDTH}) rows, "
                         f"got {tuple(rows.shape)}")
    return boxes.contiguous(), rows.contiguous()


def _scene_tl(tab) -> engine_tl.TLScene:
    """Box tables (S, K, 8) -> TLScene with trailing (S, 1) batch axes."""
    return engine_tl.TLScene(center=tab[:, :, 0:3].permute(1, 2, 0)[..., None],
                             half=tab[:, :, 3:6].permute(1, 2, 0)[..., None],
                             active=tab[:, :, 6].permute(1, 0)[..., None])


def _phys_params(params, horizon, n_boxes):
    """The physics head of every task kernel's host parameter vector:
    kp, kd, max_tau, mu, dt, kn, dn, v_slip, fric_visc_cap, ext[3],
    substeps, mass_freeze, horizon, n_boxes."""
    cp = params.contact
    ext = np.asarray(params.ext_force, np.float64).reshape(3)
    return [params.kp, params.kd, params.max_tau, params.foot_friction, params.dt, cp.kn, cp.dn,
            cp.v_slip, cp.fric_visc_cap, *ext, params.substeps, max(int(params.mass_freeze), 1),
            horizon, n_boxes]


def _check_launch(controls, n_scen):
    if controls.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"controls: unsupported dtype {controls.dtype}")
    if controls.dim() != 5 or tuple(controls.shape[1:3]) != (4, 3):
        raise ValueError(f"controls: expected (H, 4, 3, Bs, L), got {tuple(controls.shape)}")
    Bs = controls.shape[3]
    if Bs % n_scen:
        raise ValueError(f"{n_scen} scenarios do not divide the {Bs} candidate rows")


def _pack_state(state: B.TLState, n_scen, dev, dtype):
    """TLState with batch (1, 1) or (S, 1) -> (S, 37) start states."""
    for name, x in zip(B.TLState._fields, state):
        _check(f"state.{name}", x, dev, dtype)
        if tuple(x.shape[-2:]) not in ((1, 1), (n_scen, 1)):
            raise ValueError(f"state.{name}: batch {tuple(x.shape[-2:])}, expected (1, 1) or "
                             f"({n_scen}, 1)")
    st = torch.cat([x.expand(x.shape[:-2] + (n_scen, 1)).reshape(-1, n_scen).T for x in state],
                   dim=1)
    if st.shape[1] != _STATE_LEN:
        raise ValueError(f"state: {st.shape[1]} values, expected {_STATE_LEN}")
    return st.contiguous()


def _launch_candidates(kernel, c, state, controls, tab, rows, task, hp):
    """Launch K2 or K4 (a lane group per candidate) over the candidates of
    `controls` in S = len(tab) scenario blocks: K2 from the one start state,
    K4 from each block's own (a state of batch (1, 1) serves every block).
    Returns the cost (Bs, L)."""
    dev, dtype = controls.device, controls.dtype
    S = tab.shape[0]
    _check_launch(controls, S)
    if not controls.is_contiguous():
        raise ValueError("controls must be contiguous")
    H, Bs, L = controls.shape[0], controls.shape[3], controls.shape[4]
    n = Bs * L
    launch_geometry(kernel, n, S)
    _check("c.joint_offset", c.joint_offset, dev, dtype)
    st = _pack_state(state, S if kernel is CHASE_KERNEL else 1, dev, dtype)
    model = _packed_model(c)
    cost = torch.empty((Bs, L), dtype=dtype, device=dev)
    fn = _fn(kernel, dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), task.data_ptr(), tab.data_ptr(), model.data_ptr(),
                 model.numel(), st.data_ptr(), controls.data_ptr(), cost.data_ptr(), n, S,
                 hp.ctypes.data, hp.size, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.source} launch failed: error {err}")
    return cost


def _dispatch(controls, launch, plain, args):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if controls.is_cuda:
        return launch(*args)
    if controls.device.type != "cpu":
        raise ValueError(f"unsupported device {controls.device}")
    return plain(*args)


# ------------------------------------------------------------ K2 traversal


def scenario_inputs(controls, boxes, ref, target_pos, target_spd):
    """K2's scenario tables in the controls' dtype and device: boxes
    (S, K, 8), reference rows (S, H, 64), task rows (S, 8).

    boxes: a (K, 8) / (S, K, 8) table or a BoxScene / TLScene; ref: a
    RefTraj or packed (H, 64) / (S, H, 64) rows; target_pos (3,) or (S, 3);
    target_spd scalar or (S,)."""
    dev, dtype = controls.device, controls.dtype
    boxes, rows = _tables(dev, dtype, boxes, ref, controls.shape[0])
    S = boxes.shape[0]
    tp = torch.as_tensor(target_pos, dtype=dtype, device=dev).reshape(-1, 3).expand(S, 3)
    spd = torch.as_tensor(target_spd, dtype=dtype, device=dev).reshape(-1, 1).expand(S, 1)
    task = torch.cat([tp, spd, tp.new_zeros((S, TASK_WIDTH - 4))], dim=1)
    return boxes, rows, task.contiguous()


def host_params(params, weights: TraversalWeights, horizon, n_boxes, reward_type, max_steps,
                gait_weight, gait_vel_weight):
    """K2's runtime scalars as float64 (layout of csrc/rollout_traversal.cu
    params_from_host)."""
    w = weights
    return np.array(
        _phys_params(params, horizon, n_boxes)
        + [1.0 if reward_type == "joystick" else 0.0, 0.2 / float(max_steps),
           w.velocity, w.heading, w.clearance, w.fall, w.height, w.height_min, w.upright,
           w.pose, w.ceiling, w.ceiling_w, w.crawl_gap, gait_weight, gait_vel_weight,
           *STAND_POSE],
        np.float64,
    )


def rollout_traversal_plain(c: B.TLConstants, params, state: B.TLState, controls, boxes, ref,
                            target_pos, target_spd, reward_type="joystick", max_steps=1000,
                            weights: TraversalWeights = TraversalWeights(), gait_weight=1.0,
                            gait_vel_weight=0.02):
    """K2's plain PyTorch version (same arguments as
    rollout_traversal_fused): rollout_tasks.rollout_traversal_gait for each
    scenario's block of candidate rows. Returns the total cost (Bs, L)."""
    tab, rows, task = scenario_inputs(controls, boxes, ref, target_pos, target_spd)
    S = tab.shape[0]
    _check_launch(controls, S)
    bs = controls.shape[3] // S
    costs = []
    for k in range(S):
        cost, _ = rollout_tasks.rollout_traversal_gait(
            c, params, state, controls[:, :, :, k * bs:(k + 1) * bs], _scene_tl(tab[k:k + 1]),
            _unpack_reference(rows[k]), task[k, :3], task[k, 3], reward_type, max_steps,
            weights, gait_weight, gait_vel_weight)
        costs.append(cost)
    return torch.cat(costs, dim=0)


def _launch_traversal(c, params, state, controls, boxes, ref, target_pos, target_spd,
                      reward_type, max_steps, weights, gait_weight, gait_vel_weight):
    tab, rows, task = scenario_inputs(controls, boxes, ref, target_pos, target_spd)
    hp = host_params(params, weights, controls.shape[0], tab.shape[1], reward_type, max_steps,
                     gait_weight, gait_vel_weight)
    cost = _launch_candidates(KERNEL, c, state, controls, tab, rows, task, hp)
    rollout_traversal_fused.launches += 1
    return cost


def rollout_traversal_fused(c: B.TLConstants, params, state: B.TLState, controls, boxes, ref,
                            target_pos, target_spd, reward_type="joystick", max_steps=1000,
                            weights: TraversalWeights = TraversalWeights(), gait_weight=1.0,
                            gait_vel_weight=0.02):
    """Total traversal cost (Bs, L) of the candidates `controls`
    (H, 4, 3, Bs, L) — joint-target deltas on the reference's target
    joints — all rolled from the one start state `state` (TLState with
    batch (1, 1)) against the pruned box table `boxes`. See
    `scenario_inputs` for the accepted forms of boxes / ref / target.

    CUDA tensors: the hand-written kernel K2 (counted in
    `rollout_traversal_fused.launches`). CPU tensors: the plain version
    rollout_traversal_plain."""
    _check_state(state)
    return _dispatch(controls, _launch_traversal, rollout_traversal_plain,
                     (c, params, state, controls, boxes, ref, target_pos, target_spd,
                      reward_type, max_steps, weights, gait_weight, gait_vel_weight))


rollout_traversal_fused.launches = 0


# ----------------------------------------------------------------- K3 plan


def plan_inputs(u_plan, boxes, ref):
    """K3's inputs in u_plan's dtype and device: plans (S, H, 4, 3) (S = 1
    for a single (H, 4, 3) plan), box tables (S, K, 8) and reference rows
    (S, H, 64); a single table / reference serves every scenario."""
    up = u_plan if u_plan.dim() == 4 else u_plan[None]
    if up.dim() != 4 or tuple(up.shape[2:]) != (4, 3):
        raise ValueError(f"u_plan: expected (H, 4, 3) or (S, H, 4, 3), got {tuple(u_plan.shape)}")
    S, H = up.shape[0], up.shape[1]
    tab, rows = _tables(up.device, up.dtype, boxes, ref, H, S)
    return up.contiguous(), tab, rows


def plan_host_params(params, horizon, n_boxes):
    """K3's runtime scalars as float64 (layout of csrc/rollout_plan.cu
    params_from_host)."""
    return np.array(_phys_params(params, horizon, n_boxes), np.float64)


def rollout_plan_plain(c: B.TLConstants, params, state: B.TLState, u_plan, boxes, ref):
    """K3's plain PyTorch version (same arguments as rollout_plan_fused):
    rollout_tasks.rollout_plan_gait with the S scenarios on the trailing
    batch axes. Returns the base positions (H, 3, S, 1)."""
    up, tab, rows = plan_inputs(u_plan, boxes, ref)
    S = up.shape[0]
    st = B.map_state(lambda x: x.expand(x.shape[:-2] + (S, 1)), state)
    return rollout_tasks.rollout_plan_gait(c, params, st, up.permute(1, 2, 3, 0)[..., None],
                                           _scene_tl(tab), _unpack_reference(rows))


def _launch_plan(c, params, state, u_plan, boxes, ref):
    up, tab, rows = plan_inputs(u_plan, boxes, ref)
    dev, dtype = up.device, up.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"u_plan: unsupported dtype {dtype}")
    S, H, K = up.shape[0], up.shape[1], tab.shape[1]
    _check("c.joint_offset", c.joint_offset, dev, dtype)
    st = _pack_state(state, S, dev, dtype)
    model = _packed_model(c)
    hp = plan_host_params(params, H, K)
    traj = torch.empty((H, 3, S), dtype=dtype, device=dev)
    fn = _fn(PLAN_KERNEL, dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), tab.data_ptr(), model.data_ptr(), model.numel(), st.data_ptr(),
                 up.data_ptr(), traj.data_ptr(), S, hp.ctypes.data, hp.size, stream)
    if err != 0:
        raise RuntimeError(f"{PLAN_KERNEL.source} launch failed: error {err}")
    rollout_plan_fused.launches += 1
    return traj[..., None]


def rollout_plan_fused(c: B.TLConstants, params, state: B.TLState, u_plan, boxes, ref):
    """Base-position trajectories of fixed plans (rollout_tasks.rollout_plan
    [_gait]): the opponent's path of a chase solve.

    Single plan: state batch (1, 1), u_plan (H, 4, 3) -> (H, 3, 1, 1).
    Batched: state batch (S, 1) (or (1, 1), shared), u_plan (S, H, 4, 3),
    boxes (S, K, 8) or one table, ref (S, H, 64) or one reference ->
    (H, 3, S, 1). u_plan are deltas on the reference's target joints (a
    constant_reference at the current joints gives rollout_plan).

    CUDA tensors: the hand-written kernel K3 (counted in
    `rollout_plan_fused.launches`). CPU tensors: rollout_plan_plain."""
    return _dispatch(u_plan, _launch_plan, rollout_plan_plain,
                     (c, params, state, u_plan, boxes, ref))


rollout_plan_fused.launches = 0


# ---------------------------------------------------------------- K4 chase


def chase_inputs(controls, boxes, ref, opp_traj, flag_pos, is_chaser):
    """K4's scenario tables in the controls' dtype and device: boxes
    (S, K, 8); reference rows (S, H, 64) with the opponent's base x, y in
    columns 61-62; task rows (S, 8) = [flag x, flag y, chaser_m, 0 ...].

    opp_traj: (H, 3[, 1, 1]) shared by every scenario, or (S, H, 2+) per
    scenario; flag_pos (3,) or (S, 3); is_chaser: bool / 0-1 scalar, 0-d
    tensor or (S,) — kept on the device, so a role held in a CUDA tensor
    costs no host synchronisation."""
    dev, dtype = controls.device, controls.dtype
    H = controls.shape[0]
    tab, rows = _tables(dev, dtype, boxes, ref, H)
    S = tab.shape[0]
    rows = rows.clone()
    opp = torch.as_tensor(opp_traj, device=dev).to(dtype)
    if opp.dim() >= 3 and opp.shape[0] == S and S > 1:
        rows[:, :, OFF_OPP:OFF_OPP + 2] = opp.reshape(S, H, -1)[..., :2]
    else:
        rows[:, :, OFF_OPP:OFF_OPP + 2] = opp.reshape(H, -1)[None, :, :2]
    fp = torch.as_tensor(flag_pos, device=dev).to(dtype)
    fp = fp.reshape(-1, fp.shape[-1])[:, :2].expand(S, 2)
    ch = torch.as_tensor(is_chaser, device=dev).to(dtype).reshape(-1, 1).expand(S, 1)
    task = torch.cat([fp, ch, fp.new_zeros((S, TASK_WIDTH - 3))], dim=1)
    return tab, rows, task.contiguous()


def chase_host_params(params, weights: ChaseWeights, horizon, n_boxes, gait_weight,
                      gait_vel_weight):
    """K4's runtime scalars as float64 (layout of csrc/rollout_chase.cu
    params_from_host)."""
    w = weights
    return np.array(
        _phys_params(params, horizon, n_boxes)
        + [w.distance, w.heading, w.fall, w.height, w.height_min, w.upright, w.pose,
           gait_weight, gait_vel_weight, *STAND_POSE],
        np.float64,
    )


def rollout_chase_plain(c: B.TLConstants, params, state: B.TLState, controls, boxes, ref,
                        opp_traj, flag_pos, is_chaser, weights: ChaseWeights = ChaseWeights(),
                        gait_weight=1.0, gait_vel_weight=0.02):
    """K4's plain PyTorch version (same arguments as rollout_chase_fused):
    rollout_tasks.rollout_chase_gait for each scenario's block of candidate
    rows, reading the opponent, the flag and the role from the packed
    tables. Returns the total cost (Bs, L)."""
    tab, rows, task = chase_inputs(controls, boxes, ref, opp_traj, flag_pos, is_chaser)
    S, H = tab.shape[0], controls.shape[0]
    _check_launch(controls, S)
    _check_chase_state(state, S)
    bs = controls.shape[3] // S
    costs = []
    for k in range(S):
        opp = rows[k, :, OFF_OPP:OFF_OPP + 2].reshape(H, 2, 1, 1)
        st = B.map_state(lambda x, k=k: x[..., k:k + 1, :] if x.shape[-2] > 1 else x, state)
        cost, _ = rollout_tasks.rollout_chase_gait(
            c, params, st, controls[:, :, :, k * bs:(k + 1) * bs], _scene_tl(tab[k:k + 1]),
            _unpack_reference(rows[k]), opp, task[k, :2], task[k, 2], weights, gait_weight,
            gait_vel_weight)
        costs.append(cost)
    return torch.cat(costs, dim=0)


def _check_chase_state(state: B.TLState, n_scen):
    for name, x in zip(B.TLState._fields, state):
        if tuple(x.shape[-2:]) not in ((1, 1), (n_scen, 1)):
            raise ValueError(f"state.{name}: batch {tuple(x.shape[-2:])}, expected (1, 1) or "
                             f"one start state per scenario, ({n_scen}, 1)")


def _launch_chase(c, params, state, controls, boxes, ref, opp_traj, flag_pos, is_chaser, weights,
                  gait_weight, gait_vel_weight):
    tab, rows, task = chase_inputs(controls, boxes, ref, opp_traj, flag_pos, is_chaser)
    _check_chase_state(state, tab.shape[0])
    hp = chase_host_params(params, weights, controls.shape[0], tab.shape[1], gait_weight,
                           gait_vel_weight)
    cost = _launch_candidates(CHASE_KERNEL, c, state, controls, tab, rows, task, hp)
    rollout_chase_fused.launches += 1
    return cost


def rollout_chase_fused(c: B.TLConstants, params, state: B.TLState, controls, boxes, ref,
                        opp_traj, flag_pos, is_chaser, weights: ChaseWeights = ChaseWeights(),
                        gait_weight=1.0, gait_vel_weight=0.02):
    """Total chase cost (Bs, L) of one robot's candidates `controls`
    (H, 4, 3, Bs, L) — joint-target deltas on the reference's target
    joints — rolled from the start state `state` against the arena table
    `boxes` and the opponent's trajectory `opp_traj`; is_chaser selects the
    role. See `chase_inputs` for the accepted forms; with S scenario blocks,
    `state` has batch (1, 1) (one start for all) or (S, 1) (block k's rows
    start from state k, as a scenario sweep needs). With gait_weight = 0 and
    a constant reference at the current joints it computes
    rollout_tasks.rollout_chase.

    CUDA tensors: the hand-written kernel K4 (counted in
    `rollout_chase_fused.launches`). CPU tensors: rollout_chase_plain."""
    return _dispatch(controls, _launch_chase, rollout_chase_plain,
                     (c, params, state, controls, boxes, ref, opp_traj, flag_pos, is_chaser,
                      weights, gait_weight, gait_vel_weight))


rollout_chase_fused.launches = 0

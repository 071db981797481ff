"""Fused EPMC traversal rollout on the card: the CUDA counterpart of
ops/traversal_pallas.rollout_traversal_fused (K2).

`rollout_traversal_fused` scores every MPPI candidate of an EPMC traversal
solve: H control steps of the MAX quadruped with box contact against a
pruned K-box table (csrc/scalar_phys.cuh) from the solve's one start state,
plus the traversal stage cost, one CUDA thread per candidate
(csrc/rollout_traversal.cu). Controls are deltas on the packed reference's
target joints; with gait_weight = 0 and a constant reference equal to the
current joints it computes solver.rollout_tasks.rollout_traversal.
Candidates may be split into S scenarios (Bs / S rows each), each with its
own box table, reference rows and target.

On a CUDA tensor it launches that kernel (or raises); on a CPU tensor it runs
the kernel's plain PyTorch version, `rollout_traversal_plain`. The kernel is
built at first use by ops.cuda_build.
"""
import ctypes

import numpy as np
import torch

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

KERNEL = cuda_build.Kernel("rollout_traversal.cu", ("scalar_phys.cuh",))
BOX_WIDTH = 8  # packed box row: cx cy cz hx hy hz active pad
TASK_WIDTH = 8  # packed task row: target x y z, target speed, pad
_PARAM_LEN = 43

_LIB = None
_BUILD = None


def build() -> cuda_build.BuildInfo:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _LIB, _BUILD
    if _LIB is not None:
        return _BUILD
    info = cuda_build.build(KERNEL)
    lib = ctypes.CDLL(info.path)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("lifelike_rollout_traversal_f32", "lifelike_rollout_traversal_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i64, i64, ptr, i32, ptr]
        fn.restype = i32
    for name in ("lifelike_traversal_attrs_f32", "lifelike_traversal_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(i32)] * 4 + [i32, i32]
        fn.restype = i32
    for name in ("lifelike_traversal_block_size", "lifelike_traversal_param_len",
                 "lifelike_traversal_model_len_f32", "lifelike_traversal_model_len_f64"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if lib.lifelike_traversal_param_len() != _PARAM_LEN:
        raise RuntimeError("kernel parameter layout differs from ops/traversal_cuda.py")
    _LIB, _BUILD = lib, info
    return _BUILD


def ptxas_summary(text):
    """ptxas registers / spills / stack of the traversal kernel's instances."""
    return cuda_build.ptxas_summary(text, "rollout_traversal_kernel")


def kernel_attributes(dtype=torch.float32, horizon=50, n_boxes=8):
    """Registers, local (spill) bytes per thread, block size and resident
    blocks per SM of the compiled kernel, from the CUDA runtime."""
    build()
    fn = (_LIB.lifelike_traversal_attrs_f64 if dtype == torch.float64
          else _LIB.lifelike_traversal_attrs_f32)
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = fn(*(ctypes.byref(v) for v in vals), int(horizon), int(n_boxes))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes/occupancy failed: error {err}")
    regs, local, max_threads, blocks = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local, "max_threads": max_threads,
            "block": _LIB.lifelike_traversal_block_size(), "blocks_per_sm": blocks}


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
    gait_weight = 0 the kernel then computes rollout_tasks.rollout_traversal
    (controls as deltas on the current pose)."""
    rows = joint_pos.new_zeros((horizon, _REF_WIDTH))
    rows[:, :12] = joint_pos.reshape(1, 12)
    return rows


def _unpack_reference(rows) -> rollout_tl.RefTraj:
    """(H, 64) packed rows -> RefTraj with trailing (1, 1) batch axes."""
    H = rows.shape[0]

    def cols(a, shape):
        return rows[:, a:a + int(np.prod(shape))].reshape((H,) + shape + (1, 1))

    return rollout_tl.RefTraj(
        target_joint=cols(0, (4, 3)), joint_pos=cols(12, (4, 3)), joint_vel=cols(24, (4, 3)),
        foot_pos=cols(36, (4, 3)), base_pos=cols(48, (3,)), base_orn=cols(51, (4,)),
        base_lin_vel=cols(55, (3,)), base_ang_vel=cols(58, (3,)),
    )


def scenario_inputs(controls, boxes, ref, target_pos, target_spd):
    """The launch's scenario tables in the controls' dtype and device:
    boxes (S, K, 8), reference rows (S, H, 64), task rows (S, 8).

    boxes: a (K, 8) / (S, K, 8) table or a BoxScene / TLScene; ref: a
    RefTraj or packed (H, 64) / (S, H, 64) rows; target_pos (3,) or (S, 3);
    target_spd scalar or (S,)."""
    dev, dtype = controls.device, controls.dtype
    if not torch.is_tensor(boxes):
        boxes = pack_boxes(boxes)
    boxes = boxes.to(device=dev, dtype=dtype)
    if boxes.dim() == 2:
        boxes = boxes[None]
    S = boxes.shape[0]
    if boxes.dim() != 3 or boxes.shape[2] != BOX_WIDTH:
        raise ValueError(f"boxes: expected (S, K, {BOX_WIDTH}), got {tuple(boxes.shape)}")
    rows = ref if torch.is_tensor(ref) else pack_reference(ref)
    rows = rows.to(device=dev, dtype=dtype)
    if rows.dim() == 2:
        rows = rows[None].expand((S,) + tuple(rows.shape))
    if rows.shape[0] != S or rows.shape[1:] != (controls.shape[0], _REF_WIDTH):
        raise ValueError(f"ref: expected ({S}, {controls.shape[0]}, {_REF_WIDTH}) rows, "
                         f"got {tuple(rows.shape)}")
    tp = torch.as_tensor(target_pos, dtype=dtype, device=dev).reshape(-1, 3).expand(S, 3)
    spd = torch.as_tensor(target_spd, dtype=dtype, device=dev).reshape(-1, 1).expand(S, 1)
    task = torch.cat([tp, spd, tp.new_zeros((S, TASK_WIDTH - 4))], dim=1)
    return boxes.contiguous(), rows.contiguous(), task.contiguous()


def host_params(params, weights: TraversalWeights, horizon, n_boxes, reward_type, max_steps,
                gait_weight, gait_vel_weight):
    """Runtime scalars of the launch as float64 (layout of
    csrc/rollout_traversal.cu params_from_host)."""
    cp = params.contact
    ext = np.asarray(params.ext_force, np.float64).reshape(3)
    w = weights
    return np.array(
        [params.kp, params.kd, params.max_tau, params.foot_friction, params.dt,
         cp.kn, cp.dn, cp.v_slip, cp.fric_visc_cap, *ext,
         params.substeps, max(int(params.mass_freeze), 1), horizon, n_boxes,
         1.0 if reward_type == "joystick" else 0.0, 0.2 / float(max_steps),
         w.velocity, w.heading, w.clearance, w.fall, w.height, w.height_min, w.upright,
         w.pose, w.ceiling, w.ceiling_w, w.crawl_gap, gait_weight, gait_vel_weight,
         *STAND_POSE],
        np.float64,
    )


def _check_launch(controls, n_scen):
    if controls.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"controls: unsupported dtype {controls.dtype}")
    if controls.dim() != 5 or tuple(controls.shape[1:3]) != (4, 3):
        raise ValueError(f"controls: expected (H, 4, 3, Bs, L), got {tuple(controls.shape)}")
    Bs = controls.shape[3]
    if Bs % n_scen:
        raise ValueError(f"{n_scen} scenarios do not divide the {Bs} candidate rows")


def rollout_traversal_plain(c: B.TLConstants, params, state: B.TLState, controls, boxes, ref,
                            target_pos, target_spd, reward_type="joystick", max_steps=1000,
                            weights: TraversalWeights = TraversalWeights(), gait_weight=1.0,
                            gait_vel_weight=0.02):
    """The kernel's plain PyTorch version (same arguments as
    rollout_traversal_fused): rollout_tasks.rollout_traversal_gait for each
    scenario's block of candidate rows. Returns the total cost (Bs, L)."""
    tab, rows, task = scenario_inputs(controls, boxes, ref, target_pos, target_spd)
    S = tab.shape[0]
    _check_launch(controls, S)
    bs = controls.shape[3] // S
    costs = []
    for k in range(S):
        ts = engine_tl.TLScene(center=tab[k, :, 0:3, None, None],
                               half=tab[k, :, 3:6, None, None],
                               active=tab[k, :, 6, None, None])
        cost, _ = rollout_tasks.rollout_traversal_gait(
            c, params, state, controls[:, :, :, k * bs:(k + 1) * bs], ts,
            _unpack_reference(rows[k]), task[k, :3], task[k, 3], reward_type, max_steps,
            weights, gait_weight, gait_vel_weight)
        costs.append(cost)
    return torch.cat(costs, dim=0)


def _launch(c, params, state, controls, boxes, ref, target_pos, target_spd, reward_type,
            max_steps, weights, gait_weight, gait_vel_weight):
    dev, dtype = controls.device, controls.dtype
    tab, rows, task = scenario_inputs(controls, boxes, ref, target_pos, target_spd)
    S, K = tab.shape[0], tab.shape[1]
    _check_launch(controls, S)
    if not controls.is_contiguous():
        raise ValueError("controls must be contiguous")
    H, Bs, L = controls.shape[0], controls.shape[3], controls.shape[4]
    n = Bs * L
    if S > 1 and (n // S) % 32:
        raise ValueError(f"{n // S} candidates per scenario: a multiple of 32 (one block) "
                         "is needed when there is more than one scenario")
    for name, x in zip(B.TLState._fields, state):
        _check(f"state.{name}", x, dev, dtype)
    _check("c.joint_offset", c.joint_offset, dev, dtype)
    st = torch.cat([x.reshape(-1) for x in state])
    if st.numel() != _STATE_LEN:
        raise ValueError(f"state: {st.numel()} values, expected {_STATE_LEN}")
    model = _packed_model(c)
    hp = host_params(params, weights, H, K, reward_type, max_steps, gait_weight,
                     gait_vel_weight)
    cost = torch.empty((Bs, L), dtype=dtype, device=dev)

    build()
    fn = (_LIB.lifelike_rollout_traversal_f64 if dtype == torch.float64
          else _LIB.lifelike_rollout_traversal_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), task.data_ptr(), tab.data_ptr(), model.data_ptr(),
                 model.numel(), st.data_ptr(), controls.data_ptr(), cost.data_ptr(), n, S,
                 hp.ctypes.data, hp.size, stream)
    if err != 0:
        raise RuntimeError(f"rollout_traversal kernel launch failed: error {err}")
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

    CUDA tensors: the hand-written kernel (counted in
    `rollout_traversal_fused.launches`). CPU tensors: the plain version
    rollout_traversal_plain."""
    _check_state(state)
    args = (c, params, state, controls, boxes, ref, target_pos, target_spd, reward_type,
            max_steps, weights, gait_weight, gait_vel_weight)
    if controls.is_cuda:
        return _launch(*args)
    if controls.device.type != "cpu":
        raise ValueError(f"unsupported device {controls.device}")
    return rollout_traversal_plain(*args)


rollout_traversal_fused.launches = 0

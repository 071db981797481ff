"""Fused MPPI rollout on the card: the CUDA counterpart of ops/rollout_pallas.

`rollout_tracking_fused` scores every MPPI candidate of a PMC tracking
solve: H control steps of the MAX quadruped (csrc/scalar_phys.cuh) from the
solve's one start state plus the 5-term tracking cost, each candidate rolled
by a group of GROUP lanes of one warp (csrc/rollout_tracking.cu).
On a CUDA tensor it launches that kernel (or raises); on a CPU tensor it runs
the kernel's plain PyTorch version, solver.rollout_tl.rollout_tracking.

The kernel is compiled at first use from the sources in csrc/ by
ops.cuda_build (plain nvcc for sm_90a, a shared library with a C ABI loaded
with ctypes, under lifelike_tpu_torch/build/ with its ptxas report).
"""
import ctypes

import numpy as np
import torch

from lifelike_tpu_torch.costs.tracking import TrackingWeights
from lifelike_tpu_torch.ops import cuda_build
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.solver import rollout_tl

KERNEL = cuda_build.Kernel("rollout_tracking.cu", ("scalar_phys.cuh",))

# packed reference row layout (lifelike_tpu/ops/rollout_pallas.py:43-52)
_OFF_TARGET = 0  # 12: joint targets the controls are deltas on
_OFF_JP = 12  # 12: reference joint_pos at t+1
_OFF_JV = 24  # 12: reference joint_vel
_OFF_FOOT = 36  # 12: reference foot positions (4 legs x 3)
_OFF_BP = 48  # 3: reference base_pos
_OFF_BO = 51  # 4: reference base_orn (xyzw)
_OFF_BLV = 55  # 3
_OFF_BAV = 58  # 3
_REF_WIDTH = 64

_STATE_LEN = 37  # TLState leaves pb 3, q 4, vb 3, wb 3, jq 12, jqd 12
_PARAM_LEN = 20
BLOCK = 32  # threads per block: one warp
GROUP = 8  # lanes per candidate (kGroup of csrc/rollout_tracking.cu)


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
    for name in ("lifelike_rollout_tracking_f32", "lifelike_rollout_tracking_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i64, ptr, i32, ptr]
        fn.restype = i32
    for name in ("lifelike_rollout_attrs_f32", "lifelike_rollout_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(i32)] * 4 + [i32]
        fn.restype = i32
    for name in ("lifelike_rollout_block_size", "lifelike_rollout_group_size",
                 "lifelike_rollout_param_len", "lifelike_rollout_model_len_f32",
                 "lifelike_rollout_model_len_f64"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if lib.lifelike_rollout_param_len() != _PARAM_LEN:
        raise RuntimeError("kernel parameter layout differs from ops/rollout_cuda.py")
    if (lib.lifelike_rollout_block_size(), lib.lifelike_rollout_group_size()) != (BLOCK, GROUP):
        raise RuntimeError("kernel block / group size differs from ops/rollout_cuda.py")
    _LIB, _BUILD = lib, info
    return _BUILD


def ptxas_summary(text):
    """ptxas registers / spills / stack of the rollout kernel's instances."""
    return cuda_build.ptxas_summary(text, "rollout_tracking_kernel")


def kernel_attributes(dtype=torch.float32, horizon=50):
    """Registers, local (spill) bytes per thread, block size, lanes per
    candidate (group), candidates per block and resident blocks per SM of the
    compiled kernel, from the CUDA runtime."""
    build()
    fn = (_LIB.lifelike_rollout_attrs_f64 if dtype == torch.float64
          else _LIB.lifelike_rollout_attrs_f32)
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = fn(*(ctypes.byref(v) for v in vals), int(horizon))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes/occupancy failed: error {err}")
    regs, local, max_threads, blocks = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local, "max_threads": max_threads,
            "block": BLOCK, "group": GROUP, "per_block": BLOCK // GROUP, "blocks_per_sm": blocks}


def pack_reference(ref: rollout_tl.RefTraj) -> torch.Tensor:
    """RefTraj (leaves (H, ...) with trailing (1, 1)) -> (H, 64) scalars."""

    def flat(x):
        return x.reshape(x.shape[0], -1)

    row = torch.cat(
        [flat(ref.target_joint), flat(ref.joint_pos), flat(ref.joint_vel),
         flat(ref.foot_pos), flat(ref.base_pos), flat(ref.base_orn),
         flat(ref.base_lin_vel), flat(ref.base_ang_vel)],
        dim=1,
    )
    pad = _REF_WIDTH - row.shape[1]
    return torch.cat([row, row.new_zeros((row.shape[0], pad))], dim=1)


def pack_model(c: B.TLConstants) -> torch.Tensor:
    """TLConstants -> the flat ModelConst<T> vector of csrc/scalar_phys.cuh."""
    ref = c.joint_offset
    arrays = [c.joint_offset, c.axis, c.axis_K, c.axis_KK, c.link_mass, c.link_com,
              c.link_inertia, c.base_com, c.base_inertia, c.foot_offset,
              c.wheel_offset, c.damping, c.friction, c.lower, c.upper, c.link_mass_rc]
    scalars = torch.tensor([c.base_mass, c.foot_radius, c.wheel_radius, c.total_mass],
                           dtype=torch.float64).to(dtype=ref.dtype, device=ref.device)
    return torch.cat([a.reshape(-1) for a in arrays] + [scalars])


def host_params(params, weights: TrackingWeights, horizon):
    """Runtime scalars of the launch as float64 (weights normalized there)."""
    w = np.asarray(tuple(weights), np.float64)
    w = w / w.sum()
    cp = params.contact
    ext = np.asarray(params.ext_force, np.float64).reshape(3)
    hp = np.array(
        [params.kp, params.kd, params.max_tau, params.foot_friction, params.dt,
         cp.kn, cp.dn, cp.v_slip, cp.fric_visc_cap, *ext, *w,
         params.substeps, max(int(params.mass_freeze), 1), horizon],
        np.float64,
    )
    return hp


def _check(name, x, device, dtype):
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {x.dtype} on {x.device}")


def _check_state(state: B.TLState):
    for name, x in zip(B.TLState._fields, state):
        if tuple(x.shape[-2:]) != (1, 1):
            raise ValueError(f"state.{name}: batch {tuple(x.shape[-2:])}, expected the "
                             "solve's one start state, batch (1, 1)")


# The MPPI controller passes the same TLConstants to every solve: the packed
# vector of the last one is kept, so a solve sends no model constants.
_PACKED_MODEL = (None, None)


def _packed_model(c: B.TLConstants) -> torch.Tensor:
    global _PACKED_MODEL
    if _PACKED_MODEL[0] is not c:
        _PACKED_MODEL = (c, pack_model(c).contiguous())
    return _PACKED_MODEL[1]


def _launch(c, params, state: B.TLState, controls, ref, weights):
    dev, dtype = controls.device, controls.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"controls: unsupported dtype {dtype}")
    if controls.dim() != 5 or tuple(controls.shape[1:3]) != (4, 3):
        raise ValueError(f"controls: expected (H, 4, 3, Bs, L), got {tuple(controls.shape)}")
    if not controls.is_contiguous():
        raise ValueError("controls must be contiguous")
    H, Bs, L = controls.shape[0], controls.shape[3], controls.shape[4]
    for name, x in zip(rollout_tl.RefTraj._fields, ref):
        if x.device != dev:
            raise ValueError(f"ref.{name}: on {x.device}, controls on {dev}")
        if x.shape[0] != H:
            raise ValueError(f"ref.{name}: horizon {x.shape[0]} != controls' {H}")
    for name, x in zip(B.TLState._fields, state):
        _check(f"state.{name}", x, dev, dtype)
    _check("c.joint_offset", c.joint_offset, dev, dtype)

    st = torch.cat([x.reshape(-1) for x in state])
    if st.numel() != _STATE_LEN:
        raise ValueError(f"state: {st.numel()} values, expected {_STATE_LEN}")
    # the clip's float32 finite differences may sit beside float64 poses in
    # `ref`; the packed rows take the controls' dtype
    ref_packed = pack_reference(ref).to(dtype).contiguous()
    model = _packed_model(c)
    hp = host_params(params, weights, H)
    cost = torch.empty((Bs, L), dtype=dtype, device=dev)

    build()
    fn = (_LIB.lifelike_rollout_tracking_f64 if dtype == torch.float64
          else _LIB.lifelike_rollout_tracking_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ref_packed.data_ptr(), model.data_ptr(), model.numel(), st.data_ptr(),
                 controls.data_ptr(), cost.data_ptr(), Bs * L, hp.ctypes.data, hp.size,
                 stream)
    if err != 0:
        raise RuntimeError(f"rollout_tracking kernel launch failed: error {err}")
    rollout_tracking_fused.launches += 1
    return cost


def rollout_tracking_fused(c: B.TLConstants, params, state: B.TLState, controls,
                           ref: rollout_tl.RefTraj,
                           weights: TrackingWeights = TrackingWeights()):
    """Total tracking cost (Bs, L) of the candidates `controls`
    (H, 4, 3, Bs, L) — joint-target deltas on ref.target_joint — all rolled
    from the one start state `state` (TLState with batch (1, 1)).

    CUDA tensors: the hand-written kernel (counted in
    `rollout_tracking_fused.launches`). CPU tensors: the plain version
    rollout_tl.rollout_tracking."""
    _check_state(state)
    if controls.is_cuda:
        return _launch(c, params, state, controls, ref, weights)
    if controls.device.type != "cpu":
        raise ValueError(f"unsupported device {controls.device}")
    return rollout_tl.rollout_tracking(c, params, state, controls, ref,
                                       weights=weights)[0]


rollout_tracking_fused.launches = 0

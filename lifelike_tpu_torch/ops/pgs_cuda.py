"""Projected Gauss-Seidel sweep on the card: the CUDA counterpart of
ops/pgs_pallas (K5).

`pgs_sweep` runs the hard-contact plant's impulse solve (physics/impulse.py):
`iterations` in-order sweeps over the n_rows contact and joint rows of every
batch element (robot). On a CUDA tensor it launches the kernel
csrc/pgs_sweep.cu (or raises); on a CPU tensor it runs the kernel's plain
PyTorch version, `pgs_sweep_plain`. Unlike the TPU kernel it takes any batch
shape, the 60-row flat and the 129-row box-scene systems, the friction map
`mu_idx` as an argument and a per-element `mu`, so nothing on the card falls
back to the plain version.

The sweep is a chain of dependent row updates per robot, so the kernel is
bound by latency: it runs each robot on a group of `group()` lanes of a
one-warp block (a butterfly of shuffles for each row's dot), with the
robot's rows staged in shared memory once per call. It reads the tensors in
the layout the plant builds them (the robot's rows together, the batch
first), so the wrapper only flattens the batch: on the plant's contiguous
tensors it copies nothing, and a scalar `mu` goes to the kernel by value.

The kernel is compiled at first use from csrc/pgs_sweep.cu by ops.cuda_build
(plain nvcc for sm_90a, a shared library with a C ABI loaded with ctypes,
under lifelike_tpu_torch/build/ with its ptxas report).
"""
import ctypes
import math

import torch

from lifelike_tpu_torch.ops import cuda_build

KERNEL = cuda_build.Kernel("pgs_sweep.cu", ())
NV = 18
ROW_COUNTS = (60, 129)  # the flat-ground and the box-scene systems

_LIB = None
_BUILD = None


def build() -> cuda_build.BuildInfo:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _LIB, _BUILD
    if _LIB is not None:
        return _BUILD
    info = cuda_build.build(KERNEL)
    lib = ctypes.CDLL(info.path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("lifelike_pgs_sweep_f32", "lifelike_pgs_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 12 + [i32, i32, i32, i32, ctypes.c_double, ptr]
        fn.restype = i32
    for name in ("lifelike_pgs_attrs_f32", "lifelike_pgs_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(i32)] * 5 + [i32]
        fn.restype = i32
    for name in ("lifelike_pgs_block_size", "lifelike_pgs_group", "lifelike_pgs_robots_per_block"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    _LIB, _BUILD = lib, info
    return _BUILD


def ptxas_summary(text):
    """ptxas registers / spills / stack of the sweep kernel's instances."""
    return cuda_build.ptxas_summary(text, "pgs_sweep_kernel")


def kernel_attributes(dtype=torch.float32, n_rows=60):
    """Registers, local bytes per thread, block size, lanes per robot, robots
    per block, dynamic shared memory and resident blocks per SM of the
    compiled instance, from the CUDA runtime."""
    build()
    fn = _LIB.lifelike_pgs_attrs_f64 if dtype == torch.float64 else _LIB.lifelike_pgs_attrs_f32
    vals = [ctypes.c_int(0) for _ in range(5)]
    err = fn(*(ctypes.byref(v) for v in vals), int(n_rows))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes/occupancy failed: error {err}")
    regs, local, max_threads, blocks, smem = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local, "max_threads": max_threads,
            "block": _LIB.lifelike_pgs_block_size(), "group": _LIB.lifelike_pgs_group(),
            "per_block": _LIB.lifelike_pgs_robots_per_block(), "shared_bytes": smem,
            "blocks_per_sm": blocks}


def pgs_sweep_plain(v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, iterations=10):
    """The row loop of physics/impulse.py::_pgs in PyTorch.

    v (..., 18): free velocity after the warm-start impulses; lam0, d, b,
    lo, hi (..., n_rows); J, MinvJT (..., n_rows, 18); mu a scalar or one
    value per element; mu_idx (n_rows,) the row of the normal impulse that
    bounds each friction row (-1: the row's own [lo, hi]). Returns (v, lam).
    """
    mu = torch.as_tensor(mu, dtype=v.dtype, device=v.device)
    Jr, Mr = J.unbind(-2), MinvJT.unbind(-2)
    dr = torch.clamp_min(d, 1e-12).unbind(-1)
    br, lor, hir = b.unbind(-1), lo.unbind(-1), hi.unbind(-1)
    idx = torch.as_tensor(mu_idx, device="cpu").tolist()
    lam = list(lam0.unbind(-1))
    for _ in range(iterations):
        for i, k in enumerate(idx):
            # lam_i + (b_i - J_i . v) / d_i, clamped: max with lo first
            new = torch.addcdiv(lam[i], br[i] - torch.linalg.vecdot(Jr[i], v), dr[i])
            if k >= 0:
                hi_i = mu * torch.clamp_min(lam[k], 0.0)
                new = torch.clamp(new, -hi_i, hi_i)
            else:
                new = torch.clamp(new, lor[i], hir[i])
            v = torch.addcmul(v, Mr[i], (new - lam[i])[..., None])
            lam[i] = new
    return v, torch.stack(lam, dim=-1)


def _check(name, x, shape, device, dtype):
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _launch(v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, iterations):
    dev, dtype = v.device, v.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"v: unsupported dtype {dtype}")
    batch, n_rows = tuple(v.shape[:-1]), J.shape[-2]
    if n_rows not in ROW_COUNTS:
        raise ValueError(f"J: {n_rows} rows; the kernel is built for {ROW_COUNTS}")
    _check("v", v, batch + (NV,), dev, dtype)
    for name, x in (("J", J), ("MinvJT", MinvJT)):
        _check(name, x, batch + (n_rows, NV), dev, dtype)
    for name, x in (("lam0", lam0), ("d", d), ("b", b), ("lo", lo), ("hi", hi)):
        _check(name, x, batch + (n_rows,), dev, dtype)
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"iterations: {iterations} < 0")
    n = math.prod(batch)
    if n == 0:
        return v.clone(), lam0.clone()
    if not torch.is_tensor(mu_idx):
        raise ValueError("mu_idx: expected an int32 tensor (physics.impulse.friction_map)")
    _check("mu_idx", mu_idx, (n_rows,), dev, torch.int32)
    # mu: by value when it is a number (or on the CPU), else read on the card,
    # one value (stride 0) or one per robot (stride 1)
    mu_ptr, mu_stride, mu_val = None, 0, 0.0
    if not torch.is_tensor(mu) or (mu.numel() == 1 and not mu.is_cuda):
        mu_val = float(mu)
    elif mu.numel() == 1:
        mu_ptr = mu.to(device=dev, dtype=dtype)
    else:
        mu_ptr = torch.broadcast_to(mu.to(device=dev, dtype=dtype), batch).contiguous()
        mu_stride = 1

    # a contiguous (*batch, ...) tensor is laid out as (n, ...): the plant's
    # tensors go to the kernel as they are
    args = [x.contiguous() for x in (v, lam0, J, MinvJT, d, b, lo, hi)]
    v_out = torch.empty(batch + (NV,), dtype=dtype, device=dev)
    lam_out = torch.empty(batch + (n_rows,), dtype=dtype, device=dev)
    build()
    fn = _LIB.lifelike_pgs_sweep_f64 if dtype == torch.float64 else _LIB.lifelike_pgs_sweep_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in args), None if mu_ptr is None else mu_ptr.data_ptr(),
                 mu_idx.contiguous().data_ptr(), v_out.data_ptr(), lam_out.data_ptr(), n, n_rows,
                 iterations, mu_stride, mu_val, stream)
    if err != 0:
        raise RuntimeError(f"pgs_sweep kernel launch failed: error {err}")
    pgs_sweep.launches += 1
    return v_out, lam_out


def pgs_sweep(v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, iterations=10):
    """`iterations` projected Gauss-Seidel sweeps, rows in order; arguments
    as pgs_sweep_plain. Returns (v, lam).

    CUDA tensors: the hand-written kernel (counted in `pgs_sweep.launches`);
    mu_idx is then an int32 tensor of n_rows entries in [-1, n_rows) on the
    same device, as physics.impulse.friction_map keeps it. CPU tensors: the
    plain version pgs_sweep_plain."""
    if v.is_cuda:
        return _launch(v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, iterations)
    if v.device.type != "cpu":
        raise ValueError(f"unsupported device {v.device}")
    return pgs_sweep_plain(v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, iterations)


pgs_sweep.launches = 0

"""Riccati backward sweep on the card: the CUDA counterpart of
solver/riccati_pallas (K6).

The iLQR backward pass factorizes the block-banded KKT system of the
horizon LQ subproblem (horizon H, state n = 37, control m = 12 blocks) by
backward recursion. `riccati_sweep` runs it for S scenarios: on a CUDA
tensor it launches the hand-written kernel csrc/riccati_sweep.cu, or
raises; on a CPU tensor it runs the plain PyTorch version,
`riccati_sweep_plain` (a reverse loop with torch.linalg.solve, the port of
riccati_sweep_ref).

The sweep is H dependent steps of small products per scenario, so the
kernel is bound by latency and by one SM's FP64 rate: one thread block per
scenario keeps the value function and the step's blocks in shared memory,
computes the products as 16 x 8 tiles on the FP64 tensor cores, solves for
the gains on one warp (Gauss-Jordan with diagonal pivots, the pivot column
broadcast by shuffles) while the other warps compute Qxx, and fetches the
next step's inputs while the current step runs.

The kernel is compiled at first use by ops.cuda_build (plain nvcc for
sm_90a, a shared library with a C ABI loaded with ctypes, under
lifelike_tpu_torch/build/ with its ptxas report).
"""
import ctypes

import torch

from lifelike_tpu_torch.ops import cuda_build

KERNEL = cuda_build.Kernel("riccati_sweep.cu", ())
N, M = 37, 12  # the kernel's state and control dimensions

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
    for name in ("lifelike_riccati_sweep_f32", "lifelike_riccati_sweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32, i32, ctypes.c_double, ptr]
        fn.restype = i32
    for name in ("lifelike_riccati_attrs_f32", "lifelike_riccati_attrs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(i32)] * 5
        fn.restype = i32
    lib.lifelike_riccati_block_size.argtypes = []
    lib.lifelike_riccati_block_size.restype = i32
    _LIB, _BUILD = lib, info
    return _BUILD


def ptxas_summary(text):
    """ptxas registers / spills / stack of the sweep kernel's instances."""
    return cuda_build.ptxas_summary(text, "riccati_sweep_kernel")


def kernel_attributes(dtype=torch.float32):
    """Registers, local bytes per thread, block size, dynamic shared memory
    and resident blocks per SM of the compiled instance, from the CUDA
    runtime."""
    build()
    fn = (_LIB.lifelike_riccati_attrs_f64 if dtype == torch.float64
          else _LIB.lifelike_riccati_attrs_f32)
    vals = [ctypes.c_int(0) for _ in range(5)]
    err = fn(*(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes/occupancy failed: error {err}")
    regs, local, max_threads, blocks, smem = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local, "max_threads": max_threads,
            "block": _LIB.lifelike_riccati_block_size(), "shared_bytes": smem,
            "blocks_per_sm": blocks}


def _promote(*xs):
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return [x.to(dtype) for x in xs]


def riccati_sweep_plain(A, Bm, cx, cu, Cxx, Cuu, reg=1e-3):
    """The recursion in PyTorch, all scenarios at once: A (S, H, n, n), Bm
    (S, H, n, m), cx (S, H, n), cu (S, H, m), Cxx (S, H, n, n), Cuu
    (S, H, m, m). Returns (ks (S, H, m), Ks (S, H, m, n))."""
    A, Bm, cx, cu, Cxx, Cuu = _promote(A, Bm, cx, cu, Cxx, Cuu)
    S, H, n, _ = A.shape
    m = Bm.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    Vx = A.new_zeros((S, n, 1))
    Vxx = A.new_zeros((S, n, n))
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        At, Bt = A[:, t], Bm[:, t]
        AtT, BtT = At.mT, Bt.mT
        Qx = cx[:, t, :, None] + AtT @ Vx
        Qu = cu[:, t, :, None] + BtT @ Vx
        Qxx = Cxx[:, t] + AtT @ Vxx @ At
        Quu = Cuu[:, t] + BtT @ Vxx @ Bt + reg * eye
        Quu = 0.5 * (Quu + Quu.mT)
        Qux = BtT @ Vxx @ At
        k = -torch.linalg.solve(Quu, Qu)
        K = -torch.linalg.solve(Quu, Qux)
        Vx = Qx + K.mT @ (Quu @ k + Qu) + Qux.mT @ k
        Vxx = Qxx + K.mT @ (Quu @ K + Qux) + Qux.mT @ K
        Vxx = 0.5 * (Vxx + Vxx.mT)
        ks[t], Ks[t] = k[..., 0], K
    return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)


def _launch(A, Bm, cx, cu, Cxx, Cuu, reg):
    dev, dtype = A.device, A.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"A: unsupported dtype {dtype}")
    if A.dim() != 4:
        raise ValueError(f"A: expected (S, H, {N}, {N}), got {tuple(A.shape)}")
    S, H = A.shape[:2]
    shapes = {"A": (N, N), "Bm": (N, M), "cx": (N,), "cu": (M,), "Cxx": (N, N), "Cuu": (M, M)}
    args = []
    for (name, trail), x in zip(shapes.items(), (A, Bm, cx, cu, Cxx, Cuu)):
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != (S, H) + trail:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {(S, H) + trail}")
        args.append(x.contiguous())
    ks = torch.empty((S, H, M), dtype=dtype, device=dev)
    Ks = torch.empty((S, H, M, N), dtype=dtype, device=dev)
    if S == 0 or H == 0:
        return ks, Ks
    build()
    fn = (_LIB.lifelike_riccati_sweep_f64 if dtype == torch.float64
          else _LIB.lifelike_riccati_sweep_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in args), ks.data_ptr(), Ks.data_ptr(), S, H, float(reg),
                 stream)
    if err != 0:
        raise RuntimeError(f"riccati_sweep kernel launch failed: error {err}")
    riccati_sweep.launches += 1
    return ks, Ks


def riccati_sweep(A, Bm, cx, cu, Cxx, Cuu, reg=1e-3):
    """Batched Riccati backward sweep; arguments as riccati_sweep_plain,
    reg a number. Returns (ks (S, H, m) feedforward, Ks (S, H, m, n)
    feedback gains).

    CUDA tensors: the hand-written kernel (counted in
    `riccati_sweep.launches`), n = 37 and m = 12, all six inputs of one
    float dtype. CPU tensors: the plain version riccati_sweep_plain."""
    if A.is_cuda:
        return _launch(A, Bm, cx, cu, Cxx, Cuu, reg)
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return riccati_sweep_plain(A, Bm, cx, cu, Cxx, Cuu, reg)


riccati_sweep.launches = 0

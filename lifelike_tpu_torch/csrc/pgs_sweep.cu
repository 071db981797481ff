// Projected Gauss-Seidel sweep of the hard-contact plant (K5).
//
// Replaces lifelike_tpu/ops/pgs_pallas.py::pgs_sweep (the Pallas kernel
// _pgs_kernel). For each robot (batch element): `iterations` sweeps over the
// rows i = 0 .. n_rows-1 of the impulse system, in order,
//
//   dl    = (b_i - J_i . v) / max(d_i, 1e-12)
//   [l,h] = [-mu max(lam_k, 0), mu max(lam_k, 0)]  with k = mu_idx[i] >= 0
//           (a friction row bounded by its contact's normal impulse, as
//           updated earlier in the same sweep), else [lo_i, hi_i]
//   new   = min(max(lam_i + dl, l), h)
//   v    += MinvJT_i (new - lam_i);  lam_i = new
//
// and writes (v, lam). The row order is the solver's semantics (parity with
// tools/bullet_oracle.py's compacted row list rests on it), so rows are
// never reordered or run in parallel. The plain PyTorch version is
// lifelike_tpu_torch/ops/pgs_cuda.py::pgs_sweep_plain (the row loop of
// physics/impulse.py::_pgs). Beyond the TPU kernel (the 60-row flat system,
// a batch that is a multiple of 128, one scalar mu): the row count is a
// template parameter (60, the flat system, or 129, the box-scene system),
// the friction map mu_idx is an argument, mu is one value or one per robot,
// and the batch is any size. float and double instances each compute in
// their own type.
//
// What bounds it on an H100: latency. A robot is one chain of iterations x
// n_rows dependent row updates (600 at the plant's 10 iterations and 60
// rows); the bytes (J, MinvJT and five row vectors, read once) and the ~80
// operations of a row update are far below what the card moves or computes
// in the time the chain takes. So the design shortens each link of the chain
// and spreads the robots over the card:
//
// - One robot per group of kGroup lanes; a block is one warp holding
//   32 / kGroup robots, so bench_impulse's B 256 runs on 64 SMs at kGroup 8.
//   A lane keeps ceil(18 / kGroup) components of v in registers. J_i . v is
//   a per-lane partial dot and a __shfl_xor_sync butterfly, after which every
//   lane of the group holds the same sum bit for bit (a + b == b + a) and
//   computes dl, the bound and the clamp alike: no divergence, no barrier.
// - A robot's rows are read from device memory once per call. The plant
//   builds each robot's J and MinvJT as one contiguous block
//   ((n, n_rows, 18)), so cp.async stages them, with 1 / max(d, 1e-12), b,
//   lo, hi and lam, in shared memory before the first sweep; every sweep
//   reads them there, all of the next row's data while this row runs. The
//   division becomes a product with the staged reciprocal.
// - lam lives in shared memory. Every lane of the group stores the same
//   value, so a later friction row could read its normal row's impulse
//   back from the lane's own store with no barrier; the last two rows'
//   impulses are kept in registers as well, so in the plant's systems
//   (each friction row one or two rows after its normal row) the bound
//   needs no store-to-load round trip either. The row loop is unrolled by
//   12, so nothing but the chain itself sits between two rows.
// - A group past the batch's end exits whole after the staging, so no
//   shuffle waits on a lane that left.
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/pgs_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

namespace lifelike {

constexpr int kGroup = 8;                          // lanes per robot: 8, 16 or 32
constexpr int kNV = 18;                            // generalized velocity: 3 angular, 3 linear, 12 joints
constexpr int kPerLane = (kNV + kGroup - 1) / kGroup;  // components of v per lane
constexpr int kRobots = 32 / kGroup;               // robots per one-warp block
static_assert(kGroup == 8 || kGroup == 16 || kGroup == 32, "kGroup: 8, 16 or 32");

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout of a block (elements of T): J and MinvJT of each
// robot, then 1 / max(d, 1e-12), b, lo, hi and lam of each robot, then
// mu_idx (int). The robots' strides are offset by a few banks so the groups
// of a warp read distinct banks.
template <typename T, int R>
struct Smem {
  static constexpr int kRowElems = R * kNV;
  static constexpr int kMatStride = round_up(kRowElems, 32) + kGroup % 32;
  static constexpr int kVecStride = round_up(R, 32) + 1;
  static constexpr int kM = kRobots * kMatStride;
  static constexpr int kD = 2 * kM;
  static constexpr int kB = kD + kRobots * kVecStride;
  static constexpr int kLo = kB + kRobots * kVecStride;
  static constexpr int kHi = kLo + kRobots * kVecStride;
  static constexpr int kLam = kHi + kRobots * kVecStride;
  static constexpr int kElems = kLam + kRobots * kVecStride;
  static constexpr int kBytes = kElems * static_cast<int>(sizeof(T)) + round_up(R * 4, 16);
};

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the lane's components k = l + kGroup * j of row i (0 past the 18th)
template <typename T>
__device__ __forceinline__ void load_row(const T* rows, int i, int l, T (&out)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = l + kGroup * j;
    out[j] = (kNV % kGroup == 0 || k < kNV) ? rows[i * kNV + k] : T(0);
  }
}

// A row's data as one lane reads it: its components of J_i and MinvJT_i,
// the friction map's entry, 1 / max(d_i, 1e-12), b_i, lo_i, hi_i and the
// impulse lam_i from the sweep before
template <typename T>
struct Row {
  T j[kPerLane], mj[kPerLane];
  T inv_d, b, lo, hi, old;
  int m;

  __device__ __forceinline__ void load(const T* J, const T* M, const int* idx, const T* inv_d_,
                                       const T* b_, const T* lo_, const T* hi_, const T* lam,
                                       int i, int l) {
    load_row(J, i, l, j);
    load_row(M, i, l, mj);
    m = idx[i];
    inv_d = inv_d_[i];
    b = b_[i];
    lo = lo_[i];
    hi = hi_[i];
    old = lam[i];
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(32)
    pgs_sweep_kernel(const T* __restrict__ v_in, const T* __restrict__ lam_in,
                     const T* __restrict__ J, const T* __restrict__ MinvJT,
                     const T* __restrict__ d, const T* __restrict__ b, const T* __restrict__ lo,
                     const T* __restrict__ hi, const T* __restrict__ mu, int mu_stride,
                     T mu_scalar, const int* __restrict__ mu_idx, T* __restrict__ v_out,
                     T* __restrict__ lam_out, int n, int iterations) {
  using L = Smem<T, R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* s_idx = reinterpret_cast<int*>(sm + L::kElems);
  const int lane = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kRobots;
  const int here = n - e0 < kRobots ? static_cast<int>(n - e0) : kRobots;

  // stage the block's robots: their J / MinvJT blocks and row vectors are
  // contiguous runs of device memory
  for (int x = lane; x < here * L::kRowElems; x += 32) {
    const int p = x / L::kRowElems, o = p * L::kMatStride + (x - p * L::kRowElems);
    cp_async(sm + o, J + e0 * L::kRowElems + x);
    cp_async(sm + L::kM + o, MinvJT + e0 * L::kRowElems + x);
  }
  for (int x = lane; x < here * R; x += 32) {
    const int p = x / R, o = p * L::kVecStride + (x - p * R);
    const long long g = e0 * R + x;
    cp_async(sm + L::kD + o, d + g);
    cp_async(sm + L::kB + o, b + g);
    cp_async(sm + L::kLo + o, lo + g);
    cp_async(sm + L::kHi + o, hi + g);
    cp_async(sm + L::kLam + o, lam_in + g);
  }
  for (int i = lane; i < R; i += 32) cp_async(s_idx + i, mu_idx + i);
  cp_async_wait_all();
  // the lane's own copies of d are visible to it now: d -> 1 / max(d, 1e-12)
  const T d_min = T(1e-12);
  for (int x = lane; x < here * R; x += 32) {
    const int p = x / R;
    T& di = sm[L::kD + p * L::kVecStride + (x - p * R)];
    di = T(1) / (di < d_min ? d_min : di);
  }
  __syncthreads();

  const int g = lane / kGroup, l = lane % kGroup;
  const long long e = e0 + g;
  if (e >= n) return;  // the whole group: its lanes share e
  const unsigned mask =
      kGroup == 32 ? 0xffffffffu : ((1u << (kGroup % 32)) - 1u) << (g * kGroup);
  const T* Jr = sm + g * L::kMatStride;
  const T* Mr = sm + L::kM + g * L::kMatStride;
  const T* inv_d = sm + L::kD + g * L::kVecStride;
  const T* sb = sm + L::kB + g * L::kVecStride;
  const T* slo = sm + L::kLo + g * L::kVecStride;
  const T* shi = sm + L::kHi + g * L::kVecStride;
  T* lam = sm + L::kLam + g * L::kVecStride;

  T v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = l + kGroup * j;
    v[j] = (kNV % kGroup == 0 || k < kNV) ? v_in[e * kNV + k] : T(0);
  }
  const T mu_e = mu != nullptr ? mu[e * mu_stride] : mu_scalar;

  // what row i reads, fetched while row i - 1 runs (before its lam store)
  Row<T> next, cur;
  next.load(Jr, Mr, s_idx, inv_d, sb, slo, shi, lam, 0, l);
  // the last two rows' new impulses: a friction row's normal row is one of
  // them in the plant's systems, so its bound needs no shared-memory round
  // trip through the store just made
  T x1 = T(0), x2 = T(0);
  int i1 = -2, i2 = -2;
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
#pragma unroll 12  // a chain of rows without the loop's overhead between them
    for (int i = 0; i < R; ++i) {
      cur = next;
      next.load(Jr, Mr, s_idx, inv_d, sb, slo, shi, lam, i + 1 < R ? i + 1 : 0, l);
      const int m = cur.m;
      T ln = m == i1 ? x1 : x2;
      if (m != i1 && m != i2) ln = lam[m < 0 ? i : m];
      T dot = T(0);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) dot += cur.j[j] * v[j];
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(mask, dot, off);
      const T dl = (cur.b - dot) * cur.inv_d;
      const T bound = mu_e * (ln < T(0) ? T(0) : ln);
      const T lo_i = m >= 0 ? -bound : cur.lo;
      const T hi_i = m >= 0 ? bound : cur.hi;
      // the order of jnp.clip / torch.clamp: max with the lower bound
      // first; an infinite bound only ever meets the clamp
      T x = cur.old + dl;
      x = x < lo_i ? lo_i : x;
      x = x > hi_i ? hi_i : x;
      const T delta = x - cur.old;
      lam[i] = x;
      x2 = x1;
      i2 = i1;
      x1 = x;
      i1 = i;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] += cur.mj[j] * delta;
    }
  }

#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = l + kGroup * j;
    if (kNV % kGroup == 0 || k < kNV) v_out[e * kNV + k] = v[j];
  }
  for (int i = l; i < R; i += kGroup) lam_out[e * R + i] = lam[i];
}

template <typename T, int R>
int set_smem() {
  static int err = -1;  // once per instance
  if (err < 0) {
    err = static_cast<int>(cudaFuncSetAttribute(
        pgs_sweep_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, R>::kBytes));
  }
  return err;
}

template <typename T, int R>
int launch_rows(const T* v, const T* lam, const T* J, const T* MinvJT, const T* d, const T* b,
                const T* lo, const T* hi, const T* mu, int mu_stride, T mu_scalar,
                const int* mu_idx, T* v_out, T* lam_out, int n, int iterations,
                cudaStream_t stream) {
  const int err = set_smem<T, R>();
  if (err != 0) return err;
  const int grid = (n + kRobots - 1) / kRobots;
  pgs_sweep_kernel<T, R><<<grid, 32, Smem<T, R>::kBytes, stream>>>(
      v, lam, J, MinvJT, d, b, lo, hi, mu, mu_stride, mu_scalar, mu_idx, v_out, lam_out, n,
      iterations);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* v, const T* lam, const T* J, const T* MinvJT, const T* d, const T* b,
           const T* lo, const T* hi, const T* mu, int mu_stride, double mu_scalar,
           const int* mu_idx, T* v_out, T* lam_out, int n, int n_rows, int iterations,
           void* stream) {
  if (n <= 0 || iterations < 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_rows) {
    case 60:
      return launch_rows<T, 60>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_stride, T(mu_scalar),
                                mu_idx, v_out, lam_out, n, iterations, s);
    case 129:
      return launch_rows<T, 129>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_stride, T(mu_scalar),
                                 mu_idx, v_out, lam_out, n, iterations, s);
    default:
      return -4;
  }
}

template <typename T, int R>
int attrs_rows(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
               int* shared_bytes) {
  int err = set_smem<T, R>();
  if (err != 0) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, pgs_sweep_kernel<T, R>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  *shared_bytes = Smem<T, R>::kBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, pgs_sweep_kernel<T, R>, 32,
                                                    Smem<T, R>::kBytes);
  return static_cast<int>(e);
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
          int* shared_bytes, int n_rows) {
  switch (n_rows) {
    case 60:
      return attrs_rows<T, 60>(num_regs, local_bytes, max_threads, blocks_per_sm, shared_bytes);
    case 129:
      return attrs_rows<T, 129>(num_regs, local_bytes, max_threads, blocks_per_sm, shared_bytes);
    default:
      return -4;
  }
}

}  // namespace lifelike

extern "C" {

int lifelike_pgs_block_size() { return 32; }
int lifelike_pgs_group() { return lifelike::kGroup; }
int lifelike_pgs_robots_per_block() { return lifelike::kRobots; }

// mu: one value per robot (mu_stride 1), one value on the device
// (mu_stride 0), or null with the value in mu_scalar
int lifelike_pgs_sweep_f32(const float* v, const float* lam, const float* J, const float* MinvJT,
                           const float* d, const float* b, const float* lo, const float* hi,
                           const float* mu, const int* mu_idx, float* v_out, float* lam_out,
                           int n, int n_rows, int iterations, int mu_stride, double mu_scalar,
                           void* stream) {
  return lifelike::launch<float>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_stride, mu_scalar,
                                 mu_idx, v_out, lam_out, n, n_rows, iterations, stream);
}

int lifelike_pgs_sweep_f64(const double* v, const double* lam, const double* J,
                           const double* MinvJT, const double* d, const double* b,
                           const double* lo, const double* hi, const double* mu,
                           const int* mu_idx, double* v_out, double* lam_out, int n, int n_rows,
                           int iterations, int mu_stride, double mu_scalar, void* stream) {
  return lifelike::launch<double>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_stride, mu_scalar,
                                  mu_idx, v_out, lam_out, n, n_rows, iterations, stream);
}

int lifelike_pgs_attrs_f32(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                           int* shared_bytes, int n_rows) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, shared_bytes,
                                n_rows);
}

int lifelike_pgs_attrs_f64(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                           int* shared_bytes, int n_rows) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm,
                                 shared_bytes, n_rows);
}

}  // extern "C"

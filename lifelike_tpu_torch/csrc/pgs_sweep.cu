// Projected Gauss-Seidel sweep of the hard-contact plant (K5).
//
// Replaces lifelike_tpu/ops/pgs_pallas.py::pgs_sweep (the Pallas kernel
// _pgs_kernel). For each batch element: `iterations` sweeps over the rows
// i = 0 .. n_rows-1 of the impulse system, in order,
//
//   dl    = (b_i - J_i . v) / max(d_i, 1e-12)
//   [l,h] = [-mu max(lam_k, 0), mu max(lam_k, 0)]  with k = mu_idx[i] >= 0
//           (a friction row bounded by its contact's normal impulse),
//           else [lo_i, hi_i]
//   new   = min(max(lam_i + dl, l), h)
//   v    += MinvJT_i (new - lam_i);  lam_i = new
//
// and writes (v, lam). The row order is the solver's semantics (parity with
// tools/bullet_oracle.py's compacted row list rests on it), so rows are
// never reordered or run in parallel. The plain PyTorch version is
// lifelike_tpu_torch/ops/pgs_cuda.py::pgs_sweep_plain (the row loop of
// physics/impulse.py::_pgs).
//
// Beyond the TPU kernel, which took the 60-row flat-ground system, a batch
// that is a multiple of 128 and one scalar mu: the row count is a template
// parameter (60, the flat system, or 129, the box-scene system), the
// friction map mu_idx is an argument, mu is one value per element and the
// batch is any size, so the plant's every configuration runs here.
//
// What bounds it on an H100: latency. Each element is one chain of
// iterations x n_rows dependent row updates (600 at the plant's 10
// iterations and 60 rows); one thread runs it, as one TPU lane did. The
// bytes (J, MinvJT and five row vectors, read once) and the ~80 operations
// per row update are far below what the card moves or computes in the time
// the chain takes. The layout is the TPU kernel's: the batch axis is last,
// so the threads of a warp read consecutive addresses. v stays in
// registers; lam, indexed through mu_idx, lives in thread-local memory
// (L1). Splitting one element over a warp (lanes over the 18 velocity
// components) and staging J / MinvJT through shared memory are later work.
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/pgs_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

namespace lifelike {

constexpr int kBlock = 128;  // threads (batch elements) per block
constexpr int kNV = 18;      // generalized velocity: 3 angular, 3 linear, 12 joints

template <typename T, int R>
__global__ void __launch_bounds__(kBlock)
    pgs_sweep_kernel(const T* __restrict__ v_in, const T* __restrict__ lam_in,
                     const T* __restrict__ J, const T* __restrict__ MinvJT,
                     const T* __restrict__ d, const T* __restrict__ b, const T* __restrict__ lo,
                     const T* __restrict__ hi, const T* __restrict__ mu,
                     const int* __restrict__ mu_idx, T* __restrict__ v_out,
                     T* __restrict__ lam_out, int n, int iterations) {
  __shared__ int s_idx[R];
  for (int i = threadIdx.x; i < R; i += blockDim.x) s_idx[i] = mu_idx[i];
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long N = n;

  T v[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) v[k] = v_in[k * N + e];
  T lam[R];
  for (int i = 0; i < R; ++i) lam[i] = lam_in[i * N + e];
  const T mu_e = mu[e];
  const T d_min = T(1e-12);

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
#pragma unroll 4
    for (int i = 0; i < R; ++i) {
      const T* Ji = J + i * kNV * N + e;
      const T* Mi = MinvJT + i * kNV * N + e;
      T dot = T(0);
#pragma unroll
      for (int k = 0; k < kNV; ++k) dot += Ji[k * N] * v[k];
      T di = d[i * N + e];
      di = di < d_min ? d_min : di;
      const T dl = (b[i * N + e] - dot) / di;
      T l, h;
      const int m = s_idx[i];
      if (m >= 0) {
        const T ln = lam[m];
        const T bound = mu_e * (ln < T(0) ? T(0) : ln);
        l = -bound;
        h = bound;
      } else {
        l = lo[i * N + e];
        h = hi[i * N + e];
      }
      // the order of jnp.clip / torch.clamp: max with the lower bound
      // first; an infinite bound only ever meets the clamp
      T x = lam[i] + dl;
      x = x < l ? l : x;
      x = x > h ? h : x;
      const T delta = x - lam[i];
      lam[i] = x;
#pragma unroll
      for (int k = 0; k < kNV; ++k) v[k] += Mi[k * N] * delta;
    }
  }

#pragma unroll
  for (int k = 0; k < kNV; ++k) v_out[k * N + e] = v[k];
  for (int i = 0; i < R; ++i) lam_out[i * N + e] = lam[i];
}

template <typename T, int R>
int launch_rows(const T* v, const T* lam, const T* J, const T* MinvJT, const T* d, const T* b,
                const T* lo, const T* hi, const T* mu, const int* mu_idx, T* v_out, T* lam_out,
                int n, int iterations, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  pgs_sweep_kernel<T, R><<<grid, kBlock, 0, stream>>>(v, lam, J, MinvJT, d, b, lo, hi, mu,
                                                       mu_idx, v_out, lam_out, n, iterations);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* v, const T* lam, const T* J, const T* MinvJT, const T* d, const T* b,
           const T* lo, const T* hi, const T* mu, const int* mu_idx, T* v_out, T* lam_out, int n,
           int n_rows, int iterations, void* stream) {
  if (n <= 0 || iterations < 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_rows) {
    case 60:
      return launch_rows<T, 60>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_idx, v_out, lam_out, n,
                                iterations, s);
    case 129:
      return launch_rows<T, 129>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_idx, v_out, lam_out, n,
                                 iterations, s);
    default:
      return -4;
  }
}

template <typename T, int R>
int attrs_rows(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, pgs_sweep_kernel<T, R>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, pgs_sweep_kernel<T, R>, kBlock,
                                                    0);
  return static_cast<int>(e);
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm, int n_rows) {
  switch (n_rows) {
    case 60:
      return attrs_rows<T, 60>(num_regs, local_bytes, max_threads, blocks_per_sm);
    case 129:
      return attrs_rows<T, 129>(num_regs, local_bytes, max_threads, blocks_per_sm);
    default:
      return -4;
  }
}

}  // namespace lifelike

extern "C" {

int lifelike_pgs_block_size() { return lifelike::kBlock; }

int lifelike_pgs_sweep_f32(const float* v, const float* lam, const float* J, const float* MinvJT,
                           const float* d, const float* b, const float* lo, const float* hi,
                           const float* mu, const int* mu_idx, float* v_out, float* lam_out,
                           int n, int n_rows, int iterations, void* stream) {
  return lifelike::launch<float>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_idx, v_out, lam_out, n,
                                 n_rows, iterations, stream);
}

int lifelike_pgs_sweep_f64(const double* v, const double* lam, const double* J,
                           const double* MinvJT, const double* d, const double* b,
                           const double* lo, const double* hi, const double* mu,
                           const int* mu_idx, double* v_out, double* lam_out, int n, int n_rows,
                           int iterations, void* stream) {
  return lifelike::launch<double>(v, lam, J, MinvJT, d, b, lo, hi, mu, mu_idx, v_out, lam_out, n,
                                  n_rows, iterations, stream);
}

int lifelike_pgs_attrs_f32(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                           int n_rows) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, n_rows);
}

int lifelike_pgs_attrs_f64(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                           int n_rows) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm, n_rows);
}

}  // extern "C"

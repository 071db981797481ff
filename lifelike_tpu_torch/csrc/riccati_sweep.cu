// Riccati backward sweep of the iLQR refinement (K6).
//
// Replaces lifelike_tpu/solver/riccati_pallas.py::riccati_sweep (the Pallas
// kernel _riccati_kernel with _backward_step and _gj_inverse). For each
// scenario s, from V_x = 0, V_xx = 0 at the horizon end and for t = H-1
// down to 0, with n = 37 state and m = 12 control dimensions:
//
//   Qx  = cx_t + A_t' Vx              Qu  = cu_t + B_t' Vx
//   Qxx = Cxx_t + A_t' (Vxx A_t)       Qux = B_t' (Vxx A_t)
//   Quu = Cuu_t + B_t' (Vxx B_t) + reg I, symmetrized
//   Quu^-1 by Gauss-Jordan elimination with diagonal pivots (Quu is
//     Levenberg-Marquardt damped: the caller folds the damping into Cuu)
//   k_t = -Quu^-1 Qu                  K_t = -Quu^-1 Qux
//   Vx  <- Qx + K_t' (Quu k_t + Qu) + Qux' k_t
//   Vxx <- Qxx + K_t' (Quu K_t + Qux) + Qux' K_t, symmetrized
//
// and writes k (S, H, m) and K (S, H, m, n). The plain PyTorch version is
// lifelike_tpu_torch/solver/riccati_cuda.py::riccati_sweep_plain (a
// reverse loop with torch.linalg.solve, the port of riccati_sweep_ref).
//
// What bounds it on an H100: latency. One sweep is H dependent steps of
// small dense products (~3.8e5 operations per step) on one scenario; at the
// MPPI->iLQR hybrid's S = 8 scenarios the card's bound is a few
// microseconds of operations and bytes, while each step's chain of products,
// the 12 pivot rounds and their barriers run one after another. The design
// keeps that chain on chip, as the TPU kernel kept it in VMEM: one thread
// block per scenario; the value function (Vx, Vxx), the step's A_t, B_t,
// Cxx_t, Cuu_t and every Q block live in shared memory (~67 KB of
// float64, as dynamic shared memory); each step's inputs are read
// from device memory once, and each product is split over the block's
// threads, one output element per thread at a time. Tensor cores, TMA and
// several scenarios per block are later work; at S = 8 the kernel uses 8 of
// the card's 132 SMs.
//
// Both instances compute in float64; the float32 one reads and writes
// float32. The hybrid loop's linearizations through stiff contact make Quu
// so ill-conditioned (B'VB ~ 1e6 beside a damping of 3e-3) that a float32
// recursion with an explicit Gauss-Jordan inverse landed 12 % of the gains'
// scale from the float64 sweep of the same inputs, where the plain float32
// LU sweep lands 1.6 % (H100 run, float32 gates in chip_smoke.py). The
// recursion is latency-bound, so the float64 arithmetic costs little.
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by solver/riccati_cuda.py); float and double instances are
// exported.

#include <cuda_runtime.h>

namespace lifelike {

constexpr int kThreads = 256;  // threads per block (one block per scenario)
constexpr int kN = 37;         // state: pos 3, quat 4, lin vel 3, ang vel 3, q 12, qd 12
constexpr int kM = 12;         // control: joint-target deltas
constexpr int kNN = kN * kN;
constexpr int kNM = kN * kM;
constexpr int kMM = kM * kM;
// shared-memory elements: Vxx, A, Qxx, W (n x n); B, VB (n x m); Qux, K,
// tK (m x n); Quu, Quu_sym, GJ M, GJ X (m x m); Vx, Qx (n); Qu, k, tk,
// pivot row of M, pivot row of X, pivot column (m)
constexpr int kSmemElems = 4 * kNN + 5 * kNM + 4 * kMM + 2 * kN + 6 * kM;
constexpr int kSmemBytes = kSmemElems * static_cast<int>(sizeof(double));

// I: the inputs' and outputs' type; T: the arithmetic's (double)
template <typename I, typename T = double>
__global__ void __launch_bounds__(kThreads)
    riccati_sweep_kernel(const I* __restrict__ A, const I* __restrict__ Bm,
                         const I* __restrict__ cx, const I* __restrict__ cu,
                         const I* __restrict__ Cxx, const I* __restrict__ Cuu,
                         I* __restrict__ ks, I* __restrict__ Ks, int H, T reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Vxx = reinterpret_cast<T*>(smem_raw);
  T* sA = Vxx + kNN;
  T* Qxx = sA + kNN;
  T* W = Qxx + kNN;  // Vxx A_t, later the unsymmetrized Vxx'
  T* sB = W + kNN;   // B_t, n x m
  T* VB = sB + kNM;  // Vxx B_t, n x m
  T* Qux = VB + kNM;  // m x n
  T* sK = Qux + kNM;  // K_t, m x n
  T* tK = sK + kNM;   // Quu K_t + Qux, m x n
  T* Quu = tK + kNM;
  T* Qs = Quu + kMM;  // symmetrized Quu
  T* Mw = Qs + kMM;   // Gauss-Jordan: M -> I
  T* Xw = Mw + kMM;   // Gauss-Jordan: I -> Quu^-1
  T* Vx = Xw + kMM;
  T* Qx = Vx + kN;
  T* Qu = Qx + kN;
  T* kk = Qu + kM;
  T* tk = kk + kM;  // Quu k_t + Qu
  T* prow = tk + kM;
  T* xrow = prow + kM;
  T* pcol = xrow + kM;

  const int tid = threadIdx.x;
  const long long s = blockIdx.x;
  for (int i = tid; i < kNN; i += kThreads) Vxx[i] = T(0);
  for (int i = tid; i < kN; i += kThreads) Vx[i] = T(0);
  __syncthreads();

  for (int t = H - 1; t >= 0; --t) {
    const long long st = s * H + t;
    // 1. the step's inputs, read once; Qxx, Quu, Qx, Qu start at the cost terms
    for (int i = tid; i < kNN; i += kThreads) {
      sA[i] = T(A[st * kNN + i]);
      Qxx[i] = T(Cxx[st * kNN + i]);
    }
    for (int i = tid; i < kNM; i += kThreads) sB[i] = T(Bm[st * kNM + i]);
    for (int i = tid; i < kMM; i += kThreads) Quu[i] = T(Cuu[st * kMM + i]);
    for (int i = tid; i < kN; i += kThreads) Qx[i] = T(cx[st * kN + i]);
    for (int i = tid; i < kM; i += kThreads) Qu[i] = T(cu[st * kM + i]);
    __syncthreads();

    // 2. W = Vxx A_t, VB = Vxx B_t
    for (int idx = tid; idx < kNN + kNM; idx += kThreads) {
      T acc = T(0);
      if (idx < kNN) {
        const int i = idx / kN, j = idx % kN;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += Vxx[i * kN + r] * sA[r * kN + j];
        W[idx] = acc;
      } else {
        const int e = idx - kNN, i = e / kM, j = e % kM;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += Vxx[i * kN + r] * sB[r * kM + j];
        VB[e] = acc;
      }
    }
    __syncthreads();

    // 3. the Q blocks
    for (int idx = tid; idx < kNN + kMM + kNM + kN + kM; idx += kThreads) {
      T acc = T(0);
      if (idx < kNN) {
        const int i = idx / kN, j = idx % kN;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += sA[r * kN + i] * W[r * kN + j];
        Qxx[idx] += acc;
      } else if (idx < kNN + kMM) {
        const int e = idx - kNN, i = e / kM, j = e % kM;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += sB[r * kM + i] * VB[r * kM + j];
        Quu[e] = Quu[e] + acc + (i == j ? reg : T(0));
      } else if (idx < kNN + kMM + kNM) {
        const int e = idx - kNN - kMM, i = e / kN, j = e % kN;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += sB[r * kM + i] * W[r * kN + j];
        Qux[e] = acc;
      } else if (idx < kNN + kMM + kNM + kN) {
        const int i = idx - kNN - kMM - kNM;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += sA[r * kN + i] * Vx[r];
        Qx[i] += acc;
      } else {
        const int i = idx - kNN - kMM - kNM - kN;
#pragma unroll 8
        for (int r = 0; r < kN; ++r) acc += sB[r * kM + i] * Vx[r];
        Qu[i] += acc;
      }
    }
    __syncthreads();

    // 4. symmetrize Quu; Gauss-Jordan starts from [Quu | I]
    for (int e = tid; e < kMM; e += kThreads) {
      const int i = e / kM, j = e % kM;
      const T q = T(0.5) * (Quu[i * kM + j] + Quu[j * kM + i]);
      Qs[e] = q;
      Mw[e] = q;
      Xw[e] = i == j ? T(1) : T(0);
    }
    __syncthreads();

    // 5. Gauss-Jordan with diagonal pivots: 12 rounds, each staging the
    // scaled pivot rows and the elimination column before the update
    for (int j = 0; j < kM; ++j) {
      if (tid < kM) {
        const T inv_p = T(1) / Mw[j * kM + j];
        prow[tid] = Mw[j * kM + tid] * inv_p;
        xrow[tid] = Xw[j * kM + tid] * inv_p;
        pcol[tid] = Mw[tid * kM + j];
      }
      __syncthreads();
      for (int e = tid; e < 2 * kMM; e += kThreads) {
        const bool on_x = e >= kMM;
        const int ee = on_x ? e - kMM : e, i = ee / kM, c = ee % kM;
        T* D = on_x ? Xw : Mw;
        const T rv = on_x ? xrow[c] : prow[c];
        D[ee] = i == j ? rv : D[ee] - pcol[i] * rv;
      }
      __syncthreads();
    }

    // 6. gains k = -Quu^-1 Qu, K = -Quu^-1 Qux
    for (int idx = tid; idx < kM + kNM; idx += kThreads) {
      T acc = T(0);
      if (idx < kM) {
#pragma unroll
        for (int r = 0; r < kM; ++r) acc += Xw[idx * kM + r] * Qu[r];
        kk[idx] = -acc;
      } else {
        const int e = idx - kM, i = e / kN, j = e % kN;
#pragma unroll
        for (int r = 0; r < kM; ++r) acc += Xw[i * kM + r] * Qux[r * kN + j];
        sK[e] = -acc;
      }
    }
    __syncthreads();

    // 7. write the gains; tk = Quu k + Qu, tK = Quu K + Qux
    for (int i = tid; i < kM; i += kThreads) ks[st * kM + i] = I(kk[i]);
    for (int i = tid; i < kNM; i += kThreads) Ks[st * kNM + i] = I(sK[i]);
    for (int idx = tid; idx < kM + kNM; idx += kThreads) {
      T acc = T(0);
      if (idx < kM) {
#pragma unroll
        for (int r = 0; r < kM; ++r) acc += Qs[idx * kM + r] * kk[r];
        tk[idx] = acc + Qu[idx];
      } else {
        const int e = idx - kM, i = e / kN, j = e % kN;
#pragma unroll
        for (int r = 0; r < kM; ++r) acc += Qs[i * kM + r] * sK[r * kN + j];
        tK[e] = acc + Qux[e];
      }
    }
    __syncthreads();

    // 8. Vx' and the unsymmetrized Vxx' (into W, free since step 3)
    for (int idx = tid; idx < kN + kNN; idx += kThreads) {
      T a = T(0), b = T(0);
      if (idx < kN) {
#pragma unroll
        for (int r = 0; r < kM; ++r) {
          a += sK[r * kN + idx] * tk[r];
          b += Qux[r * kN + idx] * kk[r];
        }
        Vx[idx] = Qx[idx] + a + b;
      } else {
        const int e = idx - kN, i = e / kN, j = e % kN;
#pragma unroll
        for (int r = 0; r < kM; ++r) {
          a += sK[r * kN + i] * tK[r * kN + j];
          b += Qux[r * kN + i] * sK[r * kN + j];
        }
        W[e] = Qxx[e] + a + b;
      }
    }
    __syncthreads();

    // 9. Vxx' symmetrized
    for (int e = tid; e < kNN; e += kThreads) {
      const int i = e / kN, j = e % kN;
      Vxx[e] = T(0.5) * (W[i * kN + j] + W[j * kN + i]);
    }
    __syncthreads();
  }
}

template <typename I>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      riccati_sweep_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

template <typename I>
int launch(const I* A, const I* Bm, const I* cx, const I* cu, const I* Cxx, const I* Cuu, I* ks,
           I* Ks, int S, int H, double reg, void* stream) {
  if (S <= 0 || H <= 0) return -3;
  const int err = set_smem<I>();
  if (err != 0) return err;
  riccati_sweep_kernel<I><<<S, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, cx, cu, Cxx, Cuu, ks, Ks, H, reg);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
          int* shared_bytes) {
  int err = set_smem<I>();
  if (err != 0) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, riccati_sweep_kernel<I>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  *shared_bytes = kSmemBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, riccati_sweep_kernel<I>,
                                                    kThreads, kSmemBytes);
  return static_cast<int>(e);
}

}  // namespace lifelike

extern "C" {

int lifelike_riccati_block_size() { return lifelike::kThreads; }

int lifelike_riccati_sweep_f32(const float* A, const float* Bm, const float* cx, const float* cu,
                               const float* Cxx, const float* Cuu, float* ks, float* Ks, int S,
                               int H, double reg, void* stream) {
  return lifelike::launch<float>(A, Bm, cx, cu, Cxx, Cuu, ks, Ks, S, H, reg, stream);
}

int lifelike_riccati_sweep_f64(const double* A, const double* Bm, const double* cx,
                               const double* cu, const double* Cxx, const double* Cuu,
                               double* ks, double* Ks, int S, int H, double reg, void* stream) {
  return lifelike::launch<double>(A, Bm, cx, cu, Cxx, Cuu, ks, Ks, S, H, reg, stream);
}

int lifelike_riccati_attrs_f32(int* num_regs, int* local_bytes, int* max_threads,
                               int* blocks_per_sm, int* shared_bytes) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, shared_bytes);
}

int lifelike_riccati_attrs_f64(int* num_regs, int* local_bytes, int* max_threads,
                               int* blocks_per_sm, int* shared_bytes) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm,
                                 shared_bytes);
}

}  // extern "C"

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
//   [k_t | K_t] = -Quu^-1 [Qu | Qux] by Gauss-Jordan elimination with
//     diagonal pivots (Quu is Levenberg-Marquardt damped: the caller folds
//     the damping into Cuu)
//   Vx  <- Qx + K_t' (Quu k_t + Qu) + Qux' k_t
//   Vxx <- Qxx + K_t' (Quu K_t + Qux) + Qux' K_t, symmetrized
//
// and writes k (S, H, m) and K (S, H, m, n). The plain PyTorch version is
// lifelike_tpu_torch/solver/riccati_cuda.py::riccati_sweep_plain (a
// reverse loop with torch.linalg.solve, the port of riccati_sweep_ref).
//
// What bounds it on an H100: latency, then one SM's FP64 rate. One sweep is
// H dependent steps of small dense products (~3.8e5 operations per step) on
// one scenario, one thread block per scenario (8 SMs at the hybrid's S 8):
// a step's products are about a microsecond of one SM's FP64 tensor cores,
// and its 12 pivot rounds are a chain. The design keeps the chain on chip,
// as the TPU kernel kept it in VMEM, and gives each phase of a step the
// parallel form the SM runs fastest:
//
// - The products go through the FP64 tensor cores, mma.sync.m16n8k4 (on
//   the H100 m8n8k4 issues at the same rate for half the work): each warp
//   owns a row or a column of 16 x 8 output tiles, accumulates them in
//   registers and reads the fragment they share once per k-step, since
//   shared-memory bandwidth is what these products run out of. The 37-wide
//   blocks are padded with zeros to 40 along the products' K (48 along
//   their rows, whose padding only ever meets output rows nothing reads),
//   the 12-wide ones to 16, so the padded products equal the unpadded
//   ones; Vx, Qx, Qu, k and tk ride as one more column of the matrices they
//   go with ([Vxx | Vx], [Qxx | Qx], [Qux | Qu], [K | k], [tK | tk]). The
//   leading dimensions (== 4 mod 16 doubles) put the lanes of a half-warp on
//   distinct banks in every fragment read.
// - The solve runs on one warp with no block barrier: each lane holds up
//   to two of the 50 columns of [Qs | Qux | Qu] (12 values each) in
//   registers, and each of the 12 pivot rounds broadcasts the pivot column
//   by __shfl_sync (the next round's before this round's second column is
//   updated). It solves for [k | K] directly; tk = Qs k + Qu and tK = Qs K +
//   Qux use the symmetrized Quu (Qs), so no inverse is formed. While warp 0
//   solves, warps 1-6 compute Qxx and Qx, which only the value-function
//   update needs, and warp 7 copies the next step's six input blocks into a
//   staging buffer with cp.async (their sizes and offsets are not multiples
//   of 16 bytes, so not with the bulk copy); after the solve the block
//   widens them into the padded float64 blocks, which the current step no
//   longer reads.
// - Five block barriers per step (from 32): V' and the inputs; the products
//   with Vxx; Quu and Qux; the gains, Qxx and the staged inputs; Quu K +
//   Qux. Vxx' is symmetrized as the next step reads it.
//
// Both instances compute in float64; the float32 one reads and writes
// float32. The hybrid loop's linearizations through stiff contact make Quu
// so ill-conditioned (B'VB ~ 1e6 beside a damping of 3e-3) that a float32
// recursion with an explicit Gauss-Jordan inverse landed 12 % of the gains'
// scale from the float64 sweep of the same inputs, where the plain float32
// LU sweep lands 1.6 % (H100 run, float32 gates in chip_smoke.py).
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by solver/riccati_cuda.py); float and double instances are
// exported.

#include <cuda_runtime.h>

namespace lifelike {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // one block per scenario
constexpr int kN = 37;                 // state: pos 3, quat 4, lin vel 3, ang vel 3, q 12, qd 12
constexpr int kM = 12;                 // control: joint-target deltas
constexpr int kNP = 40;                // n padded to whole k-steps of 4 (the products' K)
constexpr int kRP = 48;                // ... and to whole 16-row tiles (their M)
constexpr int kMP = 16;                // m padded to one 16-row tile
constexpr int kColX = 40;              // the vector column: Vx, Qx, Qu, k, tk
constexpr int kColB = 48;              // AB and X: the first column of the B block
// leading dimensions (doubles), each == 4 (mod 16)
constexpr int kSV = 52;   // V'   kRP x 48: [Vxx | Vx | 0], Vxx unsymmetrized
constexpr int kSAB = 68;  // AB   kNP x 64: [A | 0 | B | 0]; X kRP x 64: [Vxx A | Vx | 0 | Vxx B | 0]
constexpr int kSQ = 52;   // Qaug, CQ kRP x 48: [Qxx | Qx | 0], [Cxx | cx | 0];
                          // Zux, KK, TK kMP x 48: [Qux | Qu | 0], [K | k | 0], [tK | tk | 0]
constexpr int kSU = 20;   // Quu (then Qs), Cuu: kMP x kMP
constexpr int kOffV = 0;
constexpr int kOffAB = kOffV + kRP * kSV;
constexpr int kOffX = kOffAB + kNP * kSAB;
constexpr int kOffQ = kOffX + kRP * kSAB;
constexpr int kOffCQ = kOffQ + kRP * kSQ;
constexpr int kOffZ = kOffCQ + kRP * kSQ;
constexpr int kOffKK = kOffZ + kMP * kSQ;
constexpr int kOffTK = kOffKK + kMP * kSQ;
constexpr int kOffQuu = kOffTK + kMP * kSQ;
constexpr int kOffCuu = kOffQuu + kMP * kSU;
constexpr int kOffCu = kOffCuu + kMP * kSU;
constexpr int kDoubles = kOffCu + kMP;
// one step's inputs as read from device memory, in the I/O type
constexpr int kRawA = 0;
constexpr int kRawB = kRawA + kN * kN;
constexpr int kRawCx = kRawB + kN * kM;
constexpr int kRawCu = kRawCx + kN;
constexpr int kRawCxx = kRawCu + kM;
constexpr int kRawCuu = kRawCxx + kN * kN;
constexpr int kRaw = kRawCuu + kM * kM;

template <typename I>
constexpr int smem_bytes() {
  return kDoubles * 8 + (kRaw * static_cast<int>(sizeof(I)) + 15) / 16 * 16;
}

// D = A B + C on a 16 x 8 x 4 tile (the FP64 shape that runs at the
// tensor cores' full rate on sm_90; m8n8k4 runs at half of it): lane
// (g, t) = (lane / 4, lane % 4) holds a0 = A[g][t], a1 = A[g + 8][t],
// b = B[t][g] and the accumulators C[g][2t], C[g][2t + 1], C[g + 8][2t],
// C[g + 8][2t + 1]
__device__ __forceinline__ void mma_1684(double (&c)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <typename I>
__device__ __forceinline__ void cp_async(I* dst, const I* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(I) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A run of NT 16 x 8 output tiles of one product on one warp, accumulated
// in registers: tile q covers rows 16 ti(q) .. + 16 and cols 8 tj(q) .. + 8.
// init(r, c, c0, c1) gives the addends of (r, c) and (r, c + 1); a(r, k) and
// b(k, c) the operands (K = 4 KS); store(r, c, c0, c1) takes the results.
// When the tiles share their rows (kShare == kRows) each k-step reads one A
// fragment for all of them, when they share their columns (kCols) one B
// fragment: shared-memory bandwidth is what a step's products run out of.
enum Share { kRows, kCols };

template <int NT, int KS, Share kShare, class Ti, class Tj, class Init, class AOp, class BOp,
          class Store>
__device__ __forceinline__ void tiles(Ti ti, Tj tj, Init init, AOp a, BOp b, Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double acc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int r = 16 * ti(q) + g, c = 8 * tj(q) + 2 * t;
    init(r, c, acc[q][0], acc[q][1]);
    init(r + 8, c, acc[q][2], acc[q][3]);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = 4 * ks + t;
    if (kShare == kRows) {
      const int r = 16 * ti(0) + g;
      const double a0 = a(r, k), a1 = a(r + 8, k);
#pragma unroll
      for (int q = 0; q < NT; ++q) mma_1684(acc[q], a0, a1, b(k, 8 * tj(q) + g));
    } else {
      const double bv = b(k, 8 * tj(0) + g);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int r = 16 * ti(q) + g;
        mma_1684(acc[q], a(r, k), a(r + 8, k), bv);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int r = 16 * ti(q) + g, c = 8 * tj(q) + 2 * t;
    store(r, c, acc[q][0], acc[q][1]);
    store(r + 8, c, acc[q][2], acc[q][3]);
  }
}

// A block of N inputs at src, thread i of NTH its elements i + k NTH
template <int N, int NTH, typename I>
__device__ __forceinline__ void copy_in(I* dst, const I* src, int i) {
#pragma unroll
  for (int k = 0; k < (N + NTH - 1) / NTH; ++k) {
    const int x = i + k * NTH;
    if (x < N) cp_async(dst + x, src + x);
  }
}

// Step st's inputs (A, B, cx, cu, Cxx, Cuu) into the staging buffer raw,
// thread i of NTH its share; visible to the block after a barrier
template <int NTH, typename I>
__device__ __forceinline__ void fetch_step(I* raw, const I* A, const I* Bm, const I* cx,
                                           const I* cu, const I* Cxx, const I* Cuu, long long st,
                                           int i) {
  copy_in<kN * kN, NTH>(raw + kRawA, A + st * (kN * kN), i);
  copy_in<kN * kM, NTH>(raw + kRawB, Bm + st * (kN * kM), i);
  copy_in<kN, NTH>(raw + kRawCx, cx + st * kN, i);
  copy_in<kM, NTH>(raw + kRawCu, cu + st * kM, i);
  copy_in<kN * kN, NTH>(raw + kRawCxx, Cxx + st * (kN * kN), i);
  copy_in<kM * kM, NTH>(raw + kRawCuu, Cuu + st * (kM * kM), i);
  cp_async_wait_all();
}

// A staged block of N inputs, each thread its elements tid + k kThreads,
// widened into the float64 block at dst (row x / COLS, col x % COLS,
// leading dimension LD)
template <int N, int COLS, int LD, typename I>
__device__ __forceinline__ void widen_in(const I* src, double* dst, int tid) {
  constexpr int kIt = (N + kThreads - 1) / kThreads;
  I v[kIt];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int x = tid + k * kThreads;
    v[k] = x < N ? src[x] : I(0);
  }
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int x = tid + k * kThreads;
    if (x < N) dst[(x / COLS) * LD + x % COLS] = static_cast<double>(v[k]);
  }
}

// I: the inputs' and outputs' type; the arithmetic is float64
template <typename I>
__global__ void __launch_bounds__(kThreads)
    riccati_sweep_kernel(const I* __restrict__ A, const I* __restrict__ Bm,
                         const I* __restrict__ cx, const I* __restrict__ cu,
                         const I* __restrict__ Cxx, const I* __restrict__ Cuu,
                         I* __restrict__ ks, I* __restrict__ Ks, int H, double reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  double* Vp = sm + kOffV;
  double* AB = sm + kOffAB;
  double* X = sm + kOffX;
  double* Q = sm + kOffQ;
  double* CQ = sm + kOffCQ;
  double* Z = sm + kOffZ;
  double* KK = sm + kOffKK;
  double* TK = sm + kOffTK;
  double* Quu = sm + kOffQuu;
  double* Cuu_s = sm + kOffCuu;
  double* Cu_s = sm + kOffCu;
  I* raw = reinterpret_cast<I*>(sm + kDoubles);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long s0 = static_cast<long long>(blockIdx.x) * H;
  // the staged inputs, widened by the whole block into the padded blocks
  auto widen = [&]() {
    widen_in<kN * kN, kN, kSAB>(raw + kRawA, AB, tid);
    widen_in<kN * kM, kM, kSAB>(raw + kRawB, AB + kColB, tid);
    widen_in<kN, 1, kSQ>(raw + kRawCx, CQ + kColX, tid);
    widen_in<kM, 1, 1>(raw + kRawCu, Cu_s, tid);
    widen_in<kN * kN, kN, kSQ>(raw + kRawCxx, CQ, tid);
    widen_in<kM * kM, kM, kSU>(raw + kRawCuu, Cuu_s, tid);
  };

  for (int i = tid; i < kDoubles; i += kThreads) sm[i] = 0.0;  // V = 0 and every pad
  fetch_step<kThreads>(raw, A, Bm, cx, cu, Cxx, Cuu, s0 + H - 1, tid);
  __syncthreads();
  widen();
  __syncthreads();

  const auto row = [](int q) { return q; };
  for (int t = H - 1; t >= 0; --t) {
    const long long st = s0 + t;
    // 1. X = Vxx [A | 0 | B | 0] with Vxx = (V' + V'^T) / 2, 21 tiles of 16
    // x 8 over the 8 warps so that each SM sub-partition (warps w, w + 4)
    // runs 5 or 6: row tile w, column tiles 0-2 (warps 0-2); row tile 1,
    // column tiles 3, 4, 6, 7 (warp 3); row tile 2 or 0, column tiles 3-4 or
    // 6-7 (warps 4-7). X's vector column is Vx.
    auto vxx = [&](int r, int k) { return 0.5 * (Vp[r * kSV + k] + Vp[k * kSV + r]); };
    auto ab = [&](int k, int c) { return AB[k * kSAB + c]; };
    auto zero = [](int, int, double& c0, double& c1) { c0 = c1 = 0.0; };
    auto to_x = [&](int r, int c, double c0, double c1) {
      X[r * kSAB + c] = c0;
      X[r * kSAB + c + 1] = c1;
    };
    if (tid < kNP) X[tid * kSAB + kColX] = Vp[tid * kSV + kColX];
    if (warp < 3) {
      tiles<3, kNP / 4, kRows>([&](int) { return warp; }, row, zero, vxx, ab, to_x);
    } else if (warp == 3) {
      tiles<4, kNP / 4, kRows>([](int) { return 1; }, [](int q) { return q < 2 ? 3 + q : 4 + q; },
                               zero, vxx, ab, to_x);
    } else {
      const int ti = warp < 6 ? 2 : 0, tj = warp % 2 == 0 ? 3 : 6;
      tiles<2, kNP / 4, kRows>([&](int) { return ti; }, [&](int q) { return tj + q; }, zero, vxx,
                               ab, to_x);
    }
    __syncthreads();

    // 2. the rows of B', a tile per warp: [Qux | Qu] = [0 | cu] + B' [Vxx A |
    // Vx] and Quu = Cuu + reg I + B' Vxx B
    auto bt = [&](int r, int k) { return AB[k * kSAB + kColB + r]; };
    if (warp < 6) {
      tiles<1, kNP / 4, kCols>(
          row, [&](int) { return warp; },
          [&](int r, int c, double& c0, double& c1) {
            c0 = c == kColX && r < kM ? Cu_s[r] : 0.0;
            c1 = 0.0;
          },
          bt, [&](int k, int c) { return X[k * kSAB + c]; },
          [&](int r, int c, double c0, double c1) {
            Z[r * kSQ + c] = c0;
            Z[r * kSQ + c + 1] = c1;
          });
    } else {
      tiles<1, kNP / 4, kCols>(
          row, [&](int) { return warp - 6; },
          [&](int r, int c, double& c0, double& c1) {
            c0 = Cuu_s[r * kSU + c] + (r == c && r < kM ? reg : 0.0);
            c1 = Cuu_s[r * kSU + c + 1] + (r == c + 1 && r < kM ? reg : 0.0);
          },
          bt, [&](int k, int c) { return X[k * kSAB + kColB + c]; },
          [&](int r, int c, double c0, double c1) {
            Quu[r * kSU + c] = c0;
            Quu[r * kSU + c + 1] = c1;
          });
    }
    __syncthreads();

    // 3. warp 0: [k | K] = -Qs^-1 [Qu | Qux]; warps 1-6: [Qxx | Qx] =
    // [Cxx | cx] + A' [Vxx A | Vx], a column of three tiles each; warp 7:
    // the next step's inputs into the staging buffer
    if (warp == 0) {
      // column slot s of the system [Qs | Qux | Qu]: lane L holds slots L
      // and L + 32 (below 50); slot s < 12 is Qs's column s, 12 <= s < 49
      // Qux's column s - 12, slot 49 Qu
      const int q0 = lane < kM ? lane : 0, z0 = lane < kM ? 0 : lane - kM;
      const int z1 = lane + 32 < 49 ? lane + 32 - kM : kColX;
      double c0[kM], c1[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        const double qs = 0.5 * (Quu[i * kSU + q0] + Quu[q0 * kSU + i]);
        const double z = Z[i * kSQ + z0];
        c0[i] = lane < kM ? qs : z;
        c1[i] = lane < 18 ? Z[i * kSQ + z1] : 0.0;
      }
      __syncwarp();
      if (lane < kM) {  // Qs, for step 4
#pragma unroll
        for (int i = 0; i < kM; ++i) Quu[i * kSU + lane] = c0[i];
      }
      // round j: the pivot column pc (lane j's first slot), 1 / its pivot,
      // the lanes' columns eliminated; the next round's shuffles go out
      // before the second slot's update
      double pc[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) pc[i] = __shfl_sync(0xffffffffu, c0[i], 0);
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const double inv_p = 1.0 / pc[j];
        const double r0 = c0[j] * inv_p, r1 = c1[j] * inv_p;
#pragma unroll
        for (int i = 0; i < kM; ++i)
          if (i != j) c0[i] = c0[i] - pc[i] * r0;
        c0[j] = r0;
        double next[kM];
#pragma unroll
        for (int i = 0; i < kM; ++i)
          next[i] = j + 1 < kM ? __shfl_sync(0xffffffffu, c0[i], j + 1) : 0.0;
#pragma unroll
        for (int i = 0; i < kM; ++i)
          if (i != j) c1[i] = c1[i] - pc[i] * r1;
        c1[j] = r1;
#pragma unroll
        for (int i = 0; i < kM; ++i) pc[i] = next[i];
      }
      if (lane >= kM) {
#pragma unroll
        for (int i = 0; i < kM; ++i) KK[i * kSQ + z0] = -c0[i];
      }
      if (lane < 18) {
#pragma unroll
        for (int i = 0; i < kM; ++i) KK[i * kSQ + z1] = -c1[i];
      }
    } else if (warp == 7) {
      if (t > 0) fetch_step<32>(raw, A, Bm, cx, cu, Cxx, Cuu, st - 1, lane);
    } else {
      tiles<3, kNP / 4, kCols>(
          row, [&](int) { return warp - 1; },
          [&](int r, int c, double& c0, double& c1) {
            c0 = CQ[r * kSQ + c];
            c1 = CQ[r * kSQ + c + 1];
          },
          [&](int r, int k) { return AB[k * kSAB + r]; },
          [&](int k, int c) { return X[k * kSAB + c]; },
          [&](int r, int c, double c0, double c1) {
            Q[r * kSQ + c] = c0;
            Q[r * kSQ + c + 1] = c1;
          });
    }
    __syncthreads();

    // 4. [tK | tk] = Qs [K | k] + [Qux | Qu]; write the gains; widen the
    // next step's inputs (this step reads AB, CQ, Cuu and cu no more)
    if (warp < 6) {
      tiles<1, kM / 4, kCols>(
          row, [&](int) { return warp; },
          [&](int r, int c, double& c0, double& c1) {
            c0 = Z[r * kSQ + c];
            c1 = Z[r * kSQ + c + 1];
          },
          [&](int r, int k) { return Quu[r * kSU + k]; },
          [&](int k, int c) { return KK[k * kSQ + c]; },
          [&](int r, int c, double c0, double c1) {
            TK[r * kSQ + c] = c0;
            TK[r * kSQ + c + 1] = c1;
          });
    }
#pragma unroll
    for (int k = 0; k < (kM * kN + kThreads - 1) / kThreads; ++k) {
      const int x = tid + k * kThreads;
      if (x < kM * kN) Ks[st * (kM * kN) + x] = static_cast<I>(KK[(x / kN) * kSQ + x % kN]);
    }
    if (tid < kM) ks[st * kM + tid] = static_cast<I>(KK[tid * kSQ + kColX]);
    if (t == 0) break;
    widen();
    __syncthreads();

    // 5. [Vxx' | Vx'] = [Qxx | Qx] + [K; Qux]' [tK | tk; K | k], a column of
    // three tiles per warp
    if (warp < 6) {
      tiles<3, 2 * kM / 4, kCols>(
          row, [&](int) { return warp; },
          [&](int r, int c, double& c0, double& c1) {
            c0 = Q[r * kSQ + c];
            c1 = Q[r * kSQ + c + 1];
          },
          [&](int r, int k) { return k < kM ? KK[k * kSQ + r] : Z[(k - kM) * kSQ + r]; },
          [&](int k, int c) { return k < kM ? TK[k * kSQ + c] : KK[(k - kM) * kSQ + c]; },
          [&](int r, int c, double c0, double c1) {
            Vp[r * kSV + c] = c0;
            Vp[r * kSV + c + 1] = c1;
          });
    }
    __syncthreads();
  }
}

template <typename I>
int set_smem() {
  static int err = -1;  // once per instance
  if (err < 0) {
    err = static_cast<int>(cudaFuncSetAttribute(
        riccati_sweep_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<I>()));
  }
  return err;
}

template <typename I>
int launch(const I* A, const I* Bm, const I* cx, const I* cu, const I* Cxx, const I* Cuu, I* ks,
           I* Ks, int S, int H, double reg, void* stream) {
  if (S <= 0 || H <= 0) return -3;
  const int err = set_smem<I>();
  if (err != 0) return err;
  riccati_sweep_kernel<I><<<S, kThreads, smem_bytes<I>(), static_cast<cudaStream_t>(stream)>>>(
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
  *shared_bytes = smem_bytes<I>();
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, riccati_sweep_kernel<I>,
                                                    kThreads, smem_bytes<I>());
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

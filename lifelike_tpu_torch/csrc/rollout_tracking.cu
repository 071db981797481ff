// Fused MPPI candidate rollout for PMC tracking (K1, with K0 inlined).
//
// Replaces lifelike_tpu/ops/rollout_pallas.py::rollout_tracking_fused (the
// Pallas kernel _rollout_kernel) together with the physics library
// lifelike_tpu/ops/scalar_phys.py (here scalar_phys.cuh). For each of
// n = Bs*L candidates: H control steps of the MAX quadruped on
// ref.target_joint + controls[t] (each `substeps` 500 Hz substeps with mass
// factors refreshed every `mass_freeze` substeps), then foot FK and the
// 5-term exponential tracking cost + 5.0 x (fall | diverged), summed over
// the horizon. Every candidate starts from the same 37-value state (the
// MPPI solve's current state). The plain PyTorch version is
// lifelike_tpu_torch/solver/rollout_tl.py::rollout_tracking on
// physics/engine_tl.py::control_step.
//
// What bounds it on an H100: latency, not bytes or the operation rate. At
// the headline shape (population 4096, H 50, substeps 10) the kernel reads
// the 9.8 MB of controls once and writes 16 KB of costs, against roughly
// 52k scalar operations per candidate per control step and no matrix
// product anywhere, so the tensor cores have nothing to do; each
// candidate's H x substeps substeps form one dependent chain. The design is
// the chase kernels': a group of kGroup lanes of one warp rolls each
// candidate (scalar_phys.cuh substep_group, plane contact only: lane l the
// leg l at G 4, two lanes per leg splitting the foot's and the wheel's
// contact at G 8), its leg's state, kinematics and mass factors in
// registers; cross-leg sums by __shfl_sync in leg order; the 6x6 base solve
// on every lane. The tracking cost runs each lane's leg FK and joint terms
// and sums the legs in leg order. A block is one warp; lane l reads its
// leg's three control columns (candidate index fastest); the packed (H, 64)
// reference and the model constants are staged once per block in shared
// memory (~15 KB in float32 at H 50), so registers, not shared memory, set
// the residency. On the H100 kGroup 8 took 0.95x the time of kGroup 4 at
// mass_freeze 10 and the same at mass_freeze 1 (PERF.md; `chip_smoke.py
// --timing --group K1=4` builds the other).
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/rollout_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

#include "scalar_phys.cuh"

namespace lifelike {

constexpr int kGroup = 8;                       // lanes per candidate: two per leg
constexpr int kBlock = 32;                      // threads per block: one warp
constexpr int kCandPerBlock = kBlock / kGroup;  // candidates per block
constexpr int kRefWidth = 64;  // packed reference row (rollout_pallas.py:43-52)
constexpr int kOffTarget = 0;
constexpr int kOffJP = 12;
constexpr int kOffJV = 24;
constexpr int kOffFoot = 36;
constexpr int kOffBP = 48;
constexpr int kOffBO = 51;
constexpr int kOffBLV = 55;
constexpr int kOffBAV = 58;
constexpr int kParamLen = 20;  // host double parameter vector, see params_from_host

// rollout_tl.tracking_cost_step for lane g.rank of a candidate's group;
// r = packed reference row. Every lane returns the same value.
template <typename T, int G>
__device__ __forceinline__ T tracking_cost(const ModelConst<T>& M, const Params<T>& P,
                                           const Group<G>& g, const LaneState<T>& s, const T* r) {
  T Rb[3][3];
  quat_to_mat(s.q, Rb);
  T e_jp = T(0), e_jv = T(0), e_ee = T(0);
  {
    LegKin<T> k;
    leg_fk(M, g.leg, Rb, s.pb, s.vb, s.wb, s.jq, s.jqd, k);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T d = s.jq[j] - r[kOffJP + g.leg * 3 + j];
      e_jp += d * d;
      const T dv = s.jqd[j] - r[kOffJV + g.leg * 3 + j];
      e_jv += dv * dv;
      const T df = k.pf[j] - r[kOffFoot + g.leg * 3 + j];
      e_ee += df * df;
    }
  }
  e_jp = legs_sum(g, e_jp);
  e_jv = legs_sum(g, e_jv);
  e_ee = legs_sum(g, e_ee);
  T e_bp = T(0), e_lv = T(0), e_av = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T d = s.pb[i] - r[kOffBP + i];
    e_bp += d * d;
    const T dl = s.vb[i] - r[kOffBLV + i];
    e_lv += dl * dl;
    const T da = s.wb[i] - r[kOffBAV + i];
    e_av += da * da;
  }
  // relative rotation angle of ref o q^-1 (the real atan2)
  const T qinv[4] = {-s.q[0], -s.q[1], -s.q[2], s.q[3]};
  T dq[4];
  quat_mul(r + kOffBO, qinv, dq);
  const T sn = fsqrt(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2]);
  const T angle = T(2) * fatan2(sn, fabs_(dq[3]));

  const T reward = P.w[0] * fexp(T(-1.0) * e_jp) + P.w[1] * fexp(T(-0.1) * e_jv) +
                   P.w[2] * fexp(T(-40.0) * e_ee) +
                   P.w[3] * fexp(T(-20.0) * e_bp + T(-10.0) * (angle * angle)) +
                   P.w[4] * fexp(T(-2.0) * e_lv + T(-0.2) * e_av);
  const T cost = T(1) - reward;

  // fall (roll > 45 deg | pitch > 60 deg) and divergence as masked arithmetic
  const T left_z = Rb[0][2] * Rb[1][0] - Rb[1][2] * Rb[0][0];
  const bool fall = fabs_(left_z) > T(0.7071067811865476) || Rb[2][2] < T(0.5000000000000001);
  const bool diverged = e_bp > T(1) || angle > T(1);
  return cost + T(5) * ((fall || diverged) ? T(1) : T(0));
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    rollout_tracking_kernel(const T* __restrict__ ref, const T* __restrict__ model,
                            const T* __restrict__ state, const T* __restrict__ controls,
                            T* __restrict__ cost, long long n, Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_model = reinterpret_cast<T*>(smem_raw);
  T* s_ref = s_model + model_len<T>();
  for (int i = threadIdx.x; i < model_len<T>(); i += blockDim.x) s_model[i] = model[i];
  for (int i = threadIdx.x; i < P.horizon * kRefWidth; i += blockDim.x) s_ref[i] = ref[i];
  __syncthreads();

  const long long k = static_cast<long long>(blockIdx.x) * kCandPerBlock + threadIdx.x / kGroup;
  if (k >= n) return;  // the whole group: its lanes share k
  const Group<kGroup> g = make_group<kGroup>();
  const ModelConst<T>& M = *reinterpret_cast<const ModelConst<T>*>(s_model);

  LaneState<T> s;
  load_lane_state(state, g.leg, s);
  LaneFrozen<T> fr;
  T total = T(0);
#pragma unroll 1
  for (int t = 0; t < P.horizon; ++t) {
    const T* r = s_ref + t * kRefWidth;
    T target[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      target[j] = r[kOffTarget + g.leg * 3 + j] + controls[(t * 12LL + g.leg * 3 + j) * n + k];
    control_step_group<T, false, kGroup>(M, P, g, s, target, fr, nullptr, 0);
    total += tracking_cost(M, P, g, s, r);
  }
  if (g.rank == 0) cost[k] = total;
}

// hp: kp, kd, max_tau, mu, dt, kn, dn, v_slip, fric_visc_cap, ext[3],
//     w[5] (normalized in float64), substeps, mass_freeze, horizon
template <typename T>
Params<T> params_from_host(const double* hp) {
  Params<T> P;
  P.kp = T(hp[0]); P.kd = T(hp[1]); P.max_tau = T(hp[2]); P.mu = T(hp[3]); P.dt = T(hp[4]);
  P.kn = T(hp[5]); P.dn = T(hp[6]); P.v_slip2 = T(hp[7] * hp[7]); P.fric_visc_cap = T(hp[8]);
  for (int i = 0; i < 3; ++i) P.ext[i] = T(hp[9 + i]);
  for (int i = 0; i < 5; ++i) P.w[i] = T(hp[12 + i]);
  P.substeps = static_cast<int>(hp[17]);
  P.mass_freeze = static_cast<int>(hp[18]);
  P.horizon = static_cast<int>(hp[19]);
  return P;
}

template <typename T>
int launch(const T* ref, const T* model, int model_n, const T* state, const T* controls,
           T* cost, long long n, const double* hp, int hp_n, void* stream) {
  if (model_n != model_len<T>()) return -1;
  if (hp_n != kParamLen) return -2;
  const Params<T> P = params_from_host<T>(hp);
  if (n <= 0 || P.horizon <= 0 || P.substeps <= 0) return -3;
  const size_t smem = sizeof(T) * (static_cast<size_t>(model_len<T>()) +
                                   static_cast<size_t>(P.horizon) * kRefWidth);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rollout_tracking_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + kCandPerBlock - 1) / kCandPerBlock);
  rollout_tracking_kernel<T><<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      ref, model, state, controls, cost, n, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm, int horizon) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, rollout_tracking_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  const size_t smem = sizeof(T) * (static_cast<size_t>(model_len<T>()) +
                                   static_cast<size_t>(horizon) * kRefWidth);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rollout_tracking_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rollout_tracking_kernel<T>,
                                                    kBlock, smem);
  return static_cast<int>(e);
}

}  // namespace lifelike

extern "C" {

int lifelike_rollout_block_size() { return lifelike::kBlock; }
int lifelike_rollout_group_size() { return lifelike::kGroup; }
int lifelike_rollout_param_len() { return lifelike::kParamLen; }
int lifelike_rollout_model_len_f32() { return lifelike::model_len<float>(); }
int lifelike_rollout_model_len_f64() { return lifelike::model_len<double>(); }

int lifelike_rollout_tracking_f32(const float* ref, const float* model, int model_n,
                                  const float* state, const float* controls, float* cost,
                                  long long n, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<float>(ref, model, model_n, state, controls, cost, n, hp, hp_n,
                                 stream);
}

int lifelike_rollout_tracking_f64(const double* ref, const double* model, int model_n,
                                  const double* state, const double* controls, double* cost,
                                  long long n, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<double>(ref, model, model_n, state, controls, cost, n, hp, hp_n,
                                  stream);
}

int lifelike_rollout_attrs_f32(int* num_regs, int* local_bytes, int* max_threads,
                               int* blocks_per_sm, int horizon) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon);
}

int lifelike_rollout_attrs_f64(int* num_regs, int* local_bytes, int* max_threads,
                               int* blocks_per_sm, int horizon) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon);
}

}  // extern "C"

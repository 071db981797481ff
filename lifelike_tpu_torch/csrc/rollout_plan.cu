// Plan rollout for the SEPMC opponent (K3, with K0 and its box contact
// inlined).
//
// Replaces lifelike_tpu/ops/traversal_pallas.py::rollout_plan_fused (the
// Pallas kernel _plan_kernel). For each of S scenarios: H control steps of
// the MAX quadruped (scalar_phys.cuh with box contact against the
// scenario's K-box table) from the scenario's own 37-value start state on
// ref.target_joint[t] + plan[t], writing the base position after each step
// to traj (H, 3, S). In the chase solve S = 1: the opponent's current plan,
// rolled once per best-response turn, becomes the trajectory the K4
// candidates chase or flee. The plain PyTorch version is
// lifelike_tpu_torch/ops/traversal_cuda.py::rollout_plan_plain
// (solver/rollout_tasks.py::rollout_plan_gait on
// physics/engine_tl.py::control_step).
//
// What bounds it on an H100: latency. The work is one strictly sequential
// chain of H x substeps substeps per scenario (1000 at the chase plant's
// 20 substeps), about 10^5 scalar operations per control step; neither the
// card's operation rate nor its memory rate comes near to limiting it. The
// TPU kernel replicated each plan over 128 lanes and packed 8 scenarios per
// program with masks because its sequential loop costs per program; that is
// tiling, not semantics. Here each scenario is one block of one warp: its
// reference rows, box table and plan are staged in shared memory by the
// warp, then a group of kGroup = 8 lanes rolls the plan (scalar_phys.cuh
// substep_group: lanes 2l and 2l+1 hold leg l, the even one runs the
// foot's plane and box contact, the odd one the wheel's; one trunk sphere
// on each of lanes 0-5; cross-leg sums by __shfl_sync) while the other 24
// lanes exit, so the chain a lane runs is its sphere's and its leg's share
// of each substep, in registers. S plans run on S warps on separate SMs
// (the scenario sweep's 16 fit side by side). On the H100 kGroup 8 took
// 0.64-0.65x the time of kGroup 4, K4's four lanes per plan (PERF.md;
// `chip_smoke.py --timing --group K3=4` builds the other).
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/traversal_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

#include "scalar_phys.cuh"
#include "task_cost.cuh"

namespace lifelike {

constexpr int kGroup = 8;      // lanes that roll the plan (see above)
constexpr int kBlock = 32;     // threads per block: one warp, all of it staging
constexpr int kStateLen = 37;  // pb 3, q 4, vb 3, wb 3, jq 12, jqd 12
constexpr int kParamLen = 16;  // host double parameter vector, see params_from_host

template <typename T>
__global__ void __launch_bounds__(kBlock)
    rollout_plan_kernel(const T* __restrict__ ref, const T* __restrict__ boxes,
                        const T* __restrict__ model, const T* __restrict__ state,
                        const T* __restrict__ plan, T* __restrict__ traj, int n_scen, int n_boxes,
                        Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_model = reinterpret_cast<T*>(smem_raw);
  T* s_ref = s_model + model_len<T>();
  T* s_box = s_ref + P.horizon * kRefWidth;
  T* s_plan = s_box + n_boxes * kBoxWidth;
  const int scen = blockIdx.x;
  const T* g_ref = ref + static_cast<long long>(scen) * P.horizon * kRefWidth;
  const T* g_box = boxes + static_cast<long long>(scen) * n_boxes * kBoxWidth;
  const T* g_plan = plan + static_cast<long long>(scen) * P.horizon * 12;
  for (int i = threadIdx.x; i < model_len<T>(); i += blockDim.x) s_model[i] = model[i];
  for (int i = threadIdx.x; i < P.horizon * kRefWidth; i += blockDim.x) s_ref[i] = g_ref[i];
  for (int i = threadIdx.x; i < n_boxes * kBoxWidth; i += blockDim.x) s_box[i] = g_box[i];
  for (int i = threadIdx.x; i < P.horizon * 12; i += blockDim.x) s_plan[i] = g_plan[i];
  __syncthreads();
  if (threadIdx.x >= kGroup) return;

  const Group<kGroup> g = make_group<kGroup>();
  const ModelConst<T>& M = *reinterpret_cast<const ModelConst<T>*>(s_model);
  LaneState<T> s;
  load_lane_state(state + static_cast<long long>(scen) * kStateLen, g.leg, s);
  LaneFrozen<T> fr;
#pragma unroll 1
  for (int t = 0; t < P.horizon; ++t) {
    const T* r = s_ref + t * kRefWidth;
    T target[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      target[j] = r[kOffTarget + g.leg * 3 + j] + s_plan[t * 12 + g.leg * 3 + j];
    control_step_group<T, true, kGroup>(M, P, g, s, target, fr, s_box, n_boxes);
    if (g.rank == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) traj[(t * 3LL + i) * n_scen + scen] = s.pb[i];
    }
  }
}

// hp: kp, kd, max_tau, mu, dt, kn, dn, v_slip, fric_visc_cap, ext[3],
//     substeps, mass_freeze, horizon, n_boxes
template <typename T>
void params_from_host(const double* hp, Params<T>& P, int& n_boxes) {
  P.kp = T(hp[0]); P.kd = T(hp[1]); P.max_tau = T(hp[2]); P.mu = T(hp[3]); P.dt = T(hp[4]);
  P.kn = T(hp[5]); P.dn = T(hp[6]); P.v_slip2 = T(hp[7] * hp[7]); P.fric_visc_cap = T(hp[8]);
  for (int i = 0; i < 3; ++i) P.ext[i] = T(hp[9 + i]);
  for (int i = 0; i < 5; ++i) P.w[i] = T(0);  // tracking weights: unused here
  P.substeps = static_cast<int>(hp[12]);
  P.mass_freeze = static_cast<int>(hp[13]);
  P.horizon = static_cast<int>(hp[14]);
  n_boxes = static_cast<int>(hp[15]);
}

template <typename T>
size_t smem_bytes(int horizon, int n_boxes) {
  return sizeof(T) * (static_cast<size_t>(model_len<T>()) +
                      static_cast<size_t>(horizon) * (kRefWidth + 12) +
                      static_cast<size_t>(n_boxes) * kBoxWidth);
}

template <typename T>
int launch(const T* ref, const T* boxes, const T* model, int model_n, const T* state,
           const T* plan, T* traj, int n_scen, const double* hp, int hp_n, void* stream) {
  if (model_n != model_len<T>()) return -1;
  if (hp_n != kParamLen) return -2;
  Params<T> P;
  int n_boxes = 0;
  params_from_host<T>(hp, P, n_boxes);
  if (n_scen <= 0 || P.horizon <= 0 || P.substeps <= 0 || n_boxes < 0) return -3;
  const size_t smem = smem_bytes<T>(P.horizon, n_boxes);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rollout_plan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rollout_plan_kernel<T><<<n_scen, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      ref, boxes, model, state, plan, traj, n_scen, n_boxes, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm, int horizon,
          int n_boxes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, rollout_plan_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  const size_t smem = smem_bytes<T>(horizon, n_boxes);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rollout_plan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rollout_plan_kernel<T>,
                                                    kBlock, smem);
  return static_cast<int>(e);
}

}  // namespace lifelike

extern "C" {

int lifelike_plan_block_size() { return lifelike::kBlock; }
int lifelike_plan_group_size() { return lifelike::kGroup; }
int lifelike_plan_param_len() { return lifelike::kParamLen; }

int lifelike_rollout_plan_f32(const float* ref, const float* boxes, const float* model,
                              int model_n, const float* state, const float* plan, float* traj,
                              int n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<float>(ref, boxes, model, model_n, state, plan, traj, n_scen, hp, hp_n,
                                 stream);
}

int lifelike_rollout_plan_f64(const double* ref, const double* boxes, const double* model,
                              int model_n, const double* state, const double* plan, double* traj,
                              int n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<double>(ref, boxes, model, model_n, state, plan, traj, n_scen, hp,
                                  hp_n, stream);
}

int lifelike_plan_attrs_f32(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                            int horizon, int n_boxes) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                n_boxes);
}

int lifelike_plan_attrs_f64(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm,
                            int horizon, int n_boxes) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                 n_boxes);
}

}  // extern "C"

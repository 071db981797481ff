// Fused MPPI candidate rollout for SEPMC Chase Tag (K4, with K0 and its box
// contact inlined).
//
// Replaces lifelike_tpu/ops/traversal_pallas.py::rollout_chase_fused (the
// Pallas kernel _chase_kernel). For each of n = Bs*L candidates of one
// robot: H control steps of the MAX quadruped (scalar_phys.cuh, box SDF
// contact of the feet, the wheels and the six-sphere trunk proxy against the
// scenario's K-box arena table) on ref.target_joint + controls[t], each
// followed by the chase stage cost
//   chaser_m * (distance + heading to the opponent + fall)
//   + (1 - chaser_m) * (-distance to the opponent + distance to the flag + fall)
//   + posture + 0.5 x clearance (+ gait_weight x gait-prior tracking),
// summed over the horizon. The opponent's planned base position at step t
// rides the packed reference row's columns 61-62; the task row holds the
// flag's x, y and the role mask chaser_m (0 or 1), so one launch serves
// either role with no host branch. Candidates are grouped into S scenarios
// of n / S consecutive candidates, each with its own 37-value start state,
// reference rows, task row and box table (a solve of one robot passes its
// one state S times). The plain PyTorch version is
// lifelike_tpu_torch/ops/traversal_cuda.py::rollout_chase_plain
// (solver/rollout_tasks.py::rollout_chase_gait on
// physics/engine_tl.py::control_step).
//
// What bounds it on an H100: latency, not bytes or the operation rate. The
// controls are read once and the costs written once, against ~10^5 scalar
// operations per candidate per control step, and each candidate's H x
// substeps substeps form one dependent chain (1000 at the chase plant).
// The design shortens that chain and keeps it in registers: a group of
// four lanes of one warp rolls each candidate, lane l the leg l
// (scalar_phys.cuh substep_group: its kinematics, mass factors, torques,
// foot and wheel contact, RNEA bias and joint update; the six trunk
// spheres split 2, 2, 1, 1; cross-leg sums by __shfl_sync in leg order;
// the 6x6 base solve on every lane). A warp holds eight candidates and a
// block is one warp, so 2048 candidates make 256 blocks over all 132 SMs.
// Lane l reads its leg's three control columns (candidate index fastest,
// four runs of eight candidates per warp); the model constants, the
// scenario's reference rows (with the opponent's path) and its box table
// are staged once per block in shared memory; the stage cost accumulates in
// registers on every lane of the group and lane 0 writes it. The posture,
// fall, clearance and gait terms are K2's (task_cost.cuh), the joint sums
// taken per leg and then over the legs. The heading uses the atan2 of the
// trunk's forward axis, as the plain version does, not the TPU kernel's
// normalized forward vector: the two differ where that axis is vertical.
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/traversal_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

#include "scalar_phys.cuh"
#include "task_cost.cuh"

namespace lifelike {

constexpr int kGroup = 4;                       // lanes per candidate, one leg each
constexpr int kBlock = 32;                      // threads per block: one warp
constexpr int kCandPerBlock = kBlock / kGroup;  // candidates per block
constexpr int kOffOpp = 61;                     // 2: opponent base x, y at step t
constexpr int kTaskWidth = 8;                   // flag x, flag y, chaser_m, pad
constexpr int kStateLen = 37;                   // pb 3, q 4, vb 3, wb 3, jq 12, jqd 12
constexpr int kParamLen = 37;  // host double parameter vector, see params_from_host

// Chase cost settings (costs/chase.py ChaseWeights and the rollout's
// arguments).
template <typename T>
struct ChaseParams {
  T distance, heading, fall;
  T gait_weight, gait_vel_weight;
  PostureParams<T> post;
  int n_boxes;
};

// One stage of rollout_tasks.rollout_chase_gait's cost (chaser_cost_tl,
// escapee_cost_tl mixed by the role mask, posture, clearance, gait) for lane
// g.rank of a candidate's group; every lane returns the same value.
template <typename T, int G>
__device__ __forceinline__ T chase_cost(const ChaseParams<T>& W, const Group<G>& g,
                                        const LaneState<T>& s, const T* r, const T* boxes,
                                        const T* task) {
  T Rb[3][3];
  quat_to_mat(s.q, Rb);
  const T fall = fall_mask(Rb) ? T(1) : T(0);
  // chaser: distance to the opponent + heading alignment + fall
  const T dx = r[kOffOpp] - s.pb[0];
  const T dy = r[kOffOpp + 1] - s.pb[1];
  const T d_opp = fsqrt(dx * dx + dy * dy);
  const T dc = at_least(d_opp, T(1e-8));
  const T dirx = dx / dc, diry = dy / dc;
  const T yaw = fatan2(Rb[1][0], Rb[0][0]);
  const T align = fcos(yaw) * dirx + fsin(yaw) * diry;
  const T r_rot = fexp((align - T(1)) * T(2));
  const T c_ch = (W.distance * d_opp + W.heading * (T(1) - r_rot)) + W.fall * fall;
  // escapee: away from the opponent, toward the flag + fall
  const T fx = task[0] - s.pb[0];
  const T fy = task[1] - s.pb[1];
  const T d_flag = fsqrt(fx * fx + fy * fy);
  const T c_es = (-W.distance * d_opp + W.distance * d_flag) + W.fall * fall;
  const T m = task[2];
  T cost = m * c_ch + (T(1) - m) * c_es;
  cost = cost + posture_cost(W.post, g, s);
  cost = cost + T(0.5) * clearance_cost(s.pb, boxes, W.n_boxes, T(0));
  if (W.gait_weight != T(0)) cost = cost + W.gait_weight * gait_cost(g, s, r, W.gait_vel_weight);
  return cost;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    rollout_chase_kernel(const T* __restrict__ ref, const T* __restrict__ task,
                         const T* __restrict__ boxes, const T* __restrict__ model,
                         const T* __restrict__ state, const T* __restrict__ controls,
                         T* __restrict__ cost, long long n, long long per_scen, Params<T> P,
                         ChaseParams<T> W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_model = reinterpret_cast<T*>(smem_raw);
  T* s_ref = s_model + model_len<T>();
  T* s_box = s_ref + P.horizon * kRefWidth;
  // a block lies inside one scenario (the wrapper makes per_scen a multiple
  // of the block's candidates when there is more than one scenario)
  const long long first = static_cast<long long>(blockIdx.x) * kCandPerBlock;
  const long long scen = first / per_scen;
  const T* g_ref = ref + scen * P.horizon * kRefWidth;
  const T* g_box = boxes + scen * W.n_boxes * kBoxWidth;
  for (int i = threadIdx.x; i < model_len<T>(); i += blockDim.x) s_model[i] = model[i];
  for (int i = threadIdx.x; i < P.horizon * kRefWidth; i += blockDim.x) s_ref[i] = g_ref[i];
  for (int i = threadIdx.x; i < W.n_boxes * kBoxWidth; i += blockDim.x) s_box[i] = g_box[i];
  __syncthreads();

  const long long k = first + threadIdx.x / kGroup;
  if (k >= n) return;  // the whole group: its lanes share k
  const Group<kGroup> g = make_group<kGroup>();
  const ModelConst<T>& M = *reinterpret_cast<const ModelConst<T>*>(s_model);
  T tk[kTaskWidth];
#pragma unroll
  for (int i = 0; i < kTaskWidth; ++i) tk[i] = task[scen * kTaskWidth + i];

  LaneState<T> s;
  load_lane_state(state + scen * kStateLen, g.leg, s);
  LaneFrozen<T> fr;
  T total = T(0);
#pragma unroll 1
  for (int t = 0; t < P.horizon; ++t) {
    const T* r = s_ref + t * kRefWidth;
    T target[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      target[j] = r[kOffTarget + g.leg * 3 + j] + controls[(t * 12LL + g.leg * 3 + j) * n + k];
    control_step_group<T, true, kGroup>(M, P, g, s, target, fr, s_box, W.n_boxes);
    total += chase_cost(W, g, s, r, s_box, tk);
  }
  if (g.rank == 0) cost[k] = total;
}

// hp: kp, kd, max_tau, mu, dt, kn, dn, v_slip, fric_visc_cap, ext[3],
//     substeps, mass_freeze, horizon, n_boxes, distance, heading, fall,
//     height, height_min, upright, pose, gait_weight, gait_vel_weight,
//     stand[12]
template <typename T>
void params_from_host(const double* hp, Params<T>& P, ChaseParams<T>& W) {
  P.kp = T(hp[0]); P.kd = T(hp[1]); P.max_tau = T(hp[2]); P.mu = T(hp[3]); P.dt = T(hp[4]);
  P.kn = T(hp[5]); P.dn = T(hp[6]); P.v_slip2 = T(hp[7] * hp[7]); P.fric_visc_cap = T(hp[8]);
  for (int i = 0; i < 3; ++i) P.ext[i] = T(hp[9 + i]);
  for (int i = 0; i < 5; ++i) P.w[i] = T(0);  // tracking weights: unused here
  P.substeps = static_cast<int>(hp[12]);
  P.mass_freeze = static_cast<int>(hp[13]);
  P.horizon = static_cast<int>(hp[14]);
  W.n_boxes = static_cast<int>(hp[15]);
  W.distance = T(hp[16]); W.heading = T(hp[17]); W.fall = T(hp[18]);
  W.post.height = T(hp[19]); W.post.height_min = T(hp[20]); W.post.upright = T(hp[21]);
  W.post.pose = T(hp[22]); W.post.ceiling = T(0); W.post.ceiling_w = T(0);
  W.gait_weight = T(hp[23]); W.gait_vel_weight = T(hp[24]);
  for (int i = 0; i < 12; ++i) W.post.stand[i] = T(hp[25 + i]);
}

template <typename T>
size_t smem_bytes(int horizon, int n_boxes) {
  return sizeof(T) * (static_cast<size_t>(model_len<T>()) +
                      static_cast<size_t>(horizon) * kRefWidth +
                      static_cast<size_t>(n_boxes) * kBoxWidth);
}

template <typename T>
int launch(const T* ref, const T* task, const T* boxes, const T* model, int model_n,
           const T* state, const T* controls, T* cost, long long n, long long n_scen,
           const double* hp, int hp_n, void* stream) {
  if (model_n != model_len<T>()) return -1;
  if (hp_n != kParamLen) return -2;
  Params<T> P;
  ChaseParams<T> W;
  params_from_host<T>(hp, P, W);
  if (n <= 0 || P.horizon <= 0 || P.substeps <= 0 || W.n_boxes < 0) return -3;
  if (n_scen <= 0 || n % n_scen != 0) return -4;
  const long long per_scen = n / n_scen;
  if (n_scen > 1 && per_scen % kCandPerBlock != 0) return -5;
  const size_t smem = smem_bytes<T>(P.horizon, W.n_boxes);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rollout_chase_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + kCandPerBlock - 1) / kCandPerBlock);
  rollout_chase_kernel<T><<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      ref, task, boxes, model, state, controls, cost, n, per_scen, P, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm, int horizon,
          int n_boxes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, rollout_chase_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  const size_t smem = smem_bytes<T>(horizon, n_boxes);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rollout_chase_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rollout_chase_kernel<T>,
                                                    kBlock, smem);
  return static_cast<int>(e);
}

}  // namespace lifelike

extern "C" {

int lifelike_chase_block_size() { return lifelike::kBlock; }
int lifelike_chase_group_size() { return lifelike::kGroup; }
int lifelike_chase_param_len() { return lifelike::kParamLen; }

int lifelike_rollout_chase_f32(const float* ref, const float* task, const float* boxes,
                               const float* model, int model_n, const float* state,
                               const float* controls, float* cost, long long n,
                               long long n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<float>(ref, task, boxes, model, model_n, state, controls, cost, n,
                                 n_scen, hp, hp_n, stream);
}

int lifelike_rollout_chase_f64(const double* ref, const double* task, const double* boxes,
                               const double* model, int model_n, const double* state,
                               const double* controls, double* cost, long long n,
                               long long n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<double>(ref, task, boxes, model, model_n, state, controls, cost, n,
                                  n_scen, hp, hp_n, stream);
}

int lifelike_chase_attrs_f32(int* num_regs, int* local_bytes, int* max_threads,
                             int* blocks_per_sm, int horizon, int n_boxes) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                n_boxes);
}

int lifelike_chase_attrs_f64(int* num_regs, int* local_bytes, int* max_threads,
                             int* blocks_per_sm, int horizon, int n_boxes) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                 n_boxes);
}

}  // extern "C"

// Fused MPPI candidate rollout for EPMC terrain traversal (K2, with K0 and
// its box contact inlined).
//
// Replaces lifelike_tpu/ops/traversal_pallas.py::rollout_traversal_fused
// (the Pallas kernel _trav_kernel). For each of n = Bs*L candidates: H
// control steps of the MAX quadruped (scalar_phys.cuh, box SDF contact of
// the feet, the wheels and the six-sphere trunk proxy against the
// scenario's K-box table) on ref.target_joint + controls[t], each followed
// by the traversal stage cost — joystick (1 - r_vel * r_rot) or
// average-speed progress, signed-speed and heading shaping, posture, fall,
// clearance (with the crawl_gap exemption) and, when gait_weight != 0, the
// gait-prior tracking term — summed over the horizon. Every candidate
// starts from the same 37-value state. Candidates are grouped into S
// scenarios of n / S consecutive candidates; scenario s has its own packed
// reference rows (H, 64), task row (target x, y, z, speed) and box table
// (K, 8). The plain PyTorch version is
// lifelike_tpu_torch/ops/traversal_cuda.py::rollout_traversal_plain
// (solver/rollout_tasks.py::rollout_traversal_gait on
// physics/engine_tl.py::control_step).
//
// What bounds it on an H100: latency, not bytes or the operation rate. The
// controls are read once and the costs written once, against ~1.6 x 10^5
// scalar operations per candidate per control step, most of them the 14
// contact spheres x K boxes of SDF and friction arithmetic per substep, and
// each candidate's H x substeps substeps form one dependent chain. The
// design is K4's (rollout_chase.cu): a group of kGroup lanes of one warp
// rolls each candidate (scalar_phys.cuh substep_group: lane l the leg l at
// G 4; at G 8 two lanes per leg, the foot's and the wheel's box loops
// split, and the six trunk spheres one per lane), its leg's state,
// kinematics and mass factors in registers; cross-leg sums by __shfl_sync
// in leg order; the 6x6 base solve on every lane. A block is one warp, so
// 4096 candidates make 4096 / kCandPerBlock blocks over all 132 SMs. Lane
// l reads its leg's three control columns (candidate index fastest); the
// model constants, the scenario's reference rows and its box table are
// staged once per block in shared memory (~15 KB in float32 at H 50, K 8),
// so registers, not shared memory, set the residency. The stage cost
// accumulates in registers on every lane of the group and lane 0 writes
// it. The box loop stays rolled over the shared table and one sphere's
// force is summed at a time. The posture, fall, clearance and gait terms
// live in task_cost.cuh, shared with K4. On the H100 kGroup 8 took 0.65x
// the time of kGroup 4 (PERF.md; `chip_smoke.py --timing --group K2=4`
// builds the other).
//
// Built with plain nvcc into a shared library with a C ABI (loaded with
// ctypes by ops/traversal_cuda.py); float and double instances are exported.

#include <cuda_runtime.h>

#include "scalar_phys.cuh"
#include "task_cost.cuh"

namespace lifelike {

constexpr int kGroup = 8;                       // lanes per candidate: two per leg
constexpr int kBlock = 32;                      // threads per block: one warp
constexpr int kCandPerBlock = kBlock / kGroup;  // candidates per block
constexpr int kTaskWidth = 8;                   // target x, y, z, speed, pad
constexpr int kParamLen = 43;  // host double parameter vector, see params_from_host

// Traversal cost settings (costs/traversal.py TraversalWeights and the
// rollout's arguments).
template <typename T>
struct TravParams {
  T velocity, heading, clearance, fall, crawl_gap;
  T gait_weight, gait_vel_weight;
  T rot_coef;  // 0.2 / max_steps (average-speed rotation term)
  PostureParams<T> post;
  int joystick;  // 1: joystick family, 0: average-speed family
  int n_boxes;
};

// One stage of rollout_tasks.rollout_traversal_gait's cost for lane g.rank
// of a candidate's group; every lane returns the same value. last_d carries
// the average-speed family's distance from one step to the next (on every
// lane).
template <typename T, int G>
__device__ __forceinline__ T traversal_cost(const TravParams<T>& W, const Group<G>& g,
                                            const LaneState<T>& s, const T* r, const T* boxes,
                                            const T* task, T d0, T& last_d) {
  T Rb[3][3];
  quat_to_mat(s.q, Rb);
  // _direction_terms: the heading via atan2, as the plain version computes it
  const T dx = task[0] - s.pb[0];
  const T dy = task[1] - s.pb[1];
  const T tspd = task[3];
  const T d = at_least(fsqrt(dx * dx + dy * dy), T(1e-8));
  const T dirx = dx / d, diry = dy / d;
  const T spd_sg = s.vb[0] * dirx + s.vb[1] * diry;
  const T yaw = fatan2(Rb[1][0], Rb[0][0]);
  const T align = fcos(yaw) * dirx + fsin(yaw) * diry;
  const T r_rot = fexp((align - T(1)) * T(5));
  T cost;
  if (W.joystick) {
    const T r_vel = fexp(-fabs_(fabs_(spd_sg) - tspd));
    cost = T(1) - r_vel * r_rot;
  } else {
    cost = T(0.1) * ((d - last_d) / d0) - W.rot_coef * r_rot;
    last_d = d;
  }
  // dense shaping on the signed speed
  cost = cost + (W.velocity * fabs_(spd_sg - tspd) / (T(1) + tspd) +
                 W.heading * (T(1) - align));
  cost = cost + posture_cost(W.post, g, s);
  cost = cost + W.fall * (fall_mask(Rb) ? T(1) : T(0));
  cost = cost + W.clearance * clearance_cost(s.pb, boxes, W.n_boxes, W.crawl_gap);
  if (W.gait_weight != T(0)) cost = cost + W.gait_weight * gait_cost(g, s, r, W.gait_vel_weight);
  return cost;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    rollout_traversal_kernel(const T* __restrict__ ref, const T* __restrict__ task,
                             const T* __restrict__ boxes, const T* __restrict__ model,
                             const T* __restrict__ state, const T* __restrict__ controls,
                             T* __restrict__ cost, long long n, long long per_scen, Params<T> P,
                             TravParams<T> W) {
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
  load_lane_state(state, g.leg, s);
  const T d0x = tk[0] - s.pb[0];
  const T d0y = tk[1] - s.pb[1];
  const T d0 = at_least(fsqrt(d0x * d0x + d0y * d0y), T(1e-8));
  T last_d = d0;

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
    total += traversal_cost(W, g, s, r, s_box, tk, d0, last_d);
  }
  if (g.rank == 0) cost[k] = total;
}

// hp: kp, kd, max_tau, mu, dt, kn, dn, v_slip, fric_visc_cap, ext[3],
//     substeps, mass_freeze, horizon, n_boxes, joystick, rot_coef,
//     velocity, heading, clearance, fall, height, height_min, upright, pose,
//     ceiling, ceiling_w, crawl_gap, gait_weight, gait_vel_weight, stand[12]
template <typename T>
void params_from_host(const double* hp, Params<T>& P, TravParams<T>& W) {
  P.kp = T(hp[0]); P.kd = T(hp[1]); P.max_tau = T(hp[2]); P.mu = T(hp[3]); P.dt = T(hp[4]);
  P.kn = T(hp[5]); P.dn = T(hp[6]); P.v_slip2 = T(hp[7] * hp[7]); P.fric_visc_cap = T(hp[8]);
  for (int i = 0; i < 3; ++i) P.ext[i] = T(hp[9 + i]);
  for (int i = 0; i < 5; ++i) P.w[i] = T(0);  // tracking weights: unused here
  P.substeps = static_cast<int>(hp[12]);
  P.mass_freeze = static_cast<int>(hp[13]);
  P.horizon = static_cast<int>(hp[14]);
  W.n_boxes = static_cast<int>(hp[15]);
  W.joystick = static_cast<int>(hp[16]);
  W.rot_coef = T(hp[17]);
  W.velocity = T(hp[18]); W.heading = T(hp[19]); W.clearance = T(hp[20]); W.fall = T(hp[21]);
  W.post.height = T(hp[22]); W.post.height_min = T(hp[23]); W.post.upright = T(hp[24]);
  W.post.pose = T(hp[25]); W.post.ceiling = T(hp[26]); W.post.ceiling_w = T(hp[27]);
  W.crawl_gap = T(hp[28]);
  W.gait_weight = T(hp[29]); W.gait_vel_weight = T(hp[30]);
  for (int i = 0; i < 12; ++i) W.post.stand[i] = T(hp[31 + i]);
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
  TravParams<T> W;
  params_from_host<T>(hp, P, W);
  if (n <= 0 || P.horizon <= 0 || P.substeps <= 0 || W.n_boxes < 0) return -3;
  if (n_scen <= 0 || n % n_scen != 0) return -4;
  const long long per_scen = n / n_scen;
  if (n_scen > 1 && per_scen % kCandPerBlock != 0) return -5;
  const size_t smem = smem_bytes<T>(P.horizon, W.n_boxes);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rollout_traversal_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + kCandPerBlock - 1) / kCandPerBlock);
  rollout_traversal_kernel<T><<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      ref, task, boxes, model, state, controls, cost, n, per_scen, P, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int* num_regs, int* local_bytes, int* max_threads, int* blocks_per_sm, int horizon,
          int n_boxes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, rollout_traversal_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  const size_t smem = smem_bytes<T>(horizon, n_boxes);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rollout_traversal_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rollout_traversal_kernel<T>,
                                                    kBlock, smem);
  return static_cast<int>(e);
}

}  // namespace lifelike

extern "C" {

int lifelike_traversal_block_size() { return lifelike::kBlock; }
int lifelike_traversal_group_size() { return lifelike::kGroup; }
int lifelike_traversal_param_len() { return lifelike::kParamLen; }
int lifelike_traversal_model_len_f32() { return lifelike::model_len<float>(); }
int lifelike_traversal_model_len_f64() { return lifelike::model_len<double>(); }

int lifelike_rollout_traversal_f32(const float* ref, const float* task, const float* boxes,
                                   const float* model, int model_n, const float* state,
                                   const float* controls, float* cost, long long n,
                                   long long n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<float>(ref, task, boxes, model, model_n, state, controls, cost, n,
                                 n_scen, hp, hp_n, stream);
}

int lifelike_rollout_traversal_f64(const double* ref, const double* task, const double* boxes,
                                   const double* model, int model_n, const double* state,
                                   const double* controls, double* cost, long long n,
                                   long long n_scen, const double* hp, int hp_n, void* stream) {
  return lifelike::launch<double>(ref, task, boxes, model, model_n, state, controls, cost, n,
                                  n_scen, hp, hp_n, stream);
}

int lifelike_traversal_attrs_f32(int* num_regs, int* local_bytes, int* max_threads,
                                 int* blocks_per_sm, int horizon, int n_boxes) {
  return lifelike::attrs<float>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                n_boxes);
}

int lifelike_traversal_attrs_f64(int* num_regs, int* local_bytes, int* max_threads,
                                 int* blocks_per_sm, int horizon, int n_boxes) {
  return lifelike::attrs<double>(num_regs, local_bytes, max_threads, blocks_per_sm, horizon,
                                 n_boxes);
}

}  // extern "C"

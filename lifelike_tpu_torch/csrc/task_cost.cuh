// Stage-cost terms shared by the task rollout kernels (K2 rollout_traversal.cu,
// K4 rollout_chase.cu): posture, fall, clearance and the gait prior, for a
// lane of the group that rolls a candidate (the sums over the 12 joints
// taken per leg, then over the legs in leg order).
//
// Replaces the shared helpers of lifelike_tpu/ops/traversal_pallas.py
// (_posture_cost, _fall_mask, _clearance_cost and the gait-tracking block of
// _trav_kernel / _chase_kernel). Each follows its plain PyTorch version in
// lifelike_tpu_torch/solver/rollout_tasks.py (posture_cost_tl,
// rollout_tl.fall_mask_tl, clearance_cost_tl, the gait term of
// rollout_traversal_gait / rollout_chase_gait) operation for operation.
#pragma once

#include "scalar_phys.cuh"

namespace lifelike {

constexpr int kRefWidth = 64;  // packed reference row (rollout_pallas.py:43-52)
constexpr int kOffTarget = 0;  // 12: joint targets the controls are deltas on
constexpr int kOffJP = 12;     // 12: reference joint_pos
constexpr int kOffJV = 24;     // 12: reference joint_vel

// Stand prior of costs/traversal.py TraversalWeights / costs/chase.py
// ChaseWeights (ceiling = 0 for the chase weights).
template <typename T>
struct PostureParams {
  T height, height_min, upright, pose, ceiling, ceiling_w;
  T stand[12];  // costs/traversal.py STAND_POSE
};

// rollout_tasks.posture_cost_tl from the squared stand-pose error summed
// over the 12 joints: height hinge, uprightness, stand pose, crawl ceiling
template <typename T>
__device__ __forceinline__ T posture_from(const PostureParams<T>& W, const T* pb, const T* q,
                                          T pose_err) {
  const T z = pb[2];
  const T up_z = T(1) - T(2) * (q[0] * q[0] + q[1] * q[1]);
  T posture = W.height * at_least(W.height_min - z, T(0)) + W.upright * (T(1) - up_z) +
              W.pose * (pose_err / T(12));
  if (W.ceiling > T(0)) posture = posture + W.ceiling_w * at_least(z - W.ceiling, T(0));
  return posture;
}

// rollout_tasks.posture_cost_tl for lane g.rank of a group: each lane's
// leg, then the legs' sum in leg order
template <typename T, int G>
__device__ __forceinline__ T posture_cost(const PostureParams<T>& W, const Group<G>& g,
                                          const LaneState<T>& s) {
  T pose_err = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T e = s.jq[j] - leg_entry(W.stand, g.leg, j);
    pose_err += e * e;
  }
  return posture_from(W, s.pb, s.q, legs_sum(g, pose_err));
}

// rollout_tl.fall_mask_tl: roll > 45 deg or pitch > 60 deg; Rb = base rotation
template <typename T>
__device__ __forceinline__ bool fall_mask(const T Rb[3][3]) {
  const T left_z = Rb[0][2] * Rb[1][0] - Rb[1][2] * Rb[0][0];
  return fabs_(left_z) > T(0.7071067811865476) || Rb[2][2] < T(0.5000000000000001);
}

// rollout_tasks.clearance_cost_tl against the box table (margin 0.15, tall
// threshold 0.3; crawl_gap > 0 exempts boxes whose bottom clears it)
template <typename T>
__device__ __forceinline__ T clearance_cost(const T* pb, const T* boxes, int n_boxes, T crawl_gap) {
  T total = T(0);
#pragma unroll 1
  for (int b = 0; b < n_boxes; ++b) {
    const T* bx = boxes + b * kBoxWidth;
    const T ox = at_least(fabs_(pb[0] - bx[0]) - bx[3], T(0));
    const T oy = at_least(fabs_(pb[1] - bx[1]) - bx[4], T(0));
    const T horiz = fsqrt(ox * ox + oy * oy);
    T blocking = (bx[2] + bx[5]) > T(0.3) ? bx[6] : T(0);
    if (crawl_gap > T(0) && !((bx[2] - bx[5]) < crawl_gap)) blocking = T(0);
    const T pen = at_least(T(0.15) - horiz, T(0)) * blocking;
    total += pen * pen;
  }
  return total;
}

// Gait-prior tracking of one stage (without gait_weight): mean squared
// joint error + gait_vel_weight x mean squared joint-velocity error against
// the packed reference row r, for lane g.rank of a group.
template <typename T, int G>
__device__ __forceinline__ T gait_cost(const Group<G>& g, const LaneState<T>& s, const T* r,
                                       T gait_vel_weight) {
  T e_q = T(0), e_qd = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T dq = s.jq[j] - r[kOffJP + g.leg * 3 + j];
    e_q += dq * dq;
    const T dv = s.jqd[j] - r[kOffJV + g.leg * 3 + j];
    e_qd += dv * dv;
  }
  return legs_sum(g, e_q) / T(12) + gait_vel_weight * (legs_sum(g, e_qd) / T(12));
}

}  // namespace lifelike

// Scalar MAX quadruped physics for one MPPI candidate rolled by a group of
// lanes of one warp (K0).
//
// Replaces lifelike_tpu/ops/scalar_phys.py (control_step, substep,
// freeze_mass, leg_fk, leg_bias, plane_contact_force, box_forces, _chol6,
// _quat_integrate): the device-function library that the rollout kernels
// (rollout_tracking.cu, rollout_traversal.cu, rollout_plan.cu,
// rollout_chase.cu) inline. The semantics are
// those of the plain PyTorch twins lifelike_tpu_torch/physics/engine_tl.py
// and batched.py: one 500 Hz substep = leg FK, PD + passive + joint-limit
// torques, sphere-plane contact of the feet and the wheels (and, with a box
// table, the box SDF contact of the feet, the wheels and the six-sphere
// trunk proxy), RNEA bias forces, the leg-structured Schur solve (four 3x3
// leg blocks + a 6x6 base Cholesky) against mass factors refactored every
// `mass_freeze` substeps (counted from the start of each control step),
// then semi-implicit Euler with quaternion integration.
//
// Unlike the TPU library, model constants are not folded into the
// instruction stream: they arrive as a ModelConst<T> staged in shared
// memory, and the joint axes stay general (Rodrigues rotation with
// precomputed K and K^2), exactly as the twin computes them.
//
// A group of G lanes of one warp rolls one candidate (`substep_group` /
// `control_step_group`, every rollout kernel). With G = 4 lane l owns leg
// l; with G = 8 lanes 2l and 2l+1 both hold leg l and split its contact
// (the foot's sphere on the even lane, the wheel's on the odd one). A lane
// keeps its leg's kinematics, mass factors, joints and torques in
// registers, indexed by constants only; the per-leg pieces (leg_fk,
// leg_factor, leg_torques, sphere_force + add_contact, leg_bias, leg_rhs,
// leg_joint_update) run once per lane. The six trunk spheres are spread
// over the lanes. The cross-leg sums (base wrench, RNEA bias, mass
// moments, Schur correction, the legs' right-hand-side terms) go through
// __shfl_sync on the group's mask, legs 0 to 3 in order. Every lane then
// factors and solves the 6x6 base system and steps the base from the same
// values, so the lanes agree without a broadcast or a barrier.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lifelike {

// ---------------------------------------------------------------- constants

constexpr double kGravity = 9.80665;  // physics/dynamics.py GRAVITY
constexpr double kLimitK = 300.0;     // engine._LIMIT_K
constexpr double kLimitD = 2.0;       // engine._LIMIT_D
constexpr double kTgtClip = 3.0;      // engine._TGT_CLIP
constexpr double kReg = 1e-9;         // batched.factor_dynamics / chol6 reg
constexpr double kPi = 3.14159265358979323846;

// Model constants (physics/batched.py TLConstants without the trailing
// batch axes), packed by ops/rollout_cuda.py::pack_model in this order.
template <typename T>
struct ModelConst {
  T joint_offset[4][3][3];
  T axis[4][3][3];
  T axis_K[4][3][3][3];
  T axis_KK[4][3][3][3];
  T link_mass[4][3];
  T link_com[4][3][3];
  T link_inertia[4][3][3][3];
  T base_com[3];
  T base_inertia[3][3];
  T foot_offset[4][3];
  T wheel_offset[4][3];
  T damping[4][3];
  T friction[4][3];
  T lower[4][3];
  T upper[4][3];
  T link_mass_rc[4][3];
  T base_mass;
  T foot_radius;
  T wheel_radius;
  T total_mass;
};

template <typename T>
__host__ __device__ constexpr int model_len() {
  return static_cast<int>(sizeof(ModelConst<T>) / sizeof(T));
}

// Runtime PhysicsParams scalars + normalized tracking weights (kernel arg).
template <typename T>
struct Params {
  T kp, kd, max_tau, mu, dt;
  T kn, dn, v_slip2, fric_visc_cap;  // v_slip2 = v_slip**2, squared in float64
  T ext[3];
  T w[5];
  int substeps, mass_freeze, horizon;
};

// Mass-side quantities of one leg, referenced about the factors' origin
// (LaneFrozen::origin).
template <typename T>
struct LegFrozen {
  T S[3][6];       // motion subspaces [a; a x (O - p)]
  T h[3][3];       // link first moments m*(com - O)
  T Io[3][6];      // link inertia about O, symmetric (xx, xy, xz, yy, yz, zz)
  T F[3][6];       // composite inertia x subspace
  T Minv[3][3];    // inverse of the 3x3 joint block
  T FtMinv[3][6];  // Minv @ F
};

// Per-leg forward kinematics (physics/batched.py fk, one leg).
template <typename T>
struct LegKin {
  T R[3][3][3];  // world rotation per link
  T p[3][3];     // world joint origins
  T a[3][3];     // world joint axes
  T w[3][3];     // link angular velocities
  T v[3][3];     // joint-origin velocities
  T pf[3], vf[3], pw[3], vw[3];
};

// ------------------------------------------------------------- scalar math

__device__ __forceinline__ float fsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double fsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float fsin(float x) { return sinf(x); }
__device__ __forceinline__ double fsin(double x) { return sin(x); }
__device__ __forceinline__ float fcos(float x) { return cosf(x); }
__device__ __forceinline__ double fcos(double x) { return cos(x); }
__device__ __forceinline__ float ftanh(float x) { return tanhf(x); }
__device__ __forceinline__ double ftanh(double x) { return tanh(x); }
__device__ __forceinline__ float fexp(float x) { return expf(x); }
__device__ __forceinline__ double fexp(double x) { return exp(x); }
__device__ __forceinline__ float fatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double fatan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }

// torch.clamp_min / clamp_max semantics (a NaN input stays NaN)
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) { return x > hi ? hi : x; }
template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) { return at_most(at_least(x, lo), hi); }

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  return dot3(a, b) + dot3(a + 3, b + 3);
}

// o = M v for a row-major 3x3
template <typename T>
__device__ __forceinline__ void matvec3(const T M[3][3], const T* v, T* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2];
}

// symmetric 6-tuple (xx, xy, xz, yy, yz, zz) times a vector
template <typename T>
__device__ __forceinline__ void symvec(const T* S, const T* v, T* o) {
  o[0] = S[0] * v[0] + S[1] * v[1] + S[2] * v[2];
  o[1] = S[1] * v[0] + S[3] * v[1] + S[4] * v[2];
  o[2] = S[2] * v[0] + S[4] * v[1] + S[5] * v[2];
}

template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T m[3][3]) {
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  m[0][0] = T(1) - T(2) * (yy + zz); m[0][1] = T(2) * (xy - wz); m[0][2] = T(2) * (xz + wy);
  m[1][0] = T(2) * (xy + wz); m[1][1] = T(1) - T(2) * (xx + zz); m[1][2] = T(2) * (yz - wx);
  m[2][0] = T(2) * (xz - wy); m[2][1] = T(2) * (yz + wx); m[2][2] = T(1) - T(2) * (xx + yy);
}

// Hamilton product a o b (xyzw)
template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* o) {
  const T x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const T x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

template <typename T>
__device__ __forceinline__ void quat_normalize(T* q) {
  T n = fsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = at_least(n, T(1e-8));
  q[0] = q[0] / n; q[1] = q[1] / n; q[2] = q[2] / n; q[3] = q[3] / n;
}

// math/quat_tl.py integrate: q' = normalize(normalize(exp(w dt)) o q)
template <typename T>
__device__ __forceinline__ void quat_integrate(T* q, const T* w, T dt) {
  T rv[3] = {w[0] * dt, w[1] * dt, w[2] * dt};
  const T angle = fsqrt(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  const T half = T(0.5) * angle;
  const T x = half / T(kPi);  // torch.sinc(x) = sin(pi x) / (pi x)
  const T px = x * T(kPi);
  const T k = T(0.5) * (x == T(0) ? T(1) : fsin(px) / px);
  T dq[4] = {rv[0] * k, rv[1] * k, rv[2] * k, fcos(half)};
  quat_normalize(dq);
  T out[4];
  quat_mul(dq, q, out);
  quat_normalize(out);
  q[0] = out[0]; q[1] = out[1]; q[2] = out[2]; q[3] = out[3];
}

// --------------------------------------------------------------------- FK

// Leg `leg` from the base pose / velocity and its joint rows jq, jqd (3).
template <typename T>
__device__ __forceinline__ void leg_fk(const ModelConst<T>& M, int leg, const T Rb[3][3],
                                       const T* pb, const T* vb, const T* wb, const T* jq,
                                       const T* jqd, LegKin<T>& k) {
  const T* Rp = &Rb[0][0];
  const T* pp = pb;
  const T* wp = wb;
  const T* vp = vb;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T (*R)[3] = reinterpret_cast<const T (*)[3]>(Rp);
    T off[3];
    matvec3(R, M.joint_offset[leg][j], off);
    T dp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      k.p[j][i] = pp[i] + off[i];
      dp[i] = k.p[j][i] - pp[i];
    }
    T wxd[3];
    cross3(wp, dp, wxd);
#pragma unroll
    for (int i = 0; i < 3; ++i) k.v[j][i] = vp[i] + wxd[i];
    matvec3(R, M.axis[leg][j], k.a[j]);
    const T sn = fsin(jq[j]);
    const T cs = fcos(jq[j]);
    T Rj[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Rj[r][c] = T(r == c ? 1 : 0) + sn * M.axis_K[leg][j][r][c] +
                   (T(1) - cs) * M.axis_KK[leg][j][r][c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        k.R[j][r][c] = R[r][0] * Rj[0][c] + R[r][1] * Rj[1][c] + R[r][2] * Rj[2][c];
#pragma unroll
    for (int i = 0; i < 3; ++i) k.w[j][i] = wp[i] + k.a[j][i] * jqd[j];
    Rp = &k.R[j][0][0];
    pp = k.p[j];
    wp = k.w[j];
    vp = k.v[j];
  }
  T off[3], d[3], wxd[3];
  matvec3(k.R[2], M.foot_offset[leg], off);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k.pf[i] = k.p[2][i] + off[i];
    d[i] = k.pf[i] - k.p[2][i];
  }
  cross3(k.w[2], d, wxd);
#pragma unroll
  for (int i = 0; i < 3; ++i) k.vf[i] = k.v[2][i] + wxd[i];
  matvec3(k.R[1], M.wheel_offset[leg], off);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k.pw[i] = k.p[1][i] + off[i];
    d[i] = k.pw[i] - k.p[1][i];
  }
  cross3(k.w[1], d, wxd);
#pragma unroll
  for (int i = 0; i < 3; ++i) k.vw[i] = k.v[1][i] + wxd[i];
}

// --------------------------------------------------------- inertia helpers

// R I R^T for symmetric I (full 3x3 input) -> 6 unique entries
template <typename T>
__device__ __forceinline__ void rotate_sym(const T R[3][3], const T I[3][3], T* o) {
  T A[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) A[r][c] = R[r][0] * I[0][c] + R[r][1] * I[1][c] + R[r][2] * I[2][c];
  o[0] = dot3(A[0], R[0]);
  o[1] = dot3(A[0], R[1]);
  o[2] = dot3(A[0], R[2]);
  o[3] = dot3(A[1], R[1]);
  o[4] = dot3(A[1], R[2]);
  o[5] = dot3(A[2], R[2]);
}

// I_cw + m (|d|^2 1 - d d^T), symmetric 6 entries, in place
template <typename T>
__device__ __forceinline__ void add_shift_sym(T m, const T* d, T* I) {
  const T dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  I[0] += m * (dd - d[0] * d[0]);
  I[1] += -m * (d[0] * d[1]);
  I[2] += -m * (d[0] * d[2]);
  I[3] += m * (dd - d[1] * d[1]);
  I[4] += -m * (d[1] * d[2]);
  I[5] += m * (dd - d[2] * d[2]);
}

// [Io w + h x v ; m v + w x h] for motion [w; v]
template <typename T>
__device__ __forceinline__ void inertia_apply(T m, const T* h, const T* Io, const T* mot, T* f) {
  T t0[3], t1[3];
  symvec(Io, mot, t0);
  cross3(h, mot + 3, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] = t0[i] + t1[i];
  cross3(mot, h, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) f[3 + i] = m * mot[3 + i] + t1[i];
}

// spatial motion cross product a x b
template <typename T>
__device__ __forceinline__ void cross_motion(const T* a, const T* b, T* o) {
  T t0[3], t1[3];
  cross3(a, b, o);
  cross3(a, b + 3, t0);
  cross3(a + 3, b, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[3 + i] = t0[i] + t1[i];
}

// spatial force cross product a x* f
template <typename T>
__device__ __forceinline__ void cross_force(const T* a, const T* f, T* o) {
  T t0[3], t1[3];
  cross3(a, f, t0);
  cross3(a + 3, f + 3, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = t0[i] + t1[i];
  cross3(a, f + 3, o + 3);
}

// batched.inv3_sym applied to (Ml + reg 1): the twin adds reg twice
template <typename T>
__device__ __forceinline__ void inv3_sym(const T Ml[3][3], T o[3][3]) {
  const T reg = T(kReg);
  const T a = (Ml[0][0] + reg) + reg;
  const T b = Ml[0][1];
  const T c = Ml[0][2];
  const T d = (Ml[1][1] + reg) + reg;
  const T e = Ml[1][2];
  const T f = (Ml[2][2] + reg) + reg;
  const T A11 = d * f - e * e;
  const T A12 = c * e - b * f;
  const T A13 = b * e - c * d;
  const T A22 = a * f - c * c;
  const T A23 = b * c - a * e;
  const T A33 = a * d - b * b;
  const T det = a * A11 + b * A12 + c * A13;
  const T inv_det = T(1) / det;
  o[0][0] = A11 * inv_det; o[0][1] = A12 * inv_det; o[0][2] = A13 * inv_det;
  o[1][0] = A12 * inv_det; o[1][1] = A22 * inv_det; o[1][2] = A23 * inv_det;
  o[2][0] = A13 * inv_det; o[2][1] = A23 * inv_det; o[2][2] = A33 * inv_det;
}

// packed lower-triangle index (row-major): L[i][k], k <= i
__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

// batched.chol6 on the lower triangle of A (packed), with reg on the diagonal
template <typename T>
__device__ __forceinline__ void chol6(const T* A, T* L) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    T s = A[tri(j, j)] + T(kReg);
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
    const T Ljj = fsqrt(at_least(s, T(1e-12)));
    L[tri(j, j)] = Ljj;
    const T inv = T(1) / Ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      T t = A[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = t * inv;
    }
  }
}

template <typename T>
__device__ __forceinline__ void chol6_solve(const T* L, const T* b, T* x) {
  T y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

// --------------------------------------------------------------- contact

// engine_tl.sphere_ground_force on the z = 0 plane (normal +z)
template <typename T>
__device__ __forceinline__ void plane_contact(const T* p, const T* v, T radius, const Params<T>& P,
                                              T* f) {
  const T gap = p[2] - radius;
  const T pen = at_least(-gap, T(0));
  const T in_c = pen > T(0) ? T(1) : T(0);
  const T vn = v[2];
  T fn = P.kn * pen + P.dn * at_least(-vn, T(0)) * in_c;
  fn = at_least(fn, T(0)) * in_c;
  const T vt_norm = fsqrt(v[0] * v[0] + v[1] * v[1] + T(1e-12));
  const T coef = at_most(P.mu * fn / fsqrt(vt_norm * vt_norm + P.v_slip2), P.fric_visc_cap);
  f[0] = -(coef * v[0]);
  f[1] = -(coef * v[1]);
  f[2] = fn;
}

// One sphere against a table of n_boxes boxes, rows of kBoxWidth values
// (cx cy cz hx hy hz active pad; ops/traversal_cuda.py pack_boxes):
// engine_tl.sphere_boxes_force. Inside a box the pushout normal is averaged
// over every face tied for the least penetration (face = (q >= max q) /
// count), which is what edge and corner contacts with hurdles hit. The box
// loop stays rolled over the (shared-memory) table; the summed box force is
// added to f.
constexpr int kBoxWidth = 8;

template <typename T>
__device__ __forceinline__ void box_forces(const T* p, const T* v, T radius, const T* boxes,
                                           int n_boxes, const Params<T>& P, T* f) {
  T acc[3] = {T(0), T(0), T(0)};
#pragma unroll 1
  for (int b = 0; b < n_boxes; ++b) {
    const T* bx = boxes + b * kBoxWidth;
    T r[3], q[3], o[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      r[i] = p[i] - bx[i];
      q[i] = fabs_(r[i]) - bx[3 + i];
      o[i] = at_least(q[i], T(0));
    }
    const T d_out = fsqrt((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2] + T(1e-9));
    const T d_in = at_least(at_least(q[0], q[1]), q[2]);
    const bool inside = d_in < T(0);
    const T dist = inside ? d_in : d_out;
    T face[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) face[i] = q[i] >= d_in ? T(1) : T(0);
    const T count = at_least((face[0] + face[1]) + face[2], T(1));
    T n[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T sign = r[i] >= T(0) ? T(1) : T(-1);
      n[i] = inside ? sign * (face[i] / count) : (sign * o[i]) / d_out;
    }
    const T pen = at_least(radius - dist, T(0));
    const T in_c = pen > T(0) ? T(1) : T(0);
    const T vn = dot3(v, n);
    T fn = P.kn * pen + P.dn * at_least(-vn, T(0)) * in_c;
    fn = at_least(fn, T(0)) * in_c;
    T vt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) vt[i] = v[i] - vn * n[i];
    const T vt2 = dot3(vt, vt);
    const T coef = at_most(P.mu * fn / fsqrt(vt2 + T(1e-12) + P.v_slip2), P.fric_visc_cap);
    const T act = bx[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[i] += (fn * n[i] - coef * vt[i]) * act;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] += acc[i];
}

// Contact force on one foot or wheel sphere: the z = 0 plane and, with
// kBoxes, the box table.
template <typename T, bool kBoxes>
__device__ __forceinline__ void sphere_force(const T* p, const T* v, T radius, const Params<T>& P,
                                             const T* boxes, int n_boxes, T* f) {
  plane_contact(p, v, radius, P, f);
  if (kBoxes) box_forces(p, v, radius, boxes, n_boxes, P, f);
}

// Trunk proxy (engine._TRUNK_OFFSETS, float32 values; radius 0.07) against
// the boxes: six spheres on a 3x2 grid in the body x/y plane. The wrench is
// taken about the BASE position (moment arm = the rotated offset, not
// p - origin), as engine_tl.substep does. trunk_sphere adds sphere sp's
// moment and force to torque / force.
constexpr int kTrunkSpheres = 6;

template <typename T>
__device__ __forceinline__ void trunk_sphere(const T Rb[3][3], const T* pb, const T* vb,
                                             const T* wb, int sp, const T* boxes, int n_boxes,
                                             const Params<T>& P, T* torque, T* force) {
  const T off[3] = {T(sp < 2 ? -0.12f : (sp < 4 ? 0.0f : 0.12f)), T((sp & 1) ? 0.05f : -0.05f),
                    T(0)};
  T ow[3], wxo[3], p[3], v[3];
  matvec3(Rb, off, ow);
  cross3(wb, ow, wxo);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pb[i] + ow[i];
    v[i] = vb[i] + wxo[i];
  }
  T f[3] = {T(0), T(0), T(0)};
  box_forces(p, v, T(0.07), boxes, n_boxes, P, f);
  T nm[3];
  cross3(ow, f, nm);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    torque[i] += nm[i];
    force[i] += f[i];
  }
}

// ---------------------------------------------------------- mass factors

// Leg terms (S, h, Io), F, Minv, FtMinv about origin O; accumulates the
// whole-robot first moment / inertia and the Schur correction F Minv F^T.
template <typename T>
__device__ __forceinline__ void leg_factor(const ModelConst<T>& M, int leg, const LegKin<T>& k,
                                           const T* O, LegFrozen<T>& L, T* h_tot, T* Io_tot,
                                           T* schur) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T cw[3], d[3];
    matvec3(k.R[j], M.link_com[leg][j], cw);
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = (k.p[j][i] + cw[i]) - O[i];
    const T m = M.link_mass[leg][j];
    rotate_sym(k.R[j], M.link_inertia[leg][j], L.Io[j]);
    add_shift_sym(m, d, L.Io[j]);
#pragma unroll
    for (int i = 0; i < 3; ++i) L.h[j][i] = m * d[i];
    T r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      L.S[j][i] = k.a[j][i];
      r[i] = O[i] - k.p[j][i];
    }
    cross3(k.a[j], r, &L.S[j][3]);
  }
  // composite (reverse cumulative) parameters and F
  T hc[3][3], Ioc[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    hc[0][i] = (L.h[0][i] + L.h[1][i]) + L.h[2][i];
    hc[1][i] = L.h[1][i] + L.h[2][i];
    hc[2][i] = L.h[2][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Ioc[0][i] = (L.Io[0][i] + L.Io[1][i]) + L.Io[2][i];
    Ioc[1][i] = L.Io[1][i] + L.Io[2][i];
    Ioc[2][i] = L.Io[2][i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) inertia_apply(M.link_mass_rc[leg][j], hc[j], Ioc[j], L.S[j], L.F[j]);
  T Ml[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ml[i][j] = i <= j ? dot6(L.S[i], L.F[j]) : dot6(L.S[j], L.F[i]);
  inv3_sym(Ml, L.Minv);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 6; ++a)
      L.FtMinv[i][a] = (L.Minv[i][0] * L.F[0][a] + L.Minv[i][1] * L.F[1][a]) + L.Minv[i][2] * L.F[2][a];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      T acc = schur[tri(a, b)];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc += L.F[i][a] * L.FtMinv[i][b];
      schur[tri(a, b)] = acc;
    }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) h_tot[i] += L.h[j][i];
#pragma unroll
    for (int i = 0; i < 6; ++i) Io_tot[i] += L.Io[j][i];
  }
}

// base first moment and inertia about O (current configuration)
template <typename T>
__device__ __forceinline__ void base_terms(const ModelConst<T>& M, const T Rb[3][3], const T* pb,
                                          const T* O, T* h, T* Io) {
  T cw[3], d[3];
  matvec3(Rb, M.base_com, cw);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = (pb[i] + cw[i]) - O[i];
  rotate_sym(Rb, M.base_inertia, Io);
  add_shift_sym(M.base_mass, d, Io);
#pragma unroll
  for (int i = 0; i < 3; ++i) h[i] = M.base_mass * d[i];
}

// Mb = [[Io, skew(h)], [-skew(h), m 1]]; Schur = Mb - corr; factor it
template <typename T>
__device__ __forceinline__ void finish_factor(const ModelConst<T>& M, const T* h, const T* Io,
                                              const T* corr, T* chol) {
  T Mb[6][6];
  const T Im[3][3] = {{Io[0], Io[1], Io[2]}, {Io[1], Io[3], Io[4]}, {Io[2], Io[4], Io[5]}};
  const T hx[3][3] = {{T(0), -h[2], h[1]}, {h[2], T(0), -h[0]}, {-h[1], h[0], T(0)}};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Mb[r][c] = Im[r][c];
      Mb[r][3 + c] = hx[r][c];
      Mb[3 + r][c] = -hx[r][c];
      Mb[3 + r][3 + c] = r == c ? M.total_mass : T(0);
    }
  T A[21];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) A[tri(a, b)] = Mb[a][b] - corr[tri(a, b)];
  chol6(A, chol);
}

// ---------------------------------------------------------- per-leg body

// PD + passive + joint-limit torques of leg `leg` (its joint rows jq, jqd
// and its three targets)
template <typename T>
__device__ __forceinline__ void leg_torques(const ModelConst<T>& M, const Params<T>& P, int leg,
                                            const T* jq, const T* jqd, const T* target,
                                            T* tau_j) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T q = jq[j], qd = jqd[j];
    const T tgt = clampv(target[j], T(-kTgtClip), T(kTgtClip));
    const T tau = clampv(P.kp * (tgt - q) + P.kd * (T(0) - qd), -P.max_tau, P.max_tau);
    T pas = -M.damping[leg][j] * qd - M.friction[leg][j] * ftanh(qd / T(0.5));
    const T below = at_most(q - M.lower[leg][j], T(0));
    const T above = at_least(q - M.upper[leg][j], T(0));
    pas = pas - T(kLimitK) * (below + above);
    pas = pas - T(kLimitD) * qd * ((below < T(0) || above > T(0)) ? T(1) : T(0));
    tau_j[j] = tau + pas;
  }
}

// A contact force f at p as a spatial force about O: added to the base
// wrench tau_b and, through the subspaces of the leg's first NJ joints (the
// foot acts through all three, the wheel through joints 0 and 1), to tau_j.
template <int NJ, typename T>
__device__ __forceinline__ void add_contact(const T* p, const T* f, const T* O,
                                            const LegFrozen<T>& L, T* tau_b, T* tau_j) {
  T dp[3], Fsp[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) dp[i] = p[i] - O[i];
  cross3(dp, f, Fsp);
#pragma unroll
  for (int i = 0; i < 3; ++i) Fsp[3 + i] = f[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) tau_b[i] += Fsp[i];
#pragma unroll
  for (int j = 0; j < NJ; ++j) tau_j[j] += dot6(L.S[j], Fsp);
}

// RNEA bias of one leg (frozen link terms, current joint velocities jqd):
// subtracted from the leg's tau_j; the leg's force on the base added to
// bias_b.
template <typename T>
__device__ __forceinline__ void leg_bias(const ModelConst<T>& M, int leg, const LegFrozen<T>& L,
                                         const T* jqd, const T* v_base, const T* a_grav,
                                         T* tau_j, T* bias_b) {
  T vl[3][6], al[3][6];
  const T* vp = v_base;
  const T* ap = a_grav;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T qd = jqd[j];
    T cm[6];
    cross_motion(vp, L.S[j], cm);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      vl[j][i] = vp[i] + L.S[j][i] * qd;
      al[j][i] = ap[i] + cm[i] * qd;
    }
    vp = vl[j];
    ap = al[j];
  }
  T fl[3][6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T m = M.link_mass[leg][j];
    T fa[6], fv[6], cf[6];
    inertia_apply(m, L.h[j], L.Io[j], al[j], fa);
    inertia_apply(m, L.h[j], L.Io[j], vl[j], fv);
    cross_force(vl[j], fv, cf);
#pragma unroll
    for (int i = 0; i < 6; ++i) fl[j][i] = fa[i] + cf[i];
  }
  T facc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) facc[i] = fl[2][i];
  tau_j[2] -= dot6(L.S[2], facc);
#pragma unroll
  for (int i = 0; i < 6; ++i) facc[i] = fl[1][i] + fl[2][i];
  tau_j[1] -= dot6(L.S[1], facc);
#pragma unroll
  for (int i = 0; i < 6; ++i) facc[i] = (fl[0][i] + fl[1][i]) + fl[2][i];
  tau_j[0] -= dot6(L.S[0], facc);
#pragma unroll
  for (int i = 0; i < 6; ++i) bias_b[i] += facc[i];
}

// The leg's term of the Schur right-hand side, subtracted from rhs
template <typename T>
__device__ __forceinline__ void leg_rhs(const LegFrozen<T>& L, const T* tau_j, T* rhs) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 6; ++a) rhs[a] -= L.FtMinv[i][a] * tau_j[i];
}

// The leg's joint accelerations given the base acceleration acc, then
// semi-implicit Euler on its joint rows
template <typename T>
__device__ __forceinline__ void leg_joint_update(const LegFrozen<T>& L, const T* tau_j,
                                                 const T* acc, T dt, T* jq, T* jqd) {
  T resid[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) resid[j] = tau_j[j] - dot6(L.F[j], acc);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T qdd = (L.Minv[i][0] * resid[0] + L.Minv[i][1] * resid[1]) + L.Minv[i][2] * resid[2];
    const T nqd = jqd[i] + qdd * dt;
    jqd[i] = nqd;
    jq[i] = jq[i] + nqd * dt;
  }
}

// ------------------------------------------------------------- base pieces

// r = pb - O and the base spatial velocity at O
template <typename T>
__device__ __forceinline__ void base_motion(const T* pb, const T* vb, const T* wb, const T* O,
                                            T* r, T* v_base) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = pb[i] - O[i];
  T wxr[3];
  cross3(wb, r, wxr);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v_base[i] = wb[i];
    v_base[3 + i] = vb[i] - wxr[i];
  }
}

// the base body's bias force, added to bias_b
template <typename T>
__device__ __forceinline__ void base_bias(const ModelConst<T>& M, const T* hb, const T* Iob,
                                          const T* a_grav, const T* v_base, T* bias_b) {
  T fa[6], fv[6], cf[6];
  inertia_apply(M.base_mass, hb, Iob, a_grav, fa);
  inertia_apply(M.base_mass, hb, Iob, v_base, fv);
  cross_force(v_base, fv, cf);
#pragma unroll
  for (int i = 0; i < 6; ++i) bias_b[i] += fa[i] + cf[i];
}

// semi-implicit Euler of the base; linear acceleration transferred back
// from O
template <typename T>
__device__ __forceinline__ void base_step(const T* acc, const T* r, T dt, T* pb, T* q, T* vb,
                                          T* wb) {
  T axr[3], wxv[3];
  cross3(acc, r, axr);
  cross3(wb, vb, wxv);
  T new_w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T a_lin = (acc[3 + i] + axr[i]) + wxv[i];
    const T nv = vb[i] + a_lin * dt;
    new_w[i] = wb[i] + acc[i] * dt;
    vb[i] = nv;
    pb[i] = pb[i] + nv * dt;
  }
  quat_integrate(q, new_w, dt);
#pragma unroll
  for (int i = 0; i < 3; ++i) wb[i] = new_w[i];
}

// ----------------------------------------------------------------- substep

// One candidate's state as a lane of its group holds it.
template <typename T>
struct LaneState {
  T pb[3], q[4], vb[3], wb[3];  // the base: the same on every lane of the group
  T jq[3], jqd[3];              // the lane's leg
};

// The 37-value start state (pb 3, q 4, vb 3, wb 3, jq 12, jqd 12) as a
// lane that holds leg `leg` keeps it: the base and that leg's joint rows.
template <typename T>
__device__ __forceinline__ void load_lane_state(const T* state, int leg, LaneState<T>& s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.pb[i] = state[i];
    s.vb[i] = state[7 + i];
    s.wb[i] = state[10 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s.q[i] = state[3 + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.jq[j] = state[13 + leg * 3 + j];
    s.jqd[j] = state[25 + leg * 3 + j];
  }
}

template <typename T>
struct LaneFrozen {
  T origin[3];
  LegFrozen<T> leg;  // the lane's leg
  T chol[21];
};

// G consecutive lanes of one warp, aligned to G, that roll one candidate.
template <int G>
struct Group {
  static_assert(G == 4 || G == 8, "a group is 4 lanes (one leg each) or 8 (leg, foot | wheel)");
  static constexpr int kPerLeg = G / 4;  // lanes per leg
  unsigned mask;                         // the group's lanes within the warp
  int rank;                              // lane within the group
  int leg;                               // rank / kPerLeg
};

template <int G>
__device__ __forceinline__ Group<G> make_group() {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  Group<G> g;
  g.rank = lane & (G - 1);
  g.leg = g.rank / Group<G>::kPerLeg;
  g.mask = ((1u << G) - 1u) << (lane - g.rank);
  return g;
}

// Sum of x over the group's four legs (ranks 0, kPerLeg, ...), leg 0 first;
// every lane of the group gets the same value.
template <int G, typename T>
__device__ __forceinline__ T legs_sum(const Group<G>& g, T x) {
  T s = __shfl_sync(g.mask, x, 0, G);
#pragma unroll
  for (int l = 1; l < 4; ++l) s = s + __shfl_sync(g.mask, x, l * Group<G>::kPerLeg, G);
  return s;
}

template <int N, int G, typename T>
__device__ __forceinline__ void legs_sum_n(const Group<G>& g, T* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = legs_sum(g, x[i]);
}

// Sum of x over every lane of the group, rank 0 first.
template <int G, typename T>
__device__ __forceinline__ T lanes_sum(const Group<G>& g, T x) {
  T s = __shfl_sync(g.mask, x, 0, G);
#pragma unroll
  for (int l = 1; l < G; ++l) s = s + __shfl_sync(g.mask, x, l, G);
  return s;
}

// x[leg * 3 + j] of a 12-row table for a runtime leg, read with constant
// indices only (no copy of the table to local memory)
template <typename T>
__device__ __forceinline__ T leg_entry(const T* x, int leg, int j) {
  T v = x[j];
#pragma unroll
  for (int l = 1; l < 4; ++l) v = leg == l ? x[l * 3 + j] : v;
  return v;
}

// The leg's foot and wheel contact. G = 4: this lane runs both spheres;
// G = 8: the even lane the foot and the odd lane the wheel, then they swap
// forces, so both lanes of the leg add the same wrench.
template <typename T, bool kBoxes, int G>
__device__ __forceinline__ void leg_contact(const Group<G>& g, const ModelConst<T>& M,
                                            const Params<T>& P, const LegKin<T>& k, const T* O,
                                            const LegFrozen<T>& L, const T* boxes, int n_boxes,
                                            T* tau_b, T* tau_j) {
  T ff[3], fw[3];
  if constexpr (G == 4) {
    sphere_force<T, kBoxes>(k.pf, k.vf, M.foot_radius, P, boxes, n_boxes, ff);
    sphere_force<T, kBoxes>(k.pw, k.vw, M.wheel_radius, P, boxes, n_boxes, fw);
  } else {
    const bool wheel = (g.rank & 1) != 0;
    T p[3], v[3], f[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = wheel ? k.pw[i] : k.pf[i];
      v[i] = wheel ? k.vw[i] : k.vf[i];
    }
    sphere_force<T, kBoxes>(p, v, wheel ? M.wheel_radius : M.foot_radius, P, boxes, n_boxes, f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T other = __shfl_xor_sync(g.mask, f[i], 1, G);
      ff[i] = wheel ? other : f[i];
      fw[i] = wheel ? f[i] : other;
    }
  }
  add_contact<3>(k.pf, ff, O, L, tau_b, tau_j);
  add_contact<2>(k.pw, fw, O, L, tau_b, tau_j);
}

// One 500 Hz substep for lane g.rank of its group. refactor: rebuild the
// mass factors about the current base position first (substep
// i % mass_freeze == 0 of a control step). kBoxes: contact also against the
// n_boxes rows of `boxes` (feet, wheels and the trunk proxy); without it
// the code is the plane-only substep. The trunk spheres of a lane: G = 4
// splits the six 2, 2, 1, 1; G = 8 puts one on each of ranks 0-5.
template <typename T, bool kBoxes, int G>
__device__ __forceinline__ void substep_group(const ModelConst<T>& M, const Params<T>& P,
                                              const Group<G>& g, LaneState<T>& s,
                                              const T* target, LaneFrozen<T>& fr, bool refactor,
                                              const T* boxes, int n_boxes) {
  T Rb[3][3];
  quat_to_mat(s.q, Rb);
  if (refactor) {
#pragma unroll
    for (int i = 0; i < 3; ++i) fr.origin[i] = s.pb[i];
  }
  const T* O = fr.origin;
  T r[3], v_base[6];
  base_motion(s.pb, s.vb, s.wb, O, r, v_base);
  const T a_grav[6] = {T(0), T(0), T(0), T(0), T(0), T(kGravity)};
  T hb[3], Iob[6];
  base_terms(M, Rb, s.pb, O, hb, Iob);

  LegFrozen<T>& L = fr.leg;
  T tau_b[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T bias_b[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T tau_j[3];
  {
    LegKin<T> k;
    leg_fk(M, g.leg, Rb, s.pb, s.vb, s.wb, s.jq, s.jqd, k);
    if (refactor) {
      // the factors first: only the 21 values of the Cholesky factor stay
      // live through the contact below
      T h_tot[3] = {T(0), T(0), T(0)};
      T Io_tot[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T corr[21];
#pragma unroll
      for (int i = 0; i < 21; ++i) corr[i] = T(0);
      leg_factor(M, g.leg, k, O, L, h_tot, Io_tot, corr);
      legs_sum_n<3>(g, h_tot);
      legs_sum_n<6>(g, Io_tot);
      legs_sum_n<21>(g, corr);
#pragma unroll
      for (int i = 0; i < 3; ++i) h_tot[i] += hb[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) Io_tot[i] += Iob[i];
      finish_factor(M, h_tot, Io_tot, corr, fr.chol);
    }
    leg_torques(M, P, g.leg, s.jq, s.jqd, target, tau_j);
    leg_contact<T, kBoxes, G>(g, M, P, k, O, L, boxes, n_boxes, tau_b, tau_j);
  }
  leg_bias(M, g.leg, L, s.jqd, v_base, a_grav, tau_j, bias_b);
  legs_sum_n<6>(g, tau_b);
  legs_sum_n<6>(g, bias_b);

  if (kBoxes) {
    T torque[3] = {T(0), T(0), T(0)}, force[3] = {T(0), T(0), T(0)};
    const int first = G == 4 ? (g.rank < 2 ? 2 * g.rank : g.rank + 2) : g.rank;
    const int last = G == 4 ? (g.rank < 2 ? first + 2 : first + 1)
                            : (g.rank < kTrunkSpheres ? first + 1 : first);
#pragma unroll 1
    for (int sp = first; sp < last; ++sp)
      trunk_sphere(Rb, s.pb, s.vb, s.wb, sp, boxes, n_boxes, P, torque, force);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      tau_b[i] += lanes_sum(g, torque[i]);
      tau_b[3 + i] += lanes_sum(g, force[i]);
    }
  }

  base_bias(M, hb, Iob, a_grav, v_base, bias_b);
#pragma unroll
  for (int i = 0; i < 3; ++i) tau_b[3 + i] += P.ext[i];

  // Schur solve against the (frozen) factors, on every lane
  T part[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  leg_rhs(L, tau_j, part);
  legs_sum_n<6>(g, part);
  T rhs[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) rhs[a] = (tau_b[a] - bias_b[a]) + part[a];
  T acc[6];
  chol6_solve(fr.chol, rhs, acc);

  leg_joint_update(L, tau_j, acc, P.dt, s.jq, s.jqd);
  base_step(acc, r, P.dt, s.pb, s.q, s.vb, s.wb);
}

// One 50 Hz control step for lane g.rank of its group: `substeps` substeps
// with a held target (the lane's leg's three joint targets); mass factors
// rebuilt at i % mass_freeze == 0 from the start of the step.
template <typename T, bool kBoxes, int G>
__device__ __forceinline__ void control_step_group(const ModelConst<T>& M, const Params<T>& P,
                                                   const Group<G>& g, LaneState<T>& s,
                                                   const T* target, LaneFrozen<T>& fr,
                                                   const T* boxes, int n_boxes) {
  const int freeze = P.mass_freeze > 1 ? P.mass_freeze : 1;
#pragma unroll 1
  for (int i = 0; i < P.substeps; ++i)
    substep_group<T, kBoxes, G>(M, P, g, s, target, fr, (i % freeze) == 0, boxes, n_boxes);
}

}  // namespace lifelike

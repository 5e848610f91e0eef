// Shared device code of the hand-written Hopper kernels: per-lane views of
// batch-last arrays, small fixed-size matrix helpers, the curvature lookup,
// the LPV stage builds of the dynamic and the kinematic bicycle with their
// Van Loan discretization, the nonlinear plant ODEs, and the model traits
// (Dynamic, Kinematic) that the tracker core is templated on.
//
// Counterparts in the JAX package: the small-matrix helpers of
// ops/admm_kernel.py (_mm, _inv2),
// the stage math of ops/stage_math.py (secant_stiffness, _ab_cont_dynamic,
// _ab_cont_kinematic, _vanloan_aug, f_dynamic_bl, f_kinematic_bl) and the
// curvature lookup of
// ops/megastep_kernel.py (_make_kap_at).
//
// Layout: every per-scenario (lane) array is batch-last, element i of lane
// b at base[i * stride + b]; a group of threads owns one lane
// (arl_sync.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace arl {

constexpr int NX = 6;   // dynamic-bicycle state (the racestep and admm kernels' model)
constexpr int NU = 2;   // (delta, a)
constexpr int NA = 8;   // dynamic state augmented with u_prev
constexpr int KIN_NX = 4;   // kinematic-bicycle state (vx, e_psi, s, e_y)
constexpr int KIN_NA = 6;
constexpr int NC = 6;   // constraint rows per stage
constexpr int BLOCK = 128;  // lanes that exit ADMM together (one vote group)

constexpr float VX_EPS = 0.05f;
constexpr float DENOM_EPS = 0.1f;
constexpr float PACEJKA_C = 1.3f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float RHO_MIN = 1e-4f;
constexpr float RHO_MAX = 1e3f;
constexpr float RHO_TOL = 5.0f;

// One lane of a batch-last array.
struct Lane {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[(size_t)i * stride]; }
};

__device__ __forceinline__ Lane lane_of(const float* base, int b, int stride) {
  return Lane{const_cast<float*>(base) + b, stride};
}

template <int R, int C>
__device__ __forceinline__ void load(float (&m)[R][C], const Lane& a, int off) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) m[i][j] = a[off + i * C + j];
}

template <int R, int C>
__device__ __forceinline__ void store(const float (&m)[R][C], const Lane& a, int off) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[off + i * C + j] = m[i][j];
}

template <int R>
__device__ __forceinline__ void loadv(float (&v)[R], const Lane& a, int off) {
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = a[off + i];
}

// C = A B for A (R x K), B (K x L)
template <int R, int K, int L>
__device__ __forceinline__ void mm(const float (&A)[R][K], const float (&B)[K][L], float (&C)[R][L]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float acc = A[i][0] * B[0][l];
#pragma unroll
      for (int j = 1; j < K; ++j) acc += A[i][j] * B[j][l];
      C[i][l] = acc;
    }
}

// Closed-form inverse of a 2x2 matrix.
__device__ __forceinline__ void inv2(const float (&H)[2][2], float (&Hi)[2][2]) {
  const float inv_det = 1.0f / (H[0][0] * H[1][1] - H[0][1] * H[1][0]);
  Hi[0][0] = H[1][1] * inv_det;
  Hi[0][1] = -H[0][1] * inv_det;
  Hi[1][0] = -H[1][0] * inv_det;
  Hi[1][1] = H[0][0] * inv_det;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool is_inf(float x) { return fabsf(x) == INFINITY; }

// Curvature of the cell holding arc length s: clamp(int(wrap(s) * inv_ds)).
// The rounding intrinsics keep the compiler from fusing the wrap into an
// FMA, so the cell index is the one the plain version computes.
__device__ __forceinline__ float kap_at(const float* kappa, int n_cells, float length,
                                        float inv_ds, float s) {
  const float q = floorf(__fdiv_rn(s, length));
  const float sm = __fsub_rn(s, __fmul_rn(length, q));
  int idx = __float2int_rz(__fmul_rn(sm, inv_ds));
  idx = min(max(idx, 0), n_cells - 1);
  return __ldg(kappa + idx);
}

struct VehParams {
  float m, Iz, lf, lr, Cf, Cr, mu, g, cd0, cd1;
};

// (10, B) parameter rows, in ops/stage_math.py PARAM_ROWS order.
__device__ __forceinline__ VehParams load_params(const float* prm, int b, int stride) {
  const Lane p = lane_of(prm, b, stride);
  return VehParams{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
}

// sin(x)/x, 1 at 0 (torch.sinc(x / pi)).
__device__ __forceinline__ float sinc(float x) {
  if (x == 0.0f) return 1.0f;
  const float y = PI_F * (x / PI_F);
  return sinf(y) / y;
}

// Cornering stiffnesses: the linear constants (tire 0) or the Pacejka
// secant stiffness at the scheduled slip (tire 1).
__device__ __forceinline__ void secant_stiffness(const VehParams& pv, float delta, float vy,
                                                 float wz, float vxs, int tire, float& Cf,
                                                 float& Cr) {
  if (tire != 1) {
    Cf = pv.Cf;
    Cr = pv.Cr;
    return;
  }
  const float fzf = pv.mu * pv.m * pv.g * pv.lr / (pv.lf + pv.lr);
  const float fzr = pv.mu * pv.m * pv.g * pv.lf / (pv.lf + pv.lr);
  float af = delta - atan2f(vy + pv.lf * wz, vxs);
  float ar = -atan2f(vy - pv.lr * wz, vxs);
  if (fabsf(af) < 1e-4f) af = 1e-4f;
  if (fabsf(ar) < 1e-4f) ar = 1e-4f;
  const float Bf = pv.Cf / (PACEJKA_C * fmaxf(fzf, 1e-6f));
  const float Br = pv.Cr / (PACEJKA_C * fmaxf(fzr, 1e-6f));
  Cf = fzf * sinf(PACEJKA_C * atanf(Bf * af)) / af;
  Cr = fzr * sinf(PACEJKA_C * atanf(Br * ar)) / ar;
}

// Continuous-time LPV (A, B) of the dynamic bicycle at (x, u, kappa).
__device__ __forceinline__ void ab_cont_dynamic(const float (&x)[NX], const float (&u)[NU],
                                                float kap, const VehParams& pv, int tire,
                                                float (&A)[NX][NX], float (&B)[NX][NU]) {
  const float vx = x[0], vy = x[1], wz = x[2], epsi = x[3], ey = x[5];
  const float delta = u[0];
  const float vxs = fmaxf(vx, VX_EPS);
  float Cf, Cr;
  secant_stiffness(pv, delta, vy, wz, vxs, tire, Cf, Cr);
  const float sd = sinf(delta), cd = cosf(delta);
  const float se = sinf(epsi), ce = cosf(epsi);
  const float den = fmaxf(1.0f - kap * ey, DENOM_EPS);
  const float m = pv.m, Iz = pv.Iz, lf = pv.lf, lr = pv.lr;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) A[i][j] = 0.0f;
    B[i][0] = 0.0f;
    B[i][1] = 0.0f;
  }
  A[0][0] = -(pv.cd1 + pv.cd0 / vxs) / m;
  A[0][1] = Cf * sd / (m * vxs) + wz;
  A[0][2] = Cf * lf * sd / (m * vxs);
  A[1][1] = -(Cf * cd + Cr) / (m * vxs);
  A[1][2] = (-Cf * lf * cd + Cr * lr) / (m * vxs) - vxs;
  A[2][1] = (-lf * Cf * cd + lr * Cr) / (Iz * vxs);
  A[2][2] = -(lf * lf * Cf * cd + lr * lr * Cr) / (Iz * vxs);
  A[3][0] = -kap * ce / den;
  A[3][1] = kap * se / den;
  A[3][2] = 1.0f;
  A[4][0] = ce / den;
  A[4][1] = -se / den;
  A[5][1] = ce;
  A[5][3] = vxs * sinc(epsi);
  B[0][0] = -Cf * sd / m;
  B[0][1] = 1.0f;
  B[1][0] = Cf * cd / m;
  B[2][0] = lf * Cf * cd / Iz;
}

// Continuous-time LPV (A, B) of the kinematic bicycle at (x, u, kappa);
// x = (vx, e_psi, s, e_y). No tires.
__device__ __forceinline__ void ab_cont_kinematic(const float (&x)[KIN_NX], const float (&u)[NU],
                                                  float kap, const VehParams& pv,
                                                  float (&A)[KIN_NX][KIN_NX],
                                                  float (&B)[KIN_NX][NU]) {
  const float vx = x[0], epsi = x[1], ey = x[3];
  const float vxs = fmaxf(vx, VX_EPS);
  const float L = pv.lf + pv.lr;
  const float se = sinf(epsi), ce = cosf(epsi);
  const float den = fmaxf(1.0f - kap * ey, DENOM_EPS);
#pragma unroll
  for (int i = 0; i < KIN_NX; ++i) {
#pragma unroll
    for (int j = 0; j < KIN_NX; ++j) A[i][j] = 0.0f;
    B[i][0] = 0.0f;
    B[i][1] = 0.0f;
  }
  A[0][0] = -(pv.cd1 + pv.cd0 / vxs) / pv.m;
  A[1][0] = -kap * ce / den;
  A[2][0] = ce / den;
  A[3][1] = vxs * sinc(epsi);
  B[0][1] = 1.0f;
  B[1][0] = vxs / L;
}

// Van Loan exp(dt [[A, B], [0, 0]]) by a 6th-order Taylor series (Horner)
// with 4 squarings, for an nx-state model. The bottom block rows of every
// iterate are [0 I], so only the top blocks E = [Ad Bd] are carried: the
// same products as the full (nx+2)^2 form without its exact-zero terms.
// The Horner terms are scaled by the reciprocals 1/k instead of divided by
// k (a multiply where a division costs a dozen instructions; the results
// move by an ulp against the plain version).
template <int nx>
__device__ __forceinline__ void vanloan(const float (&A)[nx][nx], const float (&B)[nx][NU],
                                        float dt, float (&Ad)[nx][nx], float (&Bd)[nx][NU]) {
  constexpr int ORDER = 6, SQUARINGS = 4;
  const float S = dt / 16.0f;   // dt / 2^SQUARINGS
  auto over = [](float x, int k) { return x * (1.0f / (float)k); };
  float Ma[nx][nx], Mb[nx][NU], T[nx][nx], Tb[nx][NU];
#pragma unroll
  for (int i = 0; i < nx; ++i) {
#pragma unroll
    for (int j = 0; j < nx; ++j) {
      Ma[i][j] = A[i][j] * S;
      Ad[i][j] = (i == j ? 1.0f : 0.0f) + over(Ma[i][j], ORDER);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      Mb[i][j] = B[i][j] * S;
      Bd[i][j] = over(Mb[i][j], ORDER);
    }
  }
#pragma unroll
  for (int k = ORDER - 1; k > 0; --k) {
    mm(Ma, Ad, T);
    mm(Ma, Bd, Tb);
#pragma unroll
    for (int i = 0; i < nx; ++i) {
#pragma unroll
      for (int j = 0; j < nx; ++j) Ad[i][j] = (i == j ? 1.0f : 0.0f) + over(T[i][j], k);
#pragma unroll
      for (int j = 0; j < NU; ++j) Bd[i][j] = over(Tb[i][j] + Mb[i][j], k);
    }
  }
#pragma unroll
  for (int q = 0; q < SQUARINGS; ++q) {
    mm(Ad, Ad, T);
    mm(Ad, Bd, Tb);
#pragma unroll
    for (int i = 0; i < nx; ++i) {
#pragma unroll
      for (int j = 0; j < nx; ++j) Ad[i][j] = T[i][j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Bd[i][j] = Tb[i][j] + Bd[i][j];
    }
  }
}

// Nonlinear dynamic-bicycle Frenet ODE dx/dt (tire 0 linear, 1 Pacejka).
__device__ __forceinline__ void f_dynamic(const VehParams& pv, const float (&x)[NX],
                                          const float (&u)[NU], float kap, int tire,
                                          float (&dx)[NX]) {
  const float vx = x[0], vy = x[1], wz = x[2], epsi = x[3], ey = x[5];
  const float delta = u[0], a = u[1];
  const float vxs = fmaxf(vx, VX_EPS);
  const float alpha_f = delta - atan2f(vy + pv.lf * wz, vxs);
  const float alpha_r = -atan2f(vy - pv.lr * wz, vxs);
  const float L = pv.lf + pv.lr;
  const float fzf = pv.mu * pv.m * pv.g * pv.lr / L;
  const float fzr = pv.mu * pv.m * pv.g * pv.lf / L;
  float fyf, fyr;
  if (tire == 1) {
    const float Bf = pv.Cf / (PACEJKA_C * fmaxf(fzf, 1e-6f));
    const float Br = pv.Cr / (PACEJKA_C * fmaxf(fzr, 1e-6f));
    fyf = fzf * sinf(PACEJKA_C * atanf(Bf * alpha_f));
    fyr = fzr * sinf(PACEJKA_C * atanf(Br * alpha_r));
  } else {
    fyf = pv.Cf * alpha_f;
    fyr = pv.Cr * alpha_r;
  }
  const float sd = sinf(delta), cd = cosf(delta);
  const float se = sinf(epsi), ce = cosf(epsi);
  const float denom = fmaxf(1.0f - kap * ey, DENOM_EPS);
  const float sdot = (vx * ce - vy * se) / denom;
  dx[0] = a - (fyf * sd) / pv.m + wz * vy - (pv.cd0 + pv.cd1 * vx) / pv.m;
  dx[1] = (fyf * cd + fyr) / pv.m - wz * vx;
  dx[2] = (pv.lf * fyf * cd - pv.lr * fyr) / pv.Iz;
  dx[3] = wz - kap * sdot;
  dx[4] = sdot;
  dx[5] = vx * se + vy * ce;
}

// Nonlinear kinematic-bicycle Frenet ODE dx/dt; tan(delta) as sin / cos,
// as the plain version computes it.
__device__ __forceinline__ void f_kinematic(const VehParams& pv, const float (&x)[KIN_NX],
                                            const float (&u)[NU], float kap,
                                            float (&dx)[KIN_NX]) {
  const float vx = x[0], epsi = x[1], ey = x[3];
  const float delta = u[0], a = u[1];
  const float L = pv.lf + pv.lr;
  const float psidot = vx * sinf(delta) / (cosf(delta) * L);
  const float se = sinf(epsi), ce = cosf(epsi);
  const float denom = fmaxf(1.0f - kap * ey, DENOM_EPS);
  const float sdot = vx * ce / denom;
  dx[0] = a - (pv.cd0 + pv.cd1 * vx) / pv.m;
  dx[1] = psidot - kap * sdot;
  dx[2] = sdot;
  dx[3] = vx * se;
}

// Model traits of the tracker core (group_core.cuh): state width nx, the
// augmented width na = nx + NU, the indices of s and e_y in the state, the
// LPV stage build and the plant ODE. The plain version selects the same by
// MPCConfig.model (ops/stage_math.py::model_dims, model_s_ey).
//
// cache_scale(i) is state channel i's drift scale in the megastep's
// discretization-cache signature (JAX ops/megastep_kernel.py::_mpc_core,
// x_scl), 0 for s, which the signature leaves out.
struct Dynamic {
  static constexpr int NX = arl::NX, NA = arl::NA, S = 4, EY = 5;
  static __device__ __forceinline__ float cache_scale(int i) {
    return i == 0 ? 1.0f : i == 2 ? 2.0f : i == S ? 0.0f : 0.5f;
  }
  static __device__ __forceinline__ void ab_cont(const float (&x)[NX], const float (&u)[NU],
                                                 float kap, const VehParams& pv, int tire,
                                                 float (&A)[NX][NX], float (&B)[NX][NU]) {
    ab_cont_dynamic(x, u, kap, pv, tire, A, B);
  }
  static __device__ __forceinline__ void f(const VehParams& pv, const float (&x)[NX],
                                           const float (&u)[NU], float kap, int tire,
                                           float (&dx)[NX]) {
    f_dynamic(pv, x, u, kap, tire, dx);
  }
};

struct Kinematic {
  static constexpr int NX = KIN_NX, NA = KIN_NA, S = 2, EY = 3;
  static __device__ __forceinline__ float cache_scale(int i) {
    return i == 0 ? 1.0f : i == S ? 0.0f : 0.5f;
  }
  static __device__ __forceinline__ void ab_cont(const float (&x)[NX], const float (&u)[NU],
                                                 float kap, const VehParams& pv, int /*tire*/,
                                                 float (&A)[NX][NX], float (&B)[NX][NU]) {
    ab_cont_kinematic(x, u, kap, pv, A, B);
  }
  static __device__ __forceinline__ void f(const VehParams& pv, const float (&x)[NX],
                                           const float (&u)[NU], float kap, int /*tire*/,
                                           float (&dx)[NX]) {
    f_kinematic(pv, x, u, kap, dx);
  }
};

// Running maxima of one ADMM iteration, in the z-space of the splitting:
// |G - s|, |D'(s - s_prev)|, |G|, |s|, |D' lam| (the OSQP termination test).
struct Resid {
  float r_p, dual_ds, g_max, s_max, dual_lam;
};

__device__ __forceinline__ bool converged(const Resid& r, float rho, float eps_abs,
                                          float eps_rel) {
  const float e_p = eps_abs + eps_rel * fmaxf(r.g_max, r.s_max);
  const float e_d = eps_abs + eps_rel * r.dual_lam;
  return r.r_p <= e_p && rho * r.dual_ds <= e_d;
}

}  // namespace arl

// The tracker core of the megastep kernel, one thread per lane: sections
// 1-8 of one receding-horizon step (schedule shift, curvature +
// friction-cap bounds, LPV + Van Loan + linear cost, warm-start shift,
// Riccati factor, ADMM in chunks of `check` iterations with the 128-lane
// early-exit vote, residuals / rho, accept or limp-home).
//
// Counterpart of the JAX package's ops/megastep_kernel.py::_mpc_core, which
// its megastep and racestep Pallas kernels share; plain PyTorch version:
// ops/megastep_kernel.py::mpc_core_plain. Every piece is a template on the
// model traits M of arl_common.cuh (Dynamic, Kinematic): the state width,
// the augmented width, the indices of s and e_y, the stage build. The
// racestep and the fused solve run the group core of group_core.cuh (G
// threads per lane), which shares this file's parameters, constants,
// workspace layout and residual test.
#pragma once

#include "arl_common.cuh"

namespace arl {

// Solver scalars, host-built constants and the warm-start operands of the
// tracker core. Arrays are batch-last (last dim B).
template <class M>
struct CoreParams {
  static constexpr int nx = M::NX, na = M::NA;
  const float *Xp, *Up, *sw, *lamw, *uprev, *rho;   // warm start in
  const float *kappa;   // (n_cells,) curvature table
  const float *taux;    // (2,) [track length, 1/ds]
  float *Xp_out, *Up_out, *s_out, *lam_out, *u0_out, *stats;
  int B, N, n_cells, max_iter, check, early_exit, tire, kappa_speed_cap;
  float dt, sigma, alpha, eps_abs, eps_rel, eps_fallback;
  float vx_min, vx_max, ey_max, delta_max, a_min, a_max, ddelta_max, da_max, a_lat_frac;
  // ops/fused_kernel.py::_make_consts
  float Dx[NC][na], Du[NC][NU], soft[NC], Qc[na][na], Qtc[na][na], Rc[NU][NU], Mc[na][NU];
  float DxDx[na][na], DuDu[NU][NU], DxDu[na][NU], qw[nx];
};

// Float parameters of the core in the wrappers' order (ops/fused_kernel.py::
// core_floats): 15 scalars, then the constants of _make_consts.
template <class M>
constexpr int core_floats() {
  constexpr int nx = M::NX, na = M::NA;
  return 15 + NC * na + NC * NU + NC + 2 * na * na + NU * NU + na * NU + na * na + NU * NU +
         na * NU + nx;
}

template <class M>
inline void read_core_floats(CoreParams<M>& P, const float* fv) {
  constexpr int nx = M::NX, na = M::NA;
  float* scal[] = {&P.dt, &P.sigma, &P.alpha, &P.eps_abs, &P.eps_rel, &P.eps_fallback,
                   &P.vx_min, &P.vx_max, &P.ey_max, &P.delta_max, &P.a_min, &P.a_max,
                   &P.ddelta_max, &P.da_max, &P.a_lat_frac};
  int f = 0;
  for (auto q : scal) *q = fv[f++];
  float* arrs[] = {&P.Dx[0][0], &P.Du[0][0], P.soft, &P.Qc[0][0], &P.Qtc[0][0], &P.Rc[0][0],
                   &P.Mc[0][0], &P.DxDx[0][0], &P.DuDu[0][0], &P.DxDu[0][0], P.qw};
  const int sizes[] = {NC * na, NC * NU, NC, na * na, na * na, NU * NU, na * NU, na * na,
                       NU * NU, na * NU, nx};
  for (int a = 0; a < 11; ++a)
    for (int i = 0; i < sizes[a]; ++i) arrs[a][i] = fv[f++];
}

// Per-lane workspace offsets (floats) of the core; ops/fused_kernel.py::
// core_workspace mirrors the total.
template <class M>
struct WsLayout {
  int Xs, Us, kap, lb, ub, Ad, Bd, q0, K, Hiv, Hux, d, Xsol, Usol, total;
  __host__ __device__ explicit WsLayout(int N) {
    constexpr int nx = M::NX, na = M::NA;
    int o = 0;
    Xs = o;   o += (N + 1) * nx;
    Us = o;   o += N * NU;
    kap = o;  o += N + 1;
    lb = o;   o += (N + 1) * NC;
    ub = o;   o += (N + 1) * NC;
    Ad = o;   o += N * nx * nx;
    Bd = o;   o += N * nx * NU;
    q0 = o;   o += (N + 1) * nx;
    K = o;    o += N * NU * na;
    Hiv = o;  o += N * NU * NU;
    Hux = o;  o += N * NU * na;
    d = o;    o += N * NU;
    Xsol = o; o += (N + 1) * na;
    Usol = o; o += N * NU;
    total = o;
  }
};

// Sections 1-4: schedule, bounds, stage matrices, linear cost, warm start.
template <class M>
__device__ __forceinline__ void prepare(const CoreParams<M>& P, int b, const WsLayout<M>& W,
                                        const Lane& ws, const VehParams& pv,
                                        const float (&x)[M::NX], const Lane& xref) {
  constexpr int NX = M::NX;
  const int N = P.N, S = P.B;
  const Lane Xp = lane_of(P.Xp, b, S), Up = lane_of(P.Up, b, S);
  // 1. shift schedule: Xs = [x, Xp[2..N], Xp[N]], Us = [Up[1..N-1], Up[N-1]]
  for (int i = 0; i < NX; ++i) ws[W.Xs + i] = x[i];
  for (int k = 1; k <= N; ++k) {
    const int kk = min(k + 1, N);
    for (int i = 0; i < NX; ++i) ws[W.Xs + k * NX + i] = Xp[kk * NX + i];
  }
  for (int k = 0; k < N; ++k) {
    const int kk = min(k + 1, N - 1);
    for (int i = 0; i < NU; ++i) ws[W.Us + k * NU + i] = Up[kk * NU + i];
  }

  // 2. curvature + bounds per stage (friction-circle vx cap)
  const float length = P.taux[0], inv_ds = P.taux[1];
  const float lo[NC] = {P.vx_min, -P.ey_max, -P.delta_max, P.a_min, -P.ddelta_max, -P.da_max};
  const float hi[NC] = {P.vx_max, P.ey_max, P.delta_max, P.a_max, P.ddelta_max, P.da_max};
  for (int k = 0; k <= N; ++k) {
    const float kap = kap_at(P.kappa, P.n_cells, length, inv_ds, ws[W.Xs + k * NX + M::S]);
    ws[W.kap + k] = kap;
    float cap = P.vx_max;
    if (P.kappa_speed_cap)
      cap = clampf(sqrtf(P.a_lat_frac * pv.mu * pv.g / fmaxf(fabsf(kap), 1e-6f)), P.vx_min,
                   P.vx_max);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float l = lo[c], u = (c == 0) ? cap : hi[c];
      // stage 0: state rows act on the fixed x0; terminal: no u_N
      if ((k == 0 && c < 2) || (k == N && c >= 2)) {
        l = -INFINITY;
        u = INFINITY;
      }
      ws[W.lb + k * NC + c] = l;
      ws[W.ub + k * NC + c] = u;
    }
  }

  // 3. stage matrices and the linear cost (vx reference clamped to the cap)
  for (int k = 0; k < N; ++k) {
    float xk[NX], uk[NU], Ac[NX][NX], Bc[NX][NU], Ad[NX][NX], Bd[NX][NU];
    loadv(xk, ws, W.Xs + k * NX);
    loadv(uk, ws, W.Us + k * NU);
    M::ab_cont(xk, uk, ws[W.kap + k], pv, P.tire, Ac, Bc);
    vanloan(Ac, Bc, P.dt, Ad, Bd);
    store(Ad, ws, W.Ad + k * NX * NX);
    store(Bd, ws, W.Bd + k * NX * NU);
  }
  for (int k = 0; k <= N; ++k) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float xr = xref[k * NX + i];
      if (i == 0) xr = fminf(xr, ws[W.ub + k * NC]);
      ws[W.q0 + k * NX + i] = -(P.qw[i] * xr);
    }
  }

  // 4. warm start: the previous split/dual shifted one stage
  const Lane sw = lane_of(P.sw, b, S), lamw = lane_of(P.lamw, b, S);
  const Lane s = lane_of(P.s_out, b, S), lam = lane_of(P.lam_out, b, S);
  for (int k = 0; k <= N; ++k) {
    const int kk = min(k + 1, N);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s[k * NC + c] = clampf(sw[kk * NC + c], ws[W.lb + k * NC + c], ws[W.ub + k * NC + c]);
      lam[k * NC + c] = lamw[kk * NC + c];
    }
  }
}

// Section 5: backward Riccati factorization of the rho-folded cost.
template <class M>
__device__ __forceinline__ void factor(const CoreParams<M>& P, const WsLayout<M>& W,
                                       const Lane& ws, float rho) {
  constexpr int NX = M::NX, NA = M::NA;
  float V[NA][NA];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j) V[i][j] = P.Qtc[i][j] + P.DxDx[i][j] * rho;

  for (int k = P.N - 1; k >= 0; --k) {
    float Ad[NX][NX], Bd[NX][NU];
    load(Ad, ws, W.Ad + k * NX * NX);
    load(Bd, ws, W.Bd + k * NX * NU);
    // VB = V Ba with Ba = [[Bd], [I]]
    float VB[NA][NU];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = V[i][0] * Bd[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += V[i][l] * Bd[l][c];
        VB[i][c] = acc + V[i][NX + c];
      }
    // Huu = Rf + Ba' V Ba
    float Huu[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = Bd[0][a] * VB[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += Bd[l][a] * VB[l][c];
        Huu[a][c] = (P.Rc[a][c] + P.DuDu[a][c] * rho) + (acc + VB[NX + a][c]);
      }
    // VA = V Aa with Aa = [[Ad, 0], [0, 0]]: only the first NX columns
    float VA[NA][NX];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = V[i][0] * Ad[0][j];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += V[i][l] * Ad[l][j];
        VA[i][j] = acc;
      }
    // Hux = Mf' + Ba' V Aa
    float Hux[NU][NA];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const float mf = P.Mc[j][a] + P.DxDu[j][a] * rho;
        if (j < NX) {
          float acc = Bd[0][a] * VA[0][j];
#pragma unroll
          for (int l = 1; l < NX; ++l) acc += Bd[l][a] * VA[l][j];
          Hux[a][j] = mf + (acc + VA[NX + a][j]);
        } else {
          Hux[a][j] = mf;
        }
      }
    float Hiv[NU][NU], K[NU][NA];
    inv2(Huu, Hiv);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int j = 0; j < NA; ++j) K[a][j] = -(Hiv[a][0] * Hux[0][j] + Hiv[a][1] * Hux[1][j]);
    store(K, ws, W.K + k * NU * NA);
    store(Hiv, ws, W.Hiv + k * NU * NU);
    store(Hux, ws, W.Hux + k * NU * NA);
    // V <- sym(Qf + Aa' V Aa + Hux' K)
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        float ava = 0.0f;
        if (i < NX && j < NX) {
          ava = Ad[0][i] * VA[0][j];
#pragma unroll
          for (int l = 1; l < NX; ++l) ava += Ad[l][i] * VA[l][j];
        }
        V[i][j] = (P.Qc[i][j] + P.DxDx[i][j] * rho) + ava + (Hux[0][i] * K[0][j] + Hux[1][i] * K[1][j]);
      }
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = i + 1; j < NA; ++j) {
        const float m = 0.5f * (V[i][j] + V[j][i]);
        V[i][j] = m;
        V[j][i] = m;
      }
  }
}

// Stage k of the z-update: G_k = Dx x_k + Du u_k, relaxed projection
// (prox for the soft e_y row) and the dual step, with the running maxima.
template <class M>
__device__ __forceinline__ void z_update(const CoreParams<M>& P, const WsLayout<M>& W,
                                         const Lane& ws, const Lane& s_l, const Lane& lam_l, int k,
                                         const float (&x)[M::NA], const float (&u)[NU], bool has_u,
                                         float rho, float rinv, Resid& acc) {
  constexpr int NA = M::NA;
  float ds[NC], lamn[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float gx = P.Dx[c][0] * x[0];
#pragma unroll
    for (int j = 1; j < NA; ++j) gx += P.Dx[c][j] * x[j];
    const float G = has_u ? gx + (P.Du[c][0] * u[0] + P.Du[c][1] * u[1]) : gx;
    const float s = s_l[k * NC + c], lam = lam_l[k * NC + c];
    const float w_rel = P.alpha * G + (1.0f - P.alpha) * s;
    const float wl = w_rel + lam * rinv;
    const float clipped = clampf(wl, ws[W.lb + k * NC + c], ws[W.ub + k * NC + c]);
    float s_new = clipped;
    if (!is_inf(P.soft[c])) s_new = (P.soft[c] * clipped + rho * wl) * (1.0f / (P.soft[c] + rho));
    const float lam_new = lam + rho * (w_rel - s_new);
    s_l[k * NC + c] = s_new;
    lam_l[k * NC + c] = lam_new;
    acc.r_p = fmaxf(acc.r_p, fabsf(G - s_new));
    acc.g_max = fmaxf(acc.g_max, fabsf(G));
    acc.s_max = fmaxf(acc.s_max, fabsf(s_new));
    ds[c] = s_new - s;
    lamn[c] = lam_new;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    float a = P.Dx[0][i] * ds[0], l = P.Dx[0][i] * lamn[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      a += P.Dx[c][i] * ds[c];
      l += P.Dx[c][i] * lamn[c];
    }
    acc.dual_ds = fmaxf(acc.dual_ds, fabsf(a));
    acc.dual_lam = fmaxf(acc.dual_lam, fabsf(l));
  }
  if (has_u) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float a = P.Du[0][i] * ds[0], l = P.Du[0][i] * lamn[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) {
        a += P.Du[c][i] * ds[c];
        l += P.Du[c][i] * lamn[c];
      }
      acc.dual_ds = fmaxf(acc.dual_ds, fabsf(a));
      acc.dual_lam = fmaxf(acc.dual_lam, fabsf(l));
    }
  }
}

// One ADMM iteration (section 6): affine backward sweep, forward rollout,
// z-update. Returns the iteration's residual maxima.
template <class M>
static __device__ Resid admm_iteration(const CoreParams<M>& P, const WsLayout<M>& W,
                                       const Lane& ws, const Lane& s_l, const Lane& lam_l,
                                       const float (&x0a)[M::NA], float rho, float rinv) {
  constexpr int NX = M::NX, NA = M::NA;
  const int N = P.N;
  const float sigma = P.sigma;
  float vv[NA];
  {
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = s_l[N * NC + c] - lam_l[N * NC + c] * rinv;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float t = P.Dx[0][i] * v[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) t += P.Dx[c][i] * v[c];
      const float q0 = i < NX ? ws[W.q0 + N * NX + i] : 0.0f;
      vv[i] = q0 - rho * t - sigma * ws[W.Xsol + N * NA + i];
    }
  }
  for (int k = N - 1; k >= 0; --k) {
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = s_l[k * NC + c] - lam_l[k * NC + c] * rinv;
    float qk[NA], rk[NU];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float t = P.Dx[0][i] * v[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) t += P.Dx[c][i] * v[c];
      const float q0 = i < NX ? ws[W.q0 + k * NX + i] : 0.0f;
      qk[i] = q0 - rho * t - sigma * ws[W.Xsol + k * NA + i];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float t = P.Du[0][a] * v[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) t += P.Du[c][a] * v[c];
      rk[a] = -rho * t - sigma * ws[W.Usol + k * NU + a];
    }
    float Bd[NX][NU], Hiv[NU][NU];
    load(Bd, ws, W.Bd + k * NX * NU);
    load(Hiv, ws, W.Hiv + k * NU * NU);
    float hu[NU], d[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = Bd[0][a] * vv[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc += Bd[l][a] * vv[l];
      hu[a] = rk[a] + (acc + vv[NX + a]);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d[a] = -(Hiv[a][0] * hu[0] + Hiv[a][1] * hu[1]);
      ws[W.d + k * NU + a] = d[a];
    }
    float Ad[NX][NX], Hux[NU][NA];
    load(Ad, ws, W.Ad + k * NX * NX);
    load(Hux, ws, W.Hux + k * NU * NA);
    float vn[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float atv = 0.0f;
      if (i < NX) {
        atv = Ad[0][i] * vv[0];
#pragma unroll
        for (int l = 1; l < NX; ++l) atv += Ad[l][i] * vv[l];
      }
      vn[i] = qk[i] + atv + (Hux[0][i] * d[0] + Hux[1][i] * d[1]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) vv[i] = vn[i];
  }

  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float x[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) x[i] = x0a[i];
  storev(x, ws, W.Xsol);
  for (int k = 0; k < N; ++k) {
    float K[NU][NA], u[NU];
    load(K, ws, W.K + k * NU * NA);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float t = K[a][0] * x[0];
#pragma unroll
      for (int j = 1; j < NA; ++j) t += K[a][j] * x[j];
      u[a] = t + ws[W.d + k * NU + a];
    }
    z_update(P, W, ws, s_l, lam_l, k, x, u, true, rho, rinv, acc);
    float Ad[NX][NX], Bd[NX][NU];
    load(Ad, ws, W.Ad + k * NX * NX);
    load(Bd, ws, W.Bd + k * NX * NU);
    float xn[NA];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = Ad[i][0] * x[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) t += Ad[i][l] * x[l];
      xn[i] = t + (Bd[i][0] * u[0] + Bd[i][1] * u[1]);
    }
    xn[NX] = u[0];
    xn[NX + 1] = u[1];
    storev(u, ws, W.Usol + k * NU);
    storev(xn, ws, W.Xsol + (k + 1) * NA);
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = xn[i];
  }
  const float no_u[NU] = {0.0f, 0.0f};
  z_update(P, W, ws, s_l, lam_l, N, x, no_u, false, rho, rinv, acc);
  return acc;
}

// Sections 1-8 for lane b, from the state x0 with parameters pv (mu may be
// an estimate) and the lane's (N+1, NX) reference rows xref. Writes the new
// warm start, u0 and stats rows 0-4 (r_prim, r_dual, converged, rho_next,
// done-at) and returns u0. It holds the block's early-exit vote
// (__syncthreads_and), so every thread of the block calls it; lanes past B
// (active false) vote "done" and touch no memory.
template <class M>
__device__ __forceinline__ void mpc_core(const CoreParams<M>& P, int b, bool active,
                                         const float (&x0)[M::NX], const VehParams& pv,
                                         const Lane& xref, const Lane& ws, float (&u0)[NU]) {
  constexpr int NX = M::NX, NA = M::NA;
  const int S = P.B;
  const WsLayout<M> W(P.N);
  const Lane s_l = lane_of(P.s_out, active ? b : 0, S);
  const Lane lam_l = lane_of(P.lam_out, active ? b : 0, S);
  float rho = 1.0f, rinv = 1.0f, da = -1.0f;
  float x0a[NA] = {};
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  if (active) {
    rho = P.rho[b];
    rinv = 1.0f / rho;
    prepare(P, b, W, ws, pv, x0, xref);
    factor(P, W, ws, rho);
    const Lane up = lane_of(P.uprev, b, S);
    for (int i = 0; i < NX; ++i) x0a[i] = x0[i];
    for (int i = 0; i < NU; ++i) x0a[NX + i] = up[i];
    for (int i = 0; i < (P.N + 1) * NA; ++i) ws[W.Xsol + i] = 0.0f;
    for (int i = 0; i < P.N * NU; ++i) ws[W.Usol + i] = 0.0f;
  }

  // 6. ADMM: chunks of `check` iterations, the termination test recorded
  // at each chunk boundary (done-at = first passing boundary).
  const int n_chunks = P.max_iter / P.check;
  const int rem = P.max_iter - n_chunks * P.check;
  if (P.early_exit) {
    bool all_done = false;
    for (int c = 0; c < n_chunks && !all_done; ++c) {
      if (active) {
        for (int i = 0; i < P.check; ++i) acc = admm_iteration(P, W, ws, s_l, lam_l, x0a, rho, rinv);
        if (da < 0.0f && converged(acc, rho, P.eps_abs, P.eps_rel)) da = (float)((c + 1) * P.check);
      }
      all_done = __syncthreads_and(!active || da >= 0.0f);
    }
    if (rem && !all_done && active)
      for (int i = 0; i < rem; ++i) acc = admm_iteration(P, W, ws, s_l, lam_l, x0a, rho, rinv);
  } else if (active) {
    for (int c = 0; c < n_chunks; ++c) {
      for (int i = 0; i < P.check; ++i) acc = admm_iteration(P, W, ws, s_l, lam_l, x0a, rho, rinv);
      if (da < 0.0f && converged(acc, rho, P.eps_abs, P.eps_rel)) da = (float)((c + 1) * P.check);
    }
    for (int i = 0; i < rem; ++i) acc = admm_iteration(P, W, ws, s_l, lam_l, x0a, rho, rinv);
  }
  if (!active) return;

  // 7. residuals / convergence / rho adaptation of the last iteration
  const float r_prim = acc.r_p, r_dual = rho * acc.dual_ds;
  const float eps_prim = P.eps_abs + P.eps_rel * fmaxf(acc.g_max, acc.s_max);
  const float eps_dual = P.eps_abs + P.eps_rel * acc.dual_lam;
  const bool conv = r_prim <= eps_prim && r_dual <= eps_dual;
  const float ratio = sqrtf((r_prim / fmaxf(eps_prim, 1e-12f)) /
                            fmaxf(r_dual / fmaxf(eps_dual, 1e-12f), 1e-12f));
  const float rho_new = clampf(rho * ratio, RHO_MIN, RHO_MAX);
  const float rho_next = (ratio > RHO_TOL || ratio < 1.0f / RHO_TOL) ? rho_new : rho;
  const Lane st = lane_of(P.stats, b, S);
  st[0] = r_prim;
  st[1] = r_dual;
  st[2] = conv ? 1.0f : 0.0f;
  st[3] = rho_next;
  st[4] = da > 0.0f ? da : (float)P.max_iter;

  // 8. accept the solution or take the limp-home controller
  const bool usable = conv || (r_prim < P.eps_fallback && r_dual < P.eps_fallback);
  if (usable) {
    u0[0] = ws[W.Usol];
    u0[1] = ws[W.Usol + 1];
  } else {
    const float kap_now = kap_at(P.kappa, P.n_cells, P.taux[0], P.taux[1], x0[M::S]);
    const float sgn = (float)((x0[0] > 0.0f) - (x0[0] < 0.0f));
    u0[0] = clampf(atanf(kap_now * (pv.lf + pv.lr)) - 0.5f * x0[M::EY] * sgn, -P.delta_max,
                   P.delta_max);
    u0[1] = x0[0] > 2.0f * P.vx_min ? -0.5f : 0.0f;
  }
  const Lane u0_out = lane_of(P.u0_out, b, S);
  u0_out[0] = u0[0];
  u0_out[1] = u0[1];
  const Lane Xp_out = lane_of(P.Xp_out, b, S), Up_out = lane_of(P.Up_out, b, S);
  for (int k = 0; k <= P.N; ++k)
    for (int i = 0; i < NX; ++i)
      Xp_out[k * NX + i] = usable ? ws[W.Xsol + k * NA + i] : ws[W.Xs + k * NX + i];
  for (int k = 0; k < P.N; ++k)
    for (int i = 0; i < NU; ++i)
      Up_out[k * NU + i] = usable ? ws[W.Usol + k * NU + i] : ws[W.Us + k * NU + i];
}

}  // namespace arl

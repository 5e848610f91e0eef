// Racestep: the composed deployment step of every lane in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/racestep_kernel.py::_racestep_kernel, a
// Pallas TPU kernel. Plain PyTorch version:
// ops/racestep_kernel.py::racestep_plain.
//
// Design. A group of G threads owns one lane (a car); a block holds 16
// lanes and 8 blocks the 128 lanes that leave ADMM together, launched as a
// thread block cluster or co-resident (arl_sync.cuh, launch_group; the
// co-resident instantiation takes the device's vote slots as a second
// argument). Each group runs, in order:
//   1. measurement: the nearest centerline node to the world-frame truth
//      among the cells within +-win_cells of the EKF's s, searched in G
//      strided slices and reduced over the group (plain indexed loads, cell
//      ids wrapped mod n_cells, ties to the smallest id), the tangent
//      projection, e_psi by atan2f, the lap unwrap
//      floor((s_hint - s_w) / L + 0.5), plus the pre-scaled noise -> z;
//   2. EKF at mu-hat: n_sub_ekf Euler sub-steps of the Frenet model, the
//      centre and the 6 perturbed model evaluations one per thread, the
//      forward-difference Jacobian, F = prod(I + h J) split by columns,
//      Pp = F P F' + diag(q), optional per-channel gating, S = Pp + diag(R)
//      inverted by unpivoted Gauss-Jordan, K = Pp S^-1, xf = x + K nu,
//      P = sym((I - K) Pp) on every thread of the group;
//   3. friction RLS: axle forces at the midpoint of x_prev_f and xf, two
//      excitation-gated scalar updates with the analytic dFy/dmu (the
//      result is the next step's mu-hat), on every thread of the group;
//   4. references: a RefTable, shared or one per lane, sampled into the
//      lane's workspace rows along the shifted schedule (linear
//      interpolation of vx, e_y and the precomputed e_psi node channel),
//      row k on thread k mod G, or the caller's tensor rows;
//   5. the group tracker core of group_core.cuh at mu-hat (stage operands
//      in shared memory, the 128-lane early-exit vote across the group),
//      with the optional (N+1, 2, B) e_y corridor of obstacle blocks in
//      place of row 1's box (CoreParams::eyb, null without obstacles);
//   6. n_sub Euler sub-steps of the world-frame plant at the lane's true mu,
//      on the group's first thread.
// With a section-counter pointer (tracing on) the traced instantiation runs
// (TRACE, its own translation unit, racestep_traced_kernel.cu): each lane's
// thread 0 adds its cycles in sections 1-4 (RaceSec, in slots of their own)
// and in the core's sections and the plant (group_core.cuh, Sec) into the
// counters; the untraced one reads no clock.
//
// What bounds it on the H100: the operations of the tracker core (~0.18
// MFLOP per lane at N=20 and ~14 executed iterations); a clock64 split of
// the one-thread kernel put 93% of its time in the core (its ADMM loop 65%,
// the stage builds 26%), 3% in the EKF. What stands between it and that
// bound is latency, as in the fused kernel: the group shortens each chain
// by G and keeps the per-iteration operands in shared memory. The
// measurement reads 2 (2 win_cells + 1) table floats per lane from the
// L1/L2-cached pose tables; nothing but the carry crosses device memory
// between stages.
//
// Per-lane reference tables (the TPU kernel's per_lane_refs, one table per
// car) are stored lane-major, (B, n_ref): lane b's row starts at
// b * ref_stride. The group's threads sample its N+1 stages at s values a
// node or so apart, so with a contiguous row their loads fall in one or two
// 32-byte sectors; the TPU's batch-last (n_ref, B) columns would put every
// thread's load in its own sector, B floats away. A shared table has
// stride 0 and stays in L1/L2 for every lane.
#include "group_core.cuh"

namespace arl {

struct RaceParams {
  CoreParams<Dynamic> C;
  // inputs, batch-last
  const float *xg, *ekx, *ekP, *fr, *xprev, *noise, *mu_true, *xref, *prm;
  // tables: pose X, Y, psi (n_cells,), EKF q, r (6,), reference vx, ey,
  // e_psi nodes (n_ref,) shared or (B, n_ref) per lane, reference
  // [length, 1/ds]
  const float *Xt, *Yt, *Pt, *ekq, *ekr, *rvx, *rey, *rep, *rtaux;
  // outputs, batch-last
  float *xg_out, *ekx_out, *ekP_out, *fr_out, *xf_out, *z_out, *ws;
  int n_sub, sim_tire, ws_rows, n_sub_ekf, use_ekf, adapt_mu, use_table, n_ref, ref_stride,
      win_cells;
  Sel<Dynamic> Sl;
  float gate_sigma, forgetting, min_sensitivity, fd_eps, inv_fd_eps;
  // (N_SEC + N_RACE_SEC,) section counters, the core's (Sec) then the
  // racestep's own (RaceSec), or null: tracing off. Last, so that every other
  // member keeps its place in the untraced kernel
  unsigned long long* sec;
};

// The racestep's own sections (utils/profiling.py RACE_SECTIONS names them in
// this order), before the core's: 1. the measurement with its noise; 2. the
// EKF; 3. the friction RLS; 4. the reference rows with the stores of
// sections 1-4 and the group barrier that closes them.
enum RaceSec : int { RSEC_MEASURE, RSEC_EKF, RSEC_RLS, RSEC_REFS, N_RACE_SEC };

constexpr int RACE_PTRS = 41;
constexpr int RACE_INTS = 20;
constexpr int RACE_FLOATS = core_floats<Dynamic>() + 5;
constexpr float MU_MIN = 0.1f;
constexpr float MU_MAX = 1.5f;

// s wrapped into [0, length), rounded as the plain version rounds it.
__device__ __forceinline__ float wrap_s(float s, float length) {
  return __fsub_rn(s, __fmul_rn(length, floorf(__fdiv_rn(s, length))));
}

// World-frame dynamic bicycle ODE, xg = (vx, vy, wz, X, Y, psi).
__device__ __forceinline__ void f_global(const VehParams& pv, const float (&x)[NX],
                                         const float (&u)[NU], int tire, float (&dx)[NX]) {
  const float vx = x[0], vy = x[1], wz = x[2], psi = x[5];
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
  const float sp = sinf(psi), cp = cosf(psi);
  dx[0] = a - (fyf * sd) / pv.m + wz * vy - (pv.cd0 + pv.cd1 * vx) / pv.m;
  dx[1] = (fyf * cd + fyr) / pv.m - wz * vx;
  dx[2] = (pv.lf * fyf * cd - pv.lr * fyr) / pv.Iz;
  dx[3] = vx * cp - vy * sp;
  dx[4] = vx * sp + vy * cp;
  dx[5] = wz;
}

// Magic formula Fy = mu fz sin(C atan(B alpha)), B = stiff / (C mu fz), and
// its analytic dFy/dmu = fz [sin th - cos th C t / (1 + t^2)].
__device__ __forceinline__ void pacejka_mu_sensitivity(float mu, float alpha, float stiff,
                                                       float fz, float& fy, float& dfy) {
  const float D = fmaxf(mu * fz, 1e-6f);
  const float t = stiff / (PACEJKA_C * D) * alpha;
  const float th = PACEJKA_C * atanf(t);
  const float s = sinf(th), c = cosf(th);
  fy = mu * fz * s;
  dfy = fz * (s - c * PACEJKA_C * t / (1.0f + t * t));
}

// In-place inverse of an SPD 6x6 matrix by Gauss-Jordan without pivoting
// (an innovation covariance: positive diagonal, no vanishing pivot).
__device__ __forceinline__ void inv6(float (&M)[NX][NX], float (&Inv)[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Inv[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const float rec = 1.0f / M[j][j];
    float Mj[NX], Ij[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      Mj[c] = M[j][c] * rec;
      Ij[c] = Inv[j][c] * rec;
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      const float fac = M[r][j];
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        M[r][c] = r == j ? Mj[c] : M[r][c] - fac * Mj[c];
        Inv[r][c] = r == j ? Ij[c] : Inv[r][c] - fac * Ij[c];
      }
    }
  }
}

// 1. The Frenet measurement of the world-frame pose, hint-windowed: the
// window's cells in G strided slices, each slice's nearest node, then the
// group's lexicographic minimum of (squared distance, cell id) — the
// serial search's rule, nearest node with ties to the smallest cell id.
template <int G>
__device__ __forceinline__ void measure(const RaceParams& P, const float (&xg)[NX], float s_hint,
                                        const Grp<G>& gr, float (&z)[NX]) {
  const int n = P.C.n_cells, W = P.win_cells;
  const float length = P.C.taux[0], inv_ds = P.C.taux[1];
  const float ds = 1.0f / inv_ds;
  const float Xw = xg[3], Yw = xg[4], psiw = xg[5];
  const int i_hint = min(max(__float2int_rz(__fmul_rn(wrap_s(s_hint, length), inv_ds)), 0), n - 1);
  float best = INFINITY;
  int i_star = n;
  const bool all = 2 * W + 1 >= n;
  const int lo = all ? 0 : -W, hi = all ? n - 1 : W;
  for (int d = lo + gr.g; d <= hi; d += G) {
    int c = all ? d : i_hint + d;
    if (c < 0) c += n;
    if (c >= n) c -= n;
    const float dx = __fsub_rn(Xw, __ldg(P.Xt + c)), dy = __fsub_rn(Yw, __ldg(P.Yt + c));
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    if (d2 < best || (d2 == best && c < i_star)) {
      best = d2;
      i_star = c;
    }
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) {
    const float ob = gr.xchg(best, m);
    const int oi = gr.xchg(i_star, m);
    if (ob < best || (ob == best && oi < i_star)) {
      best = ob;
      i_star = oi;
    }
  }
  const float Pi = __ldg(P.Pt + i_star);
  const float tx = cosf(Pi), ty = sinf(Pi);
  const float ddx = __fsub_rn(Xw, __ldg(P.Xt + i_star)), ddy = __fsub_rn(Yw, __ldg(P.Yt + i_star));
  const float along = __fadd_rn(__fmul_rn(ddx, tx), __fmul_rn(ddy, ty));
  const float e_y = __fadd_rn(__fmul_rn(-ddx, ty), __fmul_rn(ddy, tx));
  const float s_w = wrap_s(__fadd_rn(__fmul_rn((float)i_star, ds), along), length);
  const float dpsi = psiw - (Pi + kap_at(P.C.kappa, n, length, inv_ds, s_w) * along);
  const float e_psi = atan2f(sinf(dpsi), cosf(dpsi));
  const float lap = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(s_hint, s_w), length), 0.5f));
  z[0] = xg[0];
  z[1] = xg[1];
  z[2] = xg[2];
  z[3] = e_psi;
  z[4] = __fadd_rn(s_w, __fmul_rn(lap, length));
  z[5] = e_y;
}

// 2. EKF predict + update at pv (mu = mu-hat): xf, and P in place. Per
// Euler sub-step, the centre evaluation and the NX perturbed ones go one
// per thread (evaluation e on thread e mod G), and F = (I + h J) F is split
// by the columns of F; the update runs on every thread of the group.
template <int G>
__device__ __forceinline__ void ekf(const RaceParams& P, const VehParams& pv,
                                    const float (&u_prev)[NU], const float (&z)[NX],
                                    const Grp<G>& gr, float (&x)[NX], float (&Pm)[NX][NX]) {
  constexpr int NE = NX + 1, RE = (NE + G - 1) / G, RF = (NX + G - 1) / G;
  const float length = P.C.taux[0], inv_ds = P.C.taux[1];
  const float h = P.C.dt / (float)P.n_sub_ekf;
  float Fc[RF][NX];   // columns c = g + G t of F
#pragma unroll
  for (int t = 0; t < RF; ++t)
#pragma unroll
    for (int i = 0; i < NX; ++i) Fc[t][i] = i == gr.g + G * t ? 1.0f : 0.0f;
  for (int it = 0; it < P.n_sub_ekf; ++it) {
    const float kap = kap_at(P.C.kappa, P.C.n_cells, length, inv_ds, x[4]);
    // evaluation e: the centre (e = 0) or x + fd_eps in state e - 1
    float fe[RE][NX];
#pragma unroll
    for (int t = 0; t < RE; ++t) {
      const int e = min(gr.g + G * t, NE - 1);
      float xp[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xp[i] = i == e - 1 ? x[i] + P.fd_eps : x[i];
      f_dynamic(pv, xp, u_prev, kap, P.C.tire, fe[t]);
    }
    float fx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) fx[i] = gr.bcast(fe[0][i], 0);
    // column e - 1 of I + h J on the thread of evaluation e, then all of it
    float Gm[NX][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float own[RE];
#pragma unroll
      for (int t = 0; t < RE; ++t) own[t] = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int t = 0; t < RE; ++t)
          own[t] = (i == j ? 1.0f : 0.0f) + h * ((fe[t][i] - fx[i]) * P.inv_fd_eps);
        Gm[i][j] = gr.bcast(own[(j + 1) / G], (j + 1) % G);
      }
    }
#pragma unroll
    for (int t = 0; t < RF; ++t) {
      float Fn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = Gm[i][0] * Fc[t][0];
#pragma unroll
        for (int m = 1; m < NX; ++m) acc += Gm[i][m] * Fc[t][m];
        Fn[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) Fc[t][i] = Fn[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + h * fx[i];
  }
  float F[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int c = 0; c < NX; ++c) F[i][c] = gr.bcast(Fc[c / G][i], c % G);
  // Pp = F (P F') + diag(q)
  float T[NX][NX], Pp[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      float acc = Pm[i][0] * F[l][0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc += Pm[i][j] * F[l][j];
      T[i][l] = acc;
    }
  mm(F, T, Pp);
  float nu[NX], Rd[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Pp[i][i] += __ldg(P.ekq + i);
    nu[i] = z[i] - x[i];
    Rd[i] = __ldg(P.ekr + i);
  }
  if (P.gate_sigma > 0.0f) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float s0 = Pp[i][i] + Rd[i];
      if (fabsf(nu[i]) > P.gate_sigma * sqrtf(s0)) Rd[i] += 1e6f * s0;
    }
  }
  float Sm[NX][NX], Sinv[NX][NX], K[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Sm[i][j] = i == j ? Pp[i][j] + Rd[i] : Pp[i][j];
  inv6(Sm, Sinv);
  mm(Pp, Sinv, K);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float acc = K[i][0] * nu[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) acc += K[i][j] * nu[j];
    x[i] = x[i] + acc;
  }
  // P <- sym((I - K) Pp)
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      float acc = ((i == 0 ? 1.0f : 0.0f) - K[i][0]) * Pp[0][l];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc += ((i == j ? 1.0f : 0.0f) - K[i][j]) * Pp[j][l];
      T[i][l] = acc;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Pm[i][j] = 0.5f * (T[i][j] + T[j][i]);
}

// 3. One step of the friction RLS; returns the updated [mu, P].
__device__ __forceinline__ void friction_rls(const RaceParams& P, const VehParams& pv,
                                             const float (&xp)[NX], const float (&xf)[NX],
                                             const float (&u_prev)[NU], float& mu, float& Pr) {
  const float dt = P.C.dt;
  const float vx = 0.5f * (xp[0] + xf[0]), vy = 0.5f * (xp[1] + xf[1]), wz = 0.5f * (xp[2] + xf[2]);
  const float delta = u_prev[0];
  const float y1 = pv.m * ((xf[1] - xp[1]) / dt + wz * vx);
  const float y2 = pv.Iz * ((xf[2] - xp[2]) / dt);
  const float L = pv.lf + pv.lr;
  float cd = cosf(delta);
  if (fabsf(cd) < 0.1f) cd = 0.1f;
  const float vxs = fmaxf(vx, VX_EPS);
  const float y_m[2] = {(pv.lr * y1 + y2) / (L * cd), (pv.lf * y1 - y2) / L};
  const float a_x[2] = {delta - atan2f(vy + pv.lf * wz, vxs), -atan2f(vy - pv.lr * wz, vxs)};
  const float stiff[2] = {pv.Cf, pv.Cr};
  const float fz[2] = {pv.m * pv.g * pv.lr / L, pv.m * pv.g * pv.lf / L};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float hval, J;
    pacejka_mu_sensitivity(mu, a_x[a], stiff[a], fz[a], hval, J);
    if (fabsf(J) >= P.min_sensitivity * fz[a]) {
      const float K = Pr * J / (P.forgetting + J * Pr * J);
      const float mu2 = clampf(mu + K * (y_m[a] - hval), MU_MIN, MU_MAX);
      Pr = (Pr - K * J * Pr) / P.forgetting;
      mu = mu2;
    }
  }
}

// 4. The lane's (N+1, NX) reference rows from its table (the shared one, or
// its own row of the per-lane tables), sampled at the shifted schedule's s:
// row 0 at xf, row k at X_pred[min(k+1, N)]. Row k on thread k mod G.
template <int G>
__device__ __forceinline__ void table_refs(const RaceParams& P, int b, float s0, const Grp<G>& gr,
                                           const Lane& rows) {
  const int N = P.C.N, S = P.C.B, n = P.n_ref;
  const Lane Xp = lane_of(P.C.Xp, b, S);
  const float Lt = P.rtaux[0], inv_dst = P.rtaux[1];
  const size_t row = (size_t)b * P.ref_stride;
  const float *rvx = P.rvx + row, *rey = P.rey + row, *rep = P.rep + row;
  for (int k = gr.g; k <= N; k += G) {
    const float s = k == 0 ? s0 : Xp[min(k + 1, N) * NX + 4];
    const float ff = __fmul_rn(wrap_s(s, Lt), inv_dst);
    const int i0 = min(max(__float2int_rz(ff), 0), n - 1);
    const int i1 = i0 + 1 == n ? 0 : i0 + 1;
    const float t = __fsub_rn(ff, (float)i0), w0 = 1.0f - t;
    const float vx = __fadd_rn(__fmul_rn(__ldg(rvx + i0), w0), __fmul_rn(__ldg(rvx + i1), t));
    const float ey = __fadd_rn(__fmul_rn(__ldg(rey + i0), w0), __fmul_rn(__ldg(rey + i1), t));
    const float ep = __fadd_rn(__fmul_rn(__ldg(rep + i0), w0), __fmul_rn(__ldg(rep + i1), t));
    rows[k * NX + 0] = vx;
    rows[k * NX + 1] = 0.0f;
    rows[k * NX + 2] = 0.0f;
    rows[k * NX + 3] = ep;
    rows[k * NX + 4] = 0.0f;
    rows[k * NX + 5] = ey;
  }
}

// `vote`: empty (clustered), or the device's vote slots (co-resident;
// arl_sync.cuh, launch_group).
template <bool SM, bool TRACE, class... Vote>
__global__ void __launch_bounds__(GROUP_THREADS) racestep_kernel(const __grid_constant__ RaceParams P,
                                                                 Vote... vote) {
  const Grp<LANE_THREADS> gr;
  const int lane = threadIdx.x / LANE_THREADS;
  const int b = blockIdx.x * BLOCK_LANES + lane;
  const int S = P.C.B;
  const bool active = b < S;
  const WsLayout<Dynamic> W(P.C.N);
  const Lane ws = lane_of(P.ws, active ? b : 0, S);
  const Ops<SM> op = ops_of<Dynamic, SM>(P.C.N, lane, P.ws, active ? b : 0, S);
  sec_begin<TRACE>();
  sec_begin<TRACE, N_RACE_SEC>();
  VehParams pv{}, pv_hat{};
  float xf[NX] = {}, xg[NX] = {}, z[NX] = {}, Pm[NX][NX], u_prev[NU] = {};
  float mu = 0.0f, Pr = 0.0f;
  Lane xref = lane_of(P.ws, 0, S);
  if (active) {
    pv = load_params(P.prm, b, S);
    const Lane fr = lane_of(P.fr, b, S);
    mu = fr[0];
    Pr = fr[1];
    pv_hat = pv;
    if (P.adapt_mu) pv_hat.mu = mu;
    const Lane xgl = lane_of(P.xg, b, S), ekx = lane_of(P.ekx, b, S), up = lane_of(P.C.uprev, b, S);
    const Lane noise = lane_of(P.noise, b, S), ekP = lane_of(P.ekP, b, S);
    for (int i = 0; i < NX; ++i) xg[i] = xgl[i];
    for (int i = 0; i < NU; ++i) u_prev[i] = up[i];
    load(Pm, ekP, 0);

    // 1. measurement
    sec_open<TRACE, N_RACE_SEC>(gr.g, RSEC_MEASURE);
    measure(P, xg, ekx[4], gr, z);
    for (int i = 0; i < NX; ++i) z[i] += noise[i];

    // 2. EKF at mu-hat
    sec_switch<TRACE, N_RACE_SEC>(gr.g, RSEC_MEASURE, RSEC_EKF);
    if (P.use_ekf) {
      for (int i = 0; i < NX; ++i) xf[i] = ekx[i];
      ekf(P, pv_hat, u_prev, z, gr, xf, Pm);
    } else {
      for (int i = 0; i < NX; ++i) xf[i] = z[i];
    }

    // 3. friction RLS: the next step's mu-hat (every thread of the group)
    sec_switch<TRACE, N_RACE_SEC>(gr.g, RSEC_EKF, RSEC_RLS);
    if (P.adapt_mu) {
      float xp[NX];
      const Lane xpl = lane_of(P.xprev, b, S);
      for (int i = 0; i < NX; ++i) xp[i] = xpl[i];
      friction_rls(P, pv, xp, xf, u_prev, mu, Pr);
    }

    // 4. references
    sec_switch<TRACE, N_RACE_SEC>(gr.g, RSEC_RLS, RSEC_REFS);
    if (P.use_table) {
      xref = Lane{ws.p + (size_t)W.total * S, S};
      table_refs(P, b, xf[4], gr, xref);
    } else {
      xref = lane_of(P.xref, b, S);
    }

    if (gr.g == 0) {
      const Lane ekx_out = lane_of(P.ekx_out, b, S), xf_out = lane_of(P.xf_out, b, S);
      const Lane z_out = lane_of(P.z_out, b, S), fr_out = lane_of(P.fr_out, b, S);
      for (int i = 0; i < NX; ++i) {
        ekx_out[i] = xf[i];
        xf_out[i] = xf[i];
        z_out[i] = z[i];
      }
      store(Pm, lane_of(P.ekP_out, b, S), 0);
      fr_out[0] = mu;
      fr_out[1] = Pr;
    }
    gr.sync();
    sec_close<TRACE, N_RACE_SEC>(gr.g, RSEC_REFS);
  }

  // 5. tracker at mu-hat
  float u0[NU];
  mpc_core_g(P.C, P.Sl, b, active, xf, pv_hat, xref, ws, op, gr, u0, nullptr,
             std::bool_constant<false>{}, std::bool_constant<TRACE>{}, vote...);
  if (!active || gr.g != 0) {
    sec_end<TRACE>(P.sec, gr.g);
    sec_end<TRACE, N_RACE_SEC>(P.sec + N_SEC, gr.g);
    return;
  }
  sec_switch<TRACE>(0, SEC_FINISH, SEC_PLANT);
  const Lane st = lane_of(P.C.stats, b, S);
  st[5] = mu;
  st[6] = 0.0f;
  st[7] = 0.0f;

  // 6. plant: world-frame Euler sub-steps at the lane's true mu
  VehParams pv_plant = pv;
  pv_plant.mu = P.mu_true[b];
  const float hp = P.C.dt / (float)P.n_sub;
  for (int it = 0; it < P.n_sub; ++it) {
    float dx[NX];
    f_global(pv_plant, xg, u0, P.sim_tire, dx);
#pragma unroll
    for (int j = 0; j < NX; ++j) xg[j] = xg[j] + hp * dx[j];
  }
  const Lane xg_out = lane_of(P.xg_out, b, S);
  for (int i = 0; i < NX; ++i) xg_out[i] = xg[i];
  sec_close<TRACE>(0, SEC_PLANT);
  sec_end<TRACE>(P.sec, 0);
  sec_end<TRACE, N_RACE_SEC>(P.sec + N_SEC, 0);
}

// The traced instantiations are compiled in a translation unit of their own
// (racestep_traced_kernel.cu, which includes this file with
// ARL_RACESTEP_TRACED_TU defined), so that its nvcc runs beside this one's.
template <bool SM>
int launch_racestep_traced(const RaceParams& P, int grid, int smem, void* stream);

#if defined(ARL_RACESTEP_TRACED_TU)
template <bool SM>
int launch_racestep_traced(const RaceParams& P, int grid, int smem, void* stream) {
  return launch_group(racestep_kernel<SM, true>, racestep_kernel<SM, true, VoteSlot*>, P, grid,
                      smem, stream, "racestep_kernel", P.C.early_exit != 0);
}

template int launch_racestep_traced<true>(const RaceParams&, int, int, void*);
template int launch_racestep_traced<false>(const RaceParams&, int, int, void*);

}  // namespace arl
#else
template <bool SM>
int launch_racestep_as(const RaceParams& P, int grid, int smem, void* stream) {
  return P.sec ? launch_racestep_traced<SM>(P, grid, smem, stream)
               : launch_group(racestep_kernel<SM, false>, racestep_kernel<SM, false, VoteSlot*>, P,
                              grid, smem, stream, "racestep_kernel", P.C.early_exit != 0);
}

}  // namespace arl

// C entry: device pointers (the corridor, the last input, may be null; last
// the section counters, null with tracing off), float and int parameters in
// the order of ops/racestep_kernel.py::_racestep_cuda (the last two ints:
// operands in shared memory, its bytes per block). Returns -1 on an operand-count
// mismatch, -2 on a workspace- or shared-memory-size mismatch, -3 on a bad
// size, -4 if the card cannot hold one cluster of the shape (a launch that
// takes the clustered path), else the CUDA error of the launch.
extern "C" int arl_racestep(void** ptrs, int n_ptrs, const float* fv, int n_f, const int* iv,
                            int n_i, int device, void* stream) {
  using namespace arl;
  if (n_ptrs != RACE_PTRS || n_f != RACE_FLOATS || n_i != RACE_INTS) return -1;
  RaceParams P;
  CoreParams<Dynamic>& C = P.C;
  const float** in[] = {&P.xg, &P.ekx, &P.ekP, &P.fr, &P.xprev, &P.noise, &P.mu_true,
                        &C.Xp, &C.Up, &C.sw, &C.lamw, &C.uprev, &C.rho, &P.xref, &P.prm,
                        &C.kappa, &C.taux, &P.Xt, &P.Yt, &P.Pt, &P.ekq, &P.ekr,
                        &P.rvx, &P.rey, &P.rep, &P.rtaux, &C.eyb};
  float** out[] = {&P.xg_out, &P.ekx_out, &P.ekP_out, &P.fr_out, &P.xf_out, &P.z_out,
                   &C.Xp_out, &C.Up_out, &C.s_out, &C.lam_out, &C.u0_out, &C.stats, &P.ws};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  P.sec = static_cast<unsigned long long*>(ptrs[p++]);
  int ops_smem = 0, smem = 0;
  int* ints[] = {&C.B, &C.N, &C.n_cells, &P.n_sub, &C.max_iter, &C.check, &C.early_exit,
                 &C.tire, &P.sim_tire, &C.kappa_speed_cap, &P.ws_rows, &P.n_sub_ekf,
                 &P.use_ekf, &P.adapt_mu, &P.use_table, &P.n_ref, &P.ref_stride, &P.win_cells,
                 &ops_smem, &smem};
  for (int i = 0; i < RACE_INTS; ++i) *ints[i] = iv[i];
  read_core_floats(C, fv);
  if (!make_sel(C, P.Sl)) return -1;
  float* extra[] = {&P.gate_sigma, &P.forgetting, &P.min_sensitivity, &P.fd_eps, &P.inv_fd_eps};
  for (int i = 0; i < 5; ++i) *extra[i] = fv[core_floats<Dynamic>() + i];
  if (P.ws_rows != WsLayout<Dynamic>(C.N).total + (C.N + 1) * NX) return -2;
  if (smem != (ops_smem ? BLOCK_LANES * OpsLayout<Dynamic>(C.N).total * 4 : 0)) return -2;
  if (C.B < 1 || C.N < 1 || C.check < 1 || C.max_iter < 1 || P.n_sub < 1 || P.n_sub_ekf < 1 ||
      C.n_cells < 1 || (P.use_table && P.n_ref < 1) || P.ref_stride < 0)
    return -3;
  cudaSetDevice(device);
  const int grid = (C.B + BLOCK - 1) / BLOCK * CLUSTER;
  return ops_smem ? launch_racestep_as<true>(P, grid, smem, stream)
                  : launch_racestep_as<false>(P, grid, smem, stream);
}
#endif  // ARL_RACESTEP_TRACED_TU

// The tracker core for a group of G threads per lane, the only tracker
// core of the port: the megastep (both models), the racestep and the fused
// kernel run it (sections 1-8 of one receding-horizon step: schedule shift,
// curvature + friction-cap bounds, LPV + Van Loan + linear cost, warm-start
// shift, Riccati factor, ADMM in chunks of `check` iterations with the
// 128-lane early-exit vote, residuals / rho, accept or limp-home). Its
// parameters, constants and workspace layout are in mpc_core.cuh.
//
// Work split (thread g of the lane's group, Grp<G> of arl_sync.cuh):
// - stage builds, bounds, linear cost, warm start: the stages k = g mod G;
// - Riccati factor: the recursion over k stays serial; thread g owns rows
//   (and columns) g, g + G, ... of V, VB, VA, Hux and K; Huu and its 2x2
//   inverse are formed by every thread from the broadcast VB;
// - ADMM sweeps: the mat-vecs split by rows (each thread its rows of the
//   affine backward vector and of the forward state), the vector broadcast
//   by shuffle at every stage; the z-update puts the NC constraint rows on
//   threads 0..NC-1;
// - residual maxima: per thread, max-reduced over the group at each test.
// The selector rows D = [Dx Du] (ops/fused_kernel.py::_make_consts) are
// applied as the gathers they are (Sel: at most two +-1 entries per row and
// per column), not as dense products.
//
// The per-iteration operands of every stage (Ad, Bd, K, Hux, Hiv, d) live in
// the block's dynamic shared memory, one slice per lane (OpsLayout), or,
// where N makes the block's slices exceed what a block may hold, in the
// device-memory workspace (WsLayout slots, batch-last); the wrapper chooses
// by N (ops/fused_kernel.py::launch_shape).
#pragma once

#include <type_traits>

#include "arl_sync.cuh"
#include "mpc_core.cuh"

namespace arl {

// The selector rows as gathers: row c of D z (z = [x; u]) and column j of
// D' y, each at most two (index, coefficient) pairs; unused pairs have
// coefficient 0 and index 0.
template <class M>
struct Sel {
  static constexpr int NZ = M::NA + NU;
  int row_idx[NC][2];
  float row_coef[NC][2];
  int col_row[NZ][2];
  float col_coef[NZ][2];
};

// Sel of the selector rows D(c, j) = [Dx Du]; false if a row or column has
// more than two entries.
#pragma nv_exec_check_disable
template <class M, class F>
__host__ __device__ inline bool sel_from(F D, Sel<M>& S) {
  constexpr int NZ = Sel<M>::NZ;
  for (int c = 0; c < NC; ++c) {
    int n = 0;
    for (int t = 0; t < 2; ++t) S.row_idx[c][t] = 0, S.row_coef[c][t] = 0.0f;
    for (int j = 0; j < NZ; ++j)
      if (D(c, j) != 0.0f) {
        if (n == 2) return false;
        S.row_idx[c][n] = j;
        S.row_coef[c][n++] = D(c, j);
      }
  }
  for (int j = 0; j < NZ; ++j) {
    int n = 0;
    for (int t = 0; t < 2; ++t) S.col_row[j][t] = 0, S.col_coef[j][t] = 0.0f;
    for (int c = 0; c < NC; ++c)
      if (D(c, j) != 0.0f) {
        if (n == 2) return false;
        S.col_row[j][n] = c;
        S.col_coef[j][n++] = D(c, j);
      }
  }
  return true;
}

// Sel of P's Dx, Du (on the host).
template <class M>
inline bool make_sel(const CoreParams<M>& P, Sel<M>& S) {
  return sel_from<M>([&](int c, int j) { return j < M::NA ? P.Dx[c][j] : P.Du[c][j - M::NA]; }, S);
}

// One lane's slice of the ADMM operands in shared memory (floats): Ad, Bd,
// the first nx columns of Hux (the rest is the constant Mf'), Hiv and the
// affine term d of every stage; the linear terms of the backward sweep qt
// (N+1, na) and rt (N, NU); the iterate X (N+1, na), U (N, NU).
template <class M>
struct OpsLayout {
  int Ad, Bd, Hux, Hiv, d, qt, rt, X, U, total;
  __host__ __device__ explicit OpsLayout(int N) {
    constexpr int nx = M::NX, na = M::NA;
    int o = 0;
    Ad = o;  o += N * nx * nx;
    Bd = o;  o += N * nx * NU;
    Hux = o; o += N * NU * nx;
    Hiv = o; o += N * NU * NU;
    d = o;   o += N * NU;
    qt = o;  o += (N + 1) * na;
    rt = o;  o += N * NU;
    X = o;   o += (N + 1) * na;
    U = o;   o += N * NU;
    total = o;
  }
};

// The ADMM operands of one lane: in shared memory (SM, stride 1: the
// compiler addresses it as shared memory) or in the device-memory workspace
// (stride B), where they take the slots of WsLayout: qt the gains' slot K,
// rt the unused tail of Hux's.
template <bool SM>
struct Ops {
  float* p;
  int stride, Ad, Bd, Hux, Hiv, d, qt, rt, X, U;
  __device__ __forceinline__ float& operator[](int i) const {
    if constexpr (SM) return p[i];
    else return p[(size_t)i * stride];
  }
};

template <class M, bool SM>
__device__ __forceinline__ Ops<SM> ops_of(int N, int lane, float* ws, int b, int S) {
  if constexpr (SM) {
    const OpsLayout<M> L(N);
    return Ops<SM>{dyn_smem() + lane * L.total, 1, L.Ad, L.Bd, L.Hux, L.Hiv, L.d, L.qt, L.rt,
                   L.X, L.U};
  } else {
    const WsLayout<M> W(N);
    return Ops<SM>{ws + b, S, W.Ad, W.Bd, W.Hux, W.Hiv, W.d, W.K, W.Hux + N * NU * M::NX, W.Xsol,
                   W.Usol};
  }
}

__device__ __forceinline__ Lane sub(const Lane& a, int off) {
  return Lane{a.p + (size_t)off * a.stride, a.stride};
}

// v[i] for a runtime i, without indexing a register array.
template <int R>
__device__ __forceinline__ float pick(const float (&v)[R], int i) {
  float r = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q) r = i == q ? v[q] : r;
  return r;
}

// All R entries of a vector whose entry i is held by thread i % G in slot
// i / G.
template <int G, int R>
__device__ __forceinline__ void gather(const Grp<G>& gr, const float (&own)[(R + G - 1) / G],
                                       float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = gr.bcast(own[i / G], i % G);
}

template <int G>
__device__ __forceinline__ Resid group_max(const Grp<G>& gr, const Resid& a) {
  return Resid{gr.max(a.r_p), gr.max(a.dual_ds), gr.max(a.g_max), gr.max(a.s_max),
               gr.max(a.dual_lam)};
}

// The megastep's discretization cache (SolverConfig.cache_build; JAX
// ops/megastep_kernel.py::_mpc_core, cache_in / cache_out), batch-last:
// the stage matrices Ad (N, nx, nx, B) and Bd (N, nx, NU, B), the schedule
// each stage was built at, Xs (N, nx, B), Us (N, NU, B) and kap (N, B), and
// the steps since the last full build, age (1, B). The kernel reads the
// *_in arrays and writes the *_out ones: the shift reads stage k + 1 where
// another thread of the group writes stage k.
struct CacheIO {
  const float *A, *B, *Xs, *Us, *kap, *age;
  float *A_out, *B_out, *Xs_out, *Us_out, *kap_out, *age_out;
  float tol;     // cache_drift_tol
  int max_age;   // cache_max_age
};

// The iteration's per-lane arrays in device memory: linear cost q0
// (N+1, nx), bounds lb/ub (N+1, NC), the split s and dual lam (N+1, NC).
struct IterLanes {
  Lane q0, lb, ub, s, lam;
};

// Stage k's LPV (A, B) at the scheduled (x, u, kappa), discretized by Van
// Loan (its Horner terms scaled by reciprocals) into the operand slots.
template <class M, class O>
__device__ __forceinline__ void build_stage(const O& op, int k, const float (&xk)[M::NX],
                                            const float (&uk)[NU], float kap, const VehParams& pv,
                                            int tire, float dt) {
  constexpr int NX = M::NX;
  float Ac[NX][NX], Bc[NX][NU], Ad[NX][NX], Bd[NX][NU];
  M::ab_cont(xk, uk, kap, pv, tire, Ac, Bc);
  vanloan<NX>(Ac, Bc, dt, Ad, Bd);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) op[op.Ad + k * NX * NX + i * NX + j] = Ad[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) op[op.Bd + k * NX * NU + i * NU + j] = Bd[i][j];
  }
}

// Section 5, the backward Riccati factorization of the rho-folded cost,
// split by rows: writes Hux and Hiv of every stage (the forward
// rollout forms u = -Hiv (Hux x) + d, the gain K = -Hiv Hux applied). Thread g owns
// rows r = g + G j of V; since V is symmetric, Ba'V = VB' and Ba'V Aa = VB'Aa,
// so Huu, Hux and the symmetric Aa'V Aa come from the broadcast VB and VA.
template <class M, int G, class O>
__device__ void factor_g(const CoreParams<M>& P, const O& op, float rho, const Grp<G>& gr) {
  constexpr int NX = M::NX, NA = M::NA, RA = (NA + G - 1) / G;
  const int g = gr.g;
  float V[RA][NA], mf[RA][NU];
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = min(g + G * j, NA - 1);
#pragma unroll
    for (int c = 0; c < NA; ++c) V[j][c] = P.Qtc[r][c] + P.DxDx[r][c] * rho;
#pragma unroll
    for (int a = 0; a < NU; ++a) mf[j][a] = P.Mc[r][a] + P.DxDu[r][a] * rho;
  }
  for (int k = P.N - 1; k >= 0; --k) {
    const int oA = op.Ad + k * NX * NX, oB = op.Bd + k * NX * NU;
    float Bd[NX][NU];
#pragma unroll
    for (int l = 0; l < NX; ++l)
#pragma unroll
      for (int c = 0; c < NU; ++c) Bd[l][c] = op[oB + l * NU + c];
    // VB = V Ba (own rows), then every row
    float VBo[RA][NU], VB[NA][NU];
#pragma unroll
    for (int j = 0; j < RA; ++j)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = V[j][0] * Bd[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += V[j][l] * Bd[l][c];
        VBo[j][c] = acc + V[j][NX + c];
      }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float own[RA], col[NA];
#pragma unroll
      for (int j = 0; j < RA; ++j) own[j] = VBo[j][c];
      gather<G, NA>(gr, own, col);
#pragma unroll
      for (int i = 0; i < NA; ++i) VB[i][c] = col[i];
    }
    // Huu = Rf + Ba' V Ba and its inverse, on every thread
    float Huu[NU][NU], Hiv[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = Bd[0][a] * VB[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += Bd[l][a] * VB[l][c];
        Huu[a][c] = (P.Rc[a][c] + P.DuDu[a][c] * rho) + (acc + VB[NX + a][c]);
      }
    inv2(Huu, Hiv);
    // VA = V Aa (own rows, first NX columns); Hux = Mf' + VB' Aa and
    // K = -Hiv Hux (own columns)
    float VAo[RA][NX], Huxo[RA][NU], Ko[RA][NU];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = g + G * j, rc = min(r, NX - 1);
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float acc = V[j][0] * op[oA + m];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += V[j][l] * op[oA + l * NX + m];
        VAo[j][m] = acc;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float acc = VB[0][a] * op[oA + rc];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc += VB[l][a] * op[oA + l * NX + rc];
        Huxo[j][a] = r < NX ? mf[j][a] + acc : mf[j][a];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) Ko[j][a] = -(Hiv[a][0] * Huxo[j][0] + Hiv[a][1] * Huxo[j][1]);
      if (r < NX)
#pragma unroll
        for (int a = 0; a < NU; ++a) op[op.Hux + k * NU * NX + a * NX + r] = Huxo[j][a];
    }
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) op[op.Hiv + k * NU * NU + a * NU + c] = Hiv[a][c];
    // every column of Hux and K, every row l < NX of VA
    float HuxA[NU][NA], KA[NU][NA], VA[NX][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float oh[RA], ok[RA], ch[NA], ck[NA];
#pragma unroll
      for (int j = 0; j < RA; ++j) oh[j] = Huxo[j][a], ok[j] = Ko[j][a];
      gather<G, NA>(gr, oh, ch);
      gather<G, NA>(gr, ok, ck);
#pragma unroll
      for (int i = 0; i < NA; ++i) HuxA[a][i] = ch[i], KA[a][i] = ck[i];
    }
#pragma unroll
    for (int l = 0; l < NX; ++l)
#pragma unroll
      for (int m = 0; m < NX; ++m) VA[l][m] = gr.bcast(VAo[l / G][m], l % G);
    // V <- sym(Qf + Aa' V Aa + Hux' K): row r from the row and the column
    // of the unsymmetrized update
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = min(g + G * j, NA - 1), rc = min(r, NX - 1);
      const bool rx = g + G * j < NX;
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        float ava = 0.0f;
        if (c < NX) {
          ava = op[oA + rc] * VA[0][c];
#pragma unroll
          for (int l = 1; l < NX; ++l) ava += op[oA + l * NX + rc] * VA[l][c];
          ava = rx ? ava : 0.0f;
        }
        const float qf = P.Qc[r][c] + P.DxDx[r][c] * rho;
        const float vrow = qf + ava + (Huxo[j][0] * KA[0][c] + Huxo[j][1] * KA[1][c]);
        const float vcol = qf + ava + (HuxA[0][c] * Ko[j][0] + HuxA[1][c] * Ko[j][1]);
        V[j][c] = 0.5f * (vrow + vcol);
      }
    }
  }
}

// The z-update of stage k from its z = [x_k; u_k] (u absent at the
// terminal stage): G = D z by the row gathers, relaxed projection, prox for
// the soft rows, dual step into s and lam (and their lanes s_l, lam_l), the
// dual norms D'ds and D'lam by the column gathers; the maxima into acc.
template <class M>
__device__ __forceinline__ void z_update_stage(const Sel<M>& S, const float (&soft)[NC],
                                               float alpha, float rho, float rinv,
                                               const float (&zz)[M::NA + NU], bool has_u,
                                               const float (&lb)[NC], const float (&ub)[NC],
                                               float (&s)[NC], float (&lam)[NC], const Lane& s_l,
                                               const Lane& lam_l, int k, Resid& acc) {
  constexpr int NA = M::NA, NZ = NA + NU;
  float ds[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float Gc = S.row_coef[c][0] * pick(zz, S.row_idx[c][0]) +
                     S.row_coef[c][1] * pick(zz, S.row_idx[c][1]);
    const float w_rel = alpha * Gc + (1.0f - alpha) * s[c];
    const float wl = w_rel + lam[c] * rinv;
    const float clipped = clampf(wl, lb[c], ub[c]);
    const float beta = soft[c];
    const float s_new =
        is_inf(beta) ? clipped : (beta * clipped + rho * wl) * (1.0f / (beta + rho));
    const float lam_new = lam[c] + rho * (w_rel - s_new);
    acc.r_p = fmaxf(acc.r_p, fabsf(Gc - s_new));
    acc.g_max = fmaxf(acc.g_max, fabsf(Gc));
    acc.s_max = fmaxf(acc.s_max, fabsf(s_new));
    ds[c] = s_new - s[c];
    s[c] = s_new;
    lam[c] = lam_new;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    s_l[k * NC + c] = s[c];
    lam_l[k * NC + c] = lam[c];
  }
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
    if (j >= NA && !has_u) continue;
    const float a = S.col_coef[j][0] * pick(ds, S.col_row[j][0]) +
                    S.col_coef[j][1] * pick(ds, S.col_row[j][1]);
    const float l = S.col_coef[j][0] * pick(lam, S.col_row[j][0]) +
                    S.col_coef[j][1] * pick(lam, S.col_row[j][1]);
    acc.dual_ds = fmaxf(acc.dual_ds, fabsf(a));
    acc.dual_lam = fmaxf(acc.dual_lam, fabsf(l));
  }
}

// The stage pass of an ADMM iteration, stage k on thread k mod G (no
// stage depends on another): with `z`, the z-update of stage k from the
// rollout's x_k, u_k (z_update_stage) into this thread's maxima; then the
// next backward sweep's linear terms qt_k = q0_k - rho Dx'v - sigma x_k,
// rt_k = -rho Du'v - sigma u_k with v = s - lam / rho. A stage's
// device-memory operands are loaded together, the next stage's while this
// one is computed. Ends with a group barrier.
template <class M, int G, class O>
__device__ void stage_pass_g(const CoreParams<M>& P, const Sel<M>& S, const O& op,
                             const IterLanes& L, bool z, float rho, float rinv, const Grp<G>& gr,
                             Resid& acc) {
  constexpr int NX = M::NX, NA = M::NA, NZ = NA + NU;
  const int N = P.N;
  struct In {
    float s[NC], lam[NC], lb[NC], ub[NC], q0[NX];
  };
  auto load = [&](int k) {
    In o;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      o.s[c] = L.s[k * NC + c];
      o.lam[c] = L.lam[k * NC + c];
      o.lb[c] = L.lb[k * NC + c];
      o.ub[c] = L.ub[k * NC + c];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) o.q0[i] = L.q0[k * NX + i];
    return o;
  };
  In cur = load(min(gr.g, N));
  for (int k = gr.g; k <= N; k += G) {
    const In nxt = load(min(k + G, N));
    const bool has_u = k < N;
    float zz[NZ];
#pragma unroll
    for (int i = 0; i < NA; ++i) zz[i] = op[op.X + k * NA + i];
#pragma unroll
    for (int a = 0; a < NU; ++a) zz[NA + a] = has_u ? op[op.U + k * NU + a] : 0.0f;
    if (z)
      z_update_stage(S, P.soft, P.alpha, rho, rinv, zz, has_u, cur.lb, cur.ub, cur.s, cur.lam, L.s,
                     L.lam, k, acc);
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = cur.s[c] - cur.lam[c] * rinv;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      if (j >= NA && !has_u) continue;
      const float t = S.col_coef[j][0] * pick(v, S.col_row[j][0]) +
                      S.col_coef[j][1] * pick(v, S.col_row[j][1]);
      if (j < NA)
        op[op.qt + k * NA + j] = (j < NX ? cur.q0[j < NX ? j : 0] : 0.0f) - rho * t - P.sigma * zz[j];
      else
        op[op.rt + k * NU + j - NA] = -rho * t - P.sigma * zz[j];
    }
    cur = nxt;
  }
  gr.sync();
}

// One ADMM iteration (section 6): the affine backward
// sweep and the forward rollout split by rows, the vector broadcast by
// shuffle at every stage, then the stage pass. Each sweep loads the next
// stage's operands before its broadcast, so the shared-memory reads overlap
// the exchange. Returns this thread's part of the residual maxima
// (group_max gives the iteration's).
template <class M, int G, class O>
__device__ Resid admm_iteration_g(const CoreParams<M>& P, const Sel<M>& S, const O& op,
                                  const IterLanes& L, const float (&x0a)[M::NA], float rho,
                                  float rinv, const Grp<G>& gr) {
  constexpr int NX = M::NX, NA = M::NA, RA = (NA + G - 1) / G;
  const int N = P.N, g = gr.g;
  float mf[RA][NU], mfu[NU][NU];   // Mf' columns: own rows, and the u_prev block
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = min(g + G * j, NA - 1);
#pragma unroll
    for (int a = 0; a < NU; ++a) mf[j][a] = P.Mc[r][a] + P.DxDu[r][a] * rho;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) mfu[a][c] = P.Mc[NX + c][a] + P.DxDu[NX + c][a] * rho;

  // backward: stage k's Bd, Hiv, rt, and the own columns of Ad, Hux, qt
  struct Bk {
    float Bd[NX][NU], Hiv[NU][NU], rt[NU], adc[RA][NX], hux[RA][NU], qt[RA];
  };
  auto bload = [&](int k) {
    Bk o;
#pragma unroll
    for (int l = 0; l < NX; ++l)
#pragma unroll
      for (int a = 0; a < NU; ++a) o.Bd[l][a] = op[op.Bd + k * NX * NU + l * NU + a];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NU; ++c) o.Hiv[a][c] = op[op.Hiv + k * NU * NU + a * NU + c];
      o.rt[a] = op[op.rt + k * NU + a];
    }
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = g + G * j, rc = min(r, NX - 1);
#pragma unroll
      for (int l = 0; l < NX; ++l) o.adc[j][l] = op[op.Ad + k * NX * NX + l * NX + rc];
#pragma unroll
      for (int a = 0; a < NU; ++a)
        o.hux[j][a] = r < NX ? op[op.Hux + k * NU * NX + a * NX + rc] : mf[j][a];
      o.qt[j] = op[op.qt + k * NA + min(r, NA - 1)];
    }
    return o;
  };
  float vv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) vv[i] = op[op.qt + N * NA + i];
  Bk cb = bload(N - 1);
  for (int k = N - 1; k >= 0; --k) {
    float hu[NU], d[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = cb.Bd[0][a] * vv[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc += cb.Bd[l][a] * vv[l];
      hu[a] = cb.rt[a] + (acc + vv[NX + a]);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) d[a] = -(cb.Hiv[a][0] * hu[0] + cb.Hiv[a][1] * hu[1]);
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a) op[op.d + k * NU + a] = d[a];
    float vn[RA];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      float atv = cb.adc[j][0] * vv[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) atv += cb.adc[j][l] * vv[l];
      vn[j] = cb.qt[j] + (g + G * j < NX ? atv : 0.0f) + (cb.hux[j][0] * d[0] + cb.hux[j][1] * d[1]);
    }
    cb = bload(max(k - 1, 0));
    gather<G, NA>(gr, vn, vv);
  }
  gr.sync();   // d of every stage

  // forward: stage k's Hux (first NX columns), Hiv, d, and the own rows of Ad, Bd
  struct Fk {
    float hux[NU][NX], Hiv[NU][NU], d[NU], adr[RA][NX], bdr[RA][NU];
  };
  auto fload = [&](int k) {
    Fk o;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) o.hux[a][j] = op[op.Hux + k * NU * NX + a * NX + j];
#pragma unroll
      for (int c = 0; c < NU; ++c) o.Hiv[a][c] = op[op.Hiv + k * NU * NU + a * NU + c];
      o.d[a] = op[op.d + k * NU + a];
    }
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int rc = min(g + G * j, NX - 1);
#pragma unroll
      for (int l = 0; l < NX; ++l) o.adr[j][l] = op[op.Ad + k * NX * NX + rc * NX + l];
#pragma unroll
      for (int a = 0; a < NU; ++a) o.bdr[j][a] = op[op.Bd + k * NX * NU + rc * NU + a];
    }
    return o;
  };
  float x[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) x[i] = x0a[i];
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = g + G * j;
    if (r < NA) op[op.X + r] = pick(x0a, r);
  }
  Fk cf = fload(0);
  for (int k = 0; k < N; ++k) {
    float hx[NU], u[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float t = cf.hux[a][0] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) t += cf.hux[a][j] * x[j];
      hx[a] = t + (mfu[a][0] * x[NX] + mfu[a][1] * x[NX + 1]);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = -(cf.Hiv[a][0] * hx[0] + cf.Hiv[a][1] * hx[1]) + cf.d[a];
    float xn[RA];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = g + G * j;
      float t = cf.adr[j][0] * x[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) t += cf.adr[j][l] * x[l];
      t = t + (cf.bdr[j][0] * u[0] + cf.bdr[j][1] * u[1]);
      xn[j] = r < NX ? t : (r == NX ? u[0] : u[1]);
      if (r < NA) op[op.X + (k + 1) * NA + r] = xn[j];
    }
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a) op[op.U + k * NU + a] = u[a];
    cf = fload(min(k + 1, N - 1));
    gather<G, NA>(gr, xn, x);
  }
  gr.sync();   // the rollout

  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  stage_pass_g(P, S, op, L, true, rho, rinv, gr, acc);
  return acc;
}

// X, U at zero and the first sweep's linear terms.
template <class M, int G, class O>
__device__ __forceinline__ void admm_start_g(const CoreParams<M>& P, const Sel<M>& S,
                                             const O& op, const IterLanes& L, float rho,
                                             float rinv, const Grp<G>& gr) {
  constexpr int NA = M::NA;
  for (int k = gr.g; k <= P.N; k += G) {
#pragma unroll
    for (int i = 0; i < NA; ++i) op[op.X + k * NA + i] = 0.0f;
    if (k < P.N)
#pragma unroll
      for (int a = 0; a < NU; ++a) op[op.U + k * NU + a] = 0.0f;
  }
  gr.sync();
  Resid none{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  stage_pass_g(P, S, op, L, false, rho, rinv, gr, none);
}

// Sections 1-4, stage k on thread k mod G: the shifted schedule, curvature
// and bounds (the e_y row from the corridor where one is given), stage
// matrices, linear cost, warm start. The group barrier at the end publishes
// the workspace rows. With the cache (CACHE) the stage matrices wait for
// the group's decision (cache_stages_g); instead this thread's part of the
// drift of the new schedule from the cached one goes into `drift`: over its
// stages k < N-1 the largest |xk - Xs_in[k+1]|, |uk - Us_in[k+1]| and
// |kap - kap_in[k+1]|, each channel over its scale (s left out).
template <bool CACHE, class M, int G, class O>
__device__ void prepare_g(const CoreParams<M>& P, int b, const WsLayout<M>& W, const Lane& ws,
                          const O& op, const VehParams& pv, const float (&x)[M::NX],
                          const Lane& xref, const Grp<G>& gr, const CacheIO* cio,
                          float& drift) {
  constexpr int NX = M::NX;
  const int N = P.N, S = P.B;
  const Lane Xp = lane_of(P.Xp, b, S), Up = lane_of(P.Up, b, S);
  const Lane sw = lane_of(P.sw, b, S), lamw = lane_of(P.lamw, b, S);
  const Lane s = lane_of(P.s_out, b, S), lam = lane_of(P.lam_out, b, S);
  const float length = P.taux[0], inv_ds = P.taux[1];
  const float lo[NC] = {P.vx_min, -P.ey_max, -P.delta_max, P.a_min, -P.ddelta_max, -P.da_max};
  const float hi[NC] = {P.vx_max, P.ey_max, P.delta_max, P.a_max, P.ddelta_max, P.da_max};
  for (int k = gr.g; k <= N; k += G) {
    // 1. shifted schedule: Xs = [x, Xp[2..N], Xp[N]], Us = [Up[1..N-1], Up[N-1]]
    float xk[NX], uk[NU];
    const int kx = min(k + 1, N), ku = min(k + 1, N - 1);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xk[i] = k == 0 ? x[i] : Xp[kx * NX + i];
      ws[W.Xs + k * NX + i] = xk[i];
    }
    if (k < N)
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        uk[i] = Up[ku * NU + i];
        ws[W.Us + k * NU + i] = uk[i];
      }
    // 2. curvature + bounds (friction-circle vx cap)
    const float kap = kap_at(P.kappa, P.n_cells, length, inv_ds, xk[M::S]);
    ws[W.kap + k] = kap;
    float cap = P.vx_max;
    if (P.kappa_speed_cap)
      cap = clampf(sqrtf(P.a_lat_frac * pv.mu * pv.g / fmaxf(fabsf(kap), 1e-6f)), P.vx_min,
                   P.vx_max);
    const int kk = min(k + 1, N);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float l = lo[c], u = (c == 0) ? cap : hi[c];
      // the obstacle corridor replaces the e_y box before the disables, so
      // that the warm-start clip below sees it (JAX _mpc_core's order)
      if (c == 1 && P.eyb != nullptr) {
        const Lane eyb = lane_of(P.eyb, b, S);
        l = eyb[k * 2];
        u = eyb[k * 2 + 1];
      }
      if ((k == 0 && c < 2) || (k == N && c >= 2)) {
        l = -INFINITY;
        u = INFINITY;
      }
      ws[W.lb + k * NC + c] = l;
      ws[W.ub + k * NC + c] = u;
      // 4. warm start: the previous split / dual shifted one stage
      s[k * NC + c] = clampf(sw[kk * NC + c], l, u);
      lam[k * NC + c] = lamw[kk * NC + c];
    }
    // 3. stage matrices and the linear cost (vx reference clamped to the cap)
    if constexpr (CACHE) {
      if (k < N - 1) {
        const Lane cx = lane_of(cio->Xs, b, S), cu = lane_of(cio->Us, b, S);
        const float u_scale[NU] = {0.3f, 2.0f};
#pragma unroll
        for (int i = 0; i < NX; ++i)
          if (i != M::S)
            drift = fmaxf(drift, __fdiv_rn(fabsf(__fsub_rn(xk[i], cx[(k + 1) * NX + i])),
                                           M::cache_scale(i)));
#pragma unroll
        for (int i = 0; i < NU; ++i)
          drift = fmaxf(drift, __fdiv_rn(fabsf(__fsub_rn(uk[i], cu[(k + 1) * NU + i])), u_scale[i]));
        drift = fmaxf(drift, __fdiv_rn(fabsf(__fsub_rn(kap, cio->kap[(size_t)(k + 1) * S + b])), 0.5f));
      }
    } else if (k < N) {
      build_stage<M>(op, k, xk, uk, kap, pv, P.tire, P.dt);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float xr = xref[k * NX + i];
      if (i == 0) xr = fminf(xr, k == 0 ? INFINITY : cap);   // ub of row 0
      ws[W.q0 + k * NX + i] = -(P.qw[i] * xr);
    }
  }
  gr.sync();
}

// Section 3 of a step with the discretization cache, stage k on thread
// k mod G (the stages prepare_g scheduled on it): on a rebuild every stage
// is built at the new schedule, which becomes its signature; otherwise
// stage k < N-1 takes the cached stage k + 1 with its signature and only
// stage N-1 is built. The stages go to the operand slots and to the new
// cache; the age to 0 on a rebuild, else one more. Ends with a group
// barrier.
template <class M, int G, class O>
__device__ void cache_stages_g(const CoreParams<M>& P, int b, const WsLayout<M>& W,
                               const Lane& ws, const O& op, const VehParams& pv,
                               const CacheIO& cio, bool rebuild, const Grp<G>& gr) {
  constexpr int NX = M::NX;
  const int N = P.N, S = P.B;
  const Lane A_in = lane_of(cio.A, b, S), B_in = lane_of(cio.B, b, S);
  const Lane Xs_in = lane_of(cio.Xs, b, S), Us_in = lane_of(cio.Us, b, S);
  const Lane A_out = lane_of(cio.A_out, b, S), B_out = lane_of(cio.B_out, b, S);
  const Lane Xs_out = lane_of(cio.Xs_out, b, S), Us_out = lane_of(cio.Us_out, b, S);
  const Lane kap_out = lane_of(cio.kap_out, b, S);
  for (int k = gr.g; k < N; k += G) {
    const int oA = op.Ad + k * NX * NX, oB = op.Bd + k * NX * NU;
    if (rebuild || k == N - 1) {
      float xk[NX], uk[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) xk[i] = ws[W.Xs + k * NX + i];
#pragma unroll
      for (int i = 0; i < NU; ++i) uk[i] = ws[W.Us + k * NU + i];
      const float kap = ws[W.kap + k];
      build_stage<M>(op, k, xk, uk, kap, pv, P.tire, P.dt);
#pragma unroll
      for (int i = 0; i < NX; ++i) Xs_out[k * NX + i] = xk[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) Us_out[k * NU + i] = uk[i];
      kap_out[k] = kap;
    } else {
#pragma unroll
      for (int i = 0; i < NX * NX; ++i) op[oA + i] = A_in[(k + 1) * NX * NX + i];
#pragma unroll
      for (int i = 0; i < NX * NU; ++i) op[oB + i] = B_in[(k + 1) * NX * NU + i];
#pragma unroll
      for (int i = 0; i < NX; ++i) Xs_out[k * NX + i] = Xs_in[(k + 1) * NX + i];
#pragma unroll
      for (int i = 0; i < NU; ++i) Us_out[k * NU + i] = Us_in[(k + 1) * NU + i];
      kap_out[k] = cio.kap[(size_t)(k + 1) * S + b];
    }
#pragma unroll
    for (int i = 0; i < NX * NX; ++i) A_out[k * NX * NX + i] = op[oA + i];
#pragma unroll
    for (int i = 0; i < NX * NU; ++i) B_out[k * NX * NU + i] = op[oB + i];
  }
  if (gr.g == 0) cio.age_out[b] = rebuild ? 0.0f : cio.age[b] + 1.0f;
  gr.sync();
}

// Sections 1-8 of the tracker core for lane b on its group: writes the
// new warm start, u0 and stats rows 0-4 and returns u0 on every thread of
// the group. It holds the 128-lane early-exit vote (vote_all), so every
// thread of the cluster calls it; groups past B (active false) vote "done"
// and touch no memory. With the discretization cache (the megastep only:
// `cio` its arrays, the tag std::true_type) section 3 takes one branch per
// 128-lane group:
// every stage rebuilt when the group's largest drift exceeds the tolerance
// or its largest age reaches cache_max_age (max_all over the cluster;
// groups past B add 0 to both), else the shift.
template <class M, int G, class O, bool CACHE = false>
__device__ void mpc_core_g(const CoreParams<M>& P, const Sel<M>& S, int b, bool active,
                           const float (&x0)[M::NX], const VehParams& pv, const Lane& xref,
                           const Lane& ws, const O& op, const Grp<G>& gr, float (&u0)[NU],
                           const CacheIO* cio = nullptr,
                           std::bool_constant<CACHE> = std::bool_constant<false>{}) {
  constexpr int NX = M::NX, NA = M::NA, RA = (NA + G - 1) / G;
  const int SB = P.B, N = P.N, g = gr.g;
  const WsLayout<M> W(N);
  const IterLanes L{sub(ws, W.q0), sub(ws, W.lb), sub(ws, W.ub),
                    lane_of(P.s_out, active ? b : 0, SB), lane_of(P.lam_out, active ? b : 0, SB)};
  float rho = 1.0f, rinv = 1.0f, da = -1.0f;
  float x0a[NA] = {};
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  float drift = 0.0f;
  if (active) {
    rho = P.rho[b];
    rinv = 1.0f / rho;
    prepare_g<CACHE>(P, b, W, ws, op, pv, x0, xref, gr, cio, drift);
  }
  if constexpr (CACHE) {
    const float d = max_all(drift);
    const float age = max_all(active ? cio->age[b] : 0.0f);
    const bool rebuild = d > cio->tol || age >= (float)cio->max_age;
    if (active) cache_stages_g(P, b, W, ws, op, pv, *cio, rebuild, gr);
  }
  if (active) {
    factor_g(P, op, rho, gr);
    const Lane up = lane_of(P.uprev, b, SB);
#pragma unroll
    for (int i = 0; i < NX; ++i) x0a[i] = x0[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) x0a[NX + i] = up[i];
    admm_start_g(P, S, op, L, rho, rinv, gr);
  }

  // 6. ADMM: chunks of `check` iterations, the termination test recorded
  // at each chunk boundary (done-at = first passing boundary).
  const int n_chunks = P.max_iter / P.check;
  const int rem = P.max_iter - n_chunks * P.check;
  auto chunk = [&](int c) {
    for (int i = 0; i < P.check; ++i) acc = admm_iteration_g(P, S, op, L, x0a, rho, rinv, gr);
    if (da < 0.0f && converged(group_max(gr, acc), rho, P.eps_abs, P.eps_rel))
      da = (float)((c + 1) * P.check);
  };
  if (P.early_exit) {
    bool all_done = false;
    for (int c = 0; c < n_chunks && !all_done; ++c) {
      if (active) chunk(c);
      all_done = vote_all(!active || da >= 0.0f);
    }
    if (rem && !all_done && active)
      for (int i = 0; i < rem; ++i) acc = admm_iteration_g(P, S, op, L, x0a, rho, rinv, gr);
  } else if (active) {
    for (int c = 0; c < n_chunks; ++c) chunk(c);
    for (int i = 0; i < rem; ++i) acc = admm_iteration_g(P, S, op, L, x0a, rho, rinv, gr);
  }
  if (!active) return;
  acc = group_max(gr, acc);

  // 7. residuals / convergence / rho adaptation of the last iteration
  const float r_prim = acc.r_p, r_dual = rho * acc.dual_ds;
  const float eps_prim = P.eps_abs + P.eps_rel * fmaxf(acc.g_max, acc.s_max);
  const float eps_dual = P.eps_abs + P.eps_rel * acc.dual_lam;
  const bool conv = r_prim <= eps_prim && r_dual <= eps_dual;
  const float ratio = sqrtf((r_prim / fmaxf(eps_prim, 1e-12f)) /
                            fmaxf(r_dual / fmaxf(eps_dual, 1e-12f), 1e-12f));
  const float rho_new = clampf(rho * ratio, RHO_MIN, RHO_MAX);
  const float rho_next = (ratio > RHO_TOL || ratio < 1.0f / RHO_TOL) ? rho_new : rho;

  // 8. accept the solution or take the limp-home controller
  const bool usable = conv || (r_prim < P.eps_fallback && r_dual < P.eps_fallback);
  if (usable) {
    u0[0] = op[op.U];
    u0[1] = op[op.U + 1];
  } else {
    const float kap_now = kap_at(P.kappa, P.n_cells, P.taux[0], P.taux[1], x0[M::S]);
    const float sgn = (float)((x0[0] > 0.0f) - (x0[0] < 0.0f));
    u0[0] = clampf(atanf(kap_now * (pv.lf + pv.lr)) - 0.5f * x0[M::EY] * sgn, -P.delta_max,
                   P.delta_max);
    u0[1] = x0[0] > 2.0f * P.vx_min ? -0.5f : 0.0f;
  }
  if (g == 0) {
    const Lane st = lane_of(P.stats, b, SB), u0_out = lane_of(P.u0_out, b, SB);
    st[0] = r_prim;
    st[1] = r_dual;
    st[2] = conv ? 1.0f : 0.0f;
    st[3] = rho_next;
    st[4] = da > 0.0f ? da : (float)P.max_iter;
    u0_out[0] = u0[0];
    u0_out[1] = u0[1];
  }
  const Lane Xp_out = lane_of(P.Xp_out, b, SB), Up_out = lane_of(P.Up_out, b, SB);
  for (int k = g; k <= N; k += G) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      Xp_out[k * NX + i] = usable ? op[op.X + k * NA + i] : ws[W.Xs + k * NX + i];
    if (k < N)
#pragma unroll
      for (int i = 0; i < NU; ++i)
        Up_out[k * NU + i] = usable ? op[op.U + k * NU + i] : ws[W.Us + k * NU + i];
  }
}

}  // namespace arl

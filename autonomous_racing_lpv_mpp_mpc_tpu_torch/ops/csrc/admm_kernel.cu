// Solver-only kernel: per QP one backward Riccati factorization, then
// max_iter ADMM iterations, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/admm_kernel.py::_admm_kernel (Pallas,
// launched by pallas_admm_solve). Plain PyTorch version:
// ops/admm_kernel.py::admm_solve_plain. rho is adapted once, outside. One
// instantiation per state width: na = 8 (the dynamic tracker QP) and
// na = 6 (the kinematic one); nu = 2 and nc = 6 are fixed, as the JAX
// kernel's closed-form 2x2 inverse fixes nu.
//
// Design. A group of G threads of arl_sync.cuh owns one QP (lane), on the
// QP's own dense stage matrices A (na x na), B (na x 2), c, Qf, Rf, Mf:
// - the operands that every iteration re-reads (A, B, c, q, r, the gains
//   Hux, Hiv, Vc, the sweep's d, the linear terms qt, rt and the iterate X,
//   U: AdmmLayout) are copied once per launch into the block's shared memory,
//   one slice per QP, or, where N makes a block's slices too large, into the
//   device-memory workspace (ops/admm_kernel.py::admm_launch_shape chooses
//   the layout and the QPs per block from N and na);
// - the factor splits by rows (thread g owns rows g, g + G, ... of V), with
//   Hux = Mf' + (V B)'A by V's symmetry, and stores Hux, Hiv and V c; the
//   forward rollout forms u = -Hiv (Hux x) + d as the group core does;
// - the affine backward sweep and the forward rollout split by rows, the
//   vector broadcast by shuffle at every stage, each stage's operands loaded
//   while the previous one is computed;
// - the z-update and the next sweep's linear terms run in a stage-parallel
//   pass, stage k on thread k mod G, the selector rows [Dx Du] applied as
//   gathers (group_core.cuh::Sel, built per block from the QP's rows);
// - the residual maxima are group reductions; done-at is tested after every
//   iteration but the last, as the TPU kernel does.
// There is no early exit, so no vote and no cluster: QPs past B return at
// once. Selector rows with more than two nonzeros in a row or column are not
// taken: the kernel then writes NaN to the lane's outputs.
//
// What bounds it on the H100: its bytes (18.8 KB of inputs and outputs per
// QP at na = 8, N = 20), which the design reads once; what stands between it
// and that bound is the latency of each stage's short chain, as in the
// group core, and the shared memory a QP needs (11.9 KB at na = 8, N = 20),
// which allows 16 QPs per SM.
#include "group_core.cuh"

namespace arl {

// The QP's augmented state width, as model traits for Sel.
template <int NA_>
struct QpDims {
  static constexpr int NA = NA_;
};

// One QP's slice of the iteration operands (floats): A (N, na, na), B
// (N, na, NU), c (N, na), q (N+1, na), r (N, NU) copied from the inputs; the
// gains Hux (N, NU, na), Hiv (N, NU, NU), Vc (N, na); the sweep's affine
// term d (N, NU) and linear terms qt (N+1, na), rt (N, NU); the iterate X
// (N+1, na), U (N, NU). ops/admm_kernel.py::admm_ops_floats mirrors the
// total.
template <int NA>
struct AdmmLayout {
  int A, Bm, c, q, r, Hux, Hiv, Vc, d, qt, rt, X, U, total;
  __host__ __device__ explicit AdmmLayout(int N) {
    int o = 0;
    A = o;   o += N * NA * NA;
    Bm = o;  o += N * NA * NU;
    c = o;   o += N * NA;
    q = o;   o += (N + 1) * NA;
    r = o;   o += N * NU;
    Hux = o; o += N * NU * NA;
    Hiv = o; o += N * NU * NU;
    Vc = o;  o += N * NA;
    d = o;   o += N * NU;
    qt = o;  o += (N + 1) * NA;
    rt = o;  o += N * NU;
    X = o;   o += (N + 1) * NA;
    U = o;   o += N * NU;
    total = o;
  }
};

// A QP's operand slice: in shared memory (SM, stride 1) or in the
// device-memory workspace (stride B).
template <bool SM>
struct Slice {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const {
    if constexpr (SM) return p[i];
    else return p[(size_t)i * stride];
  }
};

struct AdmmParams {
  // inputs, batch-last: A (N, na, na), Bm (N, na, NU), c (N, na), Qf (N+1,
  // na, na), q (N+1, na), Rf (N, NU, NU), r (N, NU), Mf (N, na, NU),
  // lb/ub/s0/lam0 (N+1, NC), x0 (na), rho (1); shared rows Dx (NC, na),
  // Du (NC, NU), soft (NC)
  const float *A, *Bm, *c, *Qf, *q, *Rf, *r, *Mf, *lb, *ub, *x0, *s0, *lam0, *rho, *Dx, *Du, *soft;
  // outputs, batch-last: X (N+1, na), U (N, NU), s, lam (N+1, NC), stats (8)
  float *X, *U, *s, *lam, *stats, *ws;
  int B, N, max_iter, ws_rows, lanes, ops_smem, smem;
  float sigma, alpha, eps_abs, eps_rel;
};

constexpr int ADMM_PTRS = 23;
constexpr int ADMM_INTS = 8;
constexpr int ADMM_FLOATS = 4;

// The iteration's scalars and per-lane device-memory arrays.
struct AdmmLane {
  Lane s, lam, lb, ub;
  float rho, rinv, sigma, alpha;
};

// Backward Riccati factorization of the folded cost on the QP's dense
// stages, split by rows: writes Hux, Hiv and Vc = V c of every stage.
// Thread g owns rows r = g + G j of V; since V is symmetric, B'V = (VB)' and
// B'V A = (VB)'A, so Huu and Hux come from the broadcast VB; A'V A takes
// the broadcast V A.
template <int NA, int G, class O>
__device__ void factor_dense_g(const Lane& Qf, const Lane& Rf, const Lane& Mf, const O& op,
                               const AdmmLayout<NA>& L, int N, const Grp<G>& gr) {
  constexpr int RA = (NA + G - 1) / G;
  const int g = gr.g;
  float V[RA][NA];
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = min(g + G * j, NA - 1);
#pragma unroll
    for (int c = 0; c < NA; ++c) V[j][c] = Qf[N * NA * NA + r * NA + c];
  }
  for (int k = N - 1; k >= 0; --k) {
    const int oA = L.A + k * NA * NA;
    float Bk[NA][NU], ck[NA];
#pragma unroll
    for (int l = 0; l < NA; ++l) {
#pragma unroll
      for (int a = 0; a < NU; ++a) Bk[l][a] = op[L.Bm + k * NA * NU + l * NU + a];
      ck[l] = op[L.c + k * NA + l];
    }
    // VB = V B (own rows), then every row
    float VB[NA][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float own[RA], col[NA];
#pragma unroll
      for (int j = 0; j < RA; ++j) {
        float acc = V[j][0] * Bk[0][a];
#pragma unroll
        for (int l = 1; l < NA; ++l) acc += V[j][l] * Bk[l][a];
        own[j] = acc;
      }
      gather<G, NA>(gr, own, col);
#pragma unroll
      for (int i = 0; i < NA; ++i) VB[i][a] = col[i];
    }
    // Huu = Rf + B'V B and its inverse, on every thread
    float Huu[NU][NU], Hiv[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = Bk[0][a] * VB[0][c];
#pragma unroll
        for (int l = 1; l < NA; ++l) acc += Bk[l][a] * VB[l][c];
        Huu[a][c] = Rf[k * NU * NU + a * NU + c] + acc;
      }
    inv2(Huu, Hiv);
    // own rows of V A and V c; own columns of Hux = Mf' + VB'A and K = -Hiv Hux
    float VAo[RA][NA], Huxo[RA][NU], Ko[RA][NU];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = g + G * j, rc = min(r, NA - 1);
      float vc = V[j][0] * ck[0];
#pragma unroll
      for (int l = 1; l < NA; ++l) vc += V[j][l] * ck[l];
#pragma unroll
      for (int m = 0; m < NA; ++m) {
        float acc = V[j][0] * op[oA + m];
#pragma unroll
        for (int l = 1; l < NA; ++l) acc += V[j][l] * op[oA + l * NA + m];
        VAo[j][m] = acc;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float acc = VB[0][a] * op[oA + rc];
#pragma unroll
        for (int l = 1; l < NA; ++l) acc += VB[l][a] * op[oA + l * NA + rc];
        Huxo[j][a] = Mf[k * NA * NU + rc * NU + a] + acc;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) Ko[j][a] = -(Hiv[a][0] * Huxo[j][0] + Hiv[a][1] * Huxo[j][1]);
      if (r < NA) {
        op[L.Vc + k * NA + r] = vc;
#pragma unroll
        for (int a = 0; a < NU; ++a) op[L.Hux + k * NU * NA + a * NA + r] = Huxo[j][a];
      }
    }
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < NU; ++c) op[L.Hiv + k * NU * NU + a * NU + c] = Hiv[a][c];
    // every column of Hux and K, every row of V A
    float HuxA[NU][NA], KA[NU][NA], VA[NA][NA];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float oh[RA], ok[RA], ch[NA], ck2[NA];
#pragma unroll
      for (int j = 0; j < RA; ++j) oh[j] = Huxo[j][a], ok[j] = Ko[j][a];
      gather<G, NA>(gr, oh, ch);
      gather<G, NA>(gr, ok, ck2);
#pragma unroll
      for (int i = 0; i < NA; ++i) HuxA[a][i] = ch[i], KA[a][i] = ck2[i];
    }
#pragma unroll
    for (int l = 0; l < NA; ++l)
#pragma unroll
      for (int m = 0; m < NA; ++m) VA[l][m] = gr.bcast(VAo[l / G][m], l % G);
    // V <- sym(Qf + A'V A + Hux' K): row r from the row and the column of
    // the unsymmetrized update
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = min(g + G * j, NA - 1);
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        float ava = op[oA + r] * VA[0][c];
#pragma unroll
        for (int l = 1; l < NA; ++l) ava += op[oA + l * NA + r] * VA[l][c];
        const float vrow = Qf[k * NA * NA + r * NA + c] + ava +
                           (Huxo[j][0] * KA[0][c] + Huxo[j][1] * KA[1][c]);
        const float vcol = Qf[k * NA * NA + c * NA + r] + ava +
                           (HuxA[0][c] * Ko[j][0] + HuxA[1][c] * Ko[j][1]);
        V[j][c] = 0.5f * (vrow + vcol);
      }
    }
  }
}

// The stage pass, stage k on thread k mod G: with `z`, the z-update of
// stage k from the rollout's x_k, u_k (group_core.cuh::z_update_stage) into
// this thread's maxima; then the next
// backward sweep's linear terms qt_k = q_k - rho Dx'v - sigma x_k, rt_k =
// r_k - rho Du'v - sigma u_k with v = s - lam / rho. Ends with a group
// barrier.
template <int NA, int G, class O>
__device__ void stage_pass_dense_g(const Sel<QpDims<NA>>& S, const float (&soft)[NC], const O& op,
                                   const AdmmLayout<NA>& L, const AdmmLane& Ln, int N, bool z,
                                   const Grp<G>& gr, Resid& acc) {
  constexpr int NZ = NA + NU;
  const float rho = Ln.rho, rinv = Ln.rinv;
  struct In {
    float s[NC], lam[NC], lb[NC], ub[NC];
  };
  auto load = [&](int k) {
    In o;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      o.s[c] = Ln.s[k * NC + c];
      o.lam[c] = Ln.lam[k * NC + c];
      o.lb[c] = Ln.lb[k * NC + c];
      o.ub[c] = Ln.ub[k * NC + c];
    }
    return o;
  };
  In cur = load(min(gr.g, N));
  for (int k = gr.g; k <= N; k += G) {
    const In nxt = load(min(k + G, N));
    const bool has_u = k < N;
    float zz[NZ];
#pragma unroll
    for (int i = 0; i < NA; ++i) zz[i] = op[L.X + k * NA + i];
#pragma unroll
    for (int a = 0; a < NU; ++a) zz[NA + a] = has_u ? op[L.U + k * NU + a] : 0.0f;
    if (z)
      z_update_stage(S, soft, Ln.alpha, rho, rinv, zz, has_u, cur.lb, cur.ub, cur.s, cur.lam, Ln.s,
                     Ln.lam, k, acc);
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = cur.s[c] - cur.lam[c] * rinv;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      if (j >= NA && !has_u) continue;
      const float t = S.col_coef[j][0] * pick(v, S.col_row[j][0]) +
                      S.col_coef[j][1] * pick(v, S.col_row[j][1]);
      if (j < NA)
        op[L.qt + k * NA + j] = op[L.q + k * NA + j] - rho * t - Ln.sigma * zz[j];
      else
        op[L.rt + k * NU + j - NA] = op[L.r + k * NU + j - NA] - rho * t - Ln.sigma * zz[j];
    }
    cur = nxt;
  }
  gr.sync();
}

// One ADMM iteration: the affine backward sweep and the forward rollout
// split by rows, the vector broadcast by shuffle at every stage, then the
// stage pass. Returns this thread's part of the residual maxima.
template <int NA, int G, class O>
__device__ Resid admm_iteration_dense_g(const Sel<QpDims<NA>>& S, const float (&soft)[NC],
                                        const O& op,
                                        const AdmmLayout<NA>& L, const AdmmLane& Ln,
                                        const float (&x0)[NA], int N, const Grp<G>& gr) {
  constexpr int RA = (NA + G - 1) / G;
  const int g = gr.g;

  // backward: stage k's B, Vc, Hiv, rt, and the own columns of A, Hux, qt
  struct Bk {
    float Bm[NA][NU], Vc[NA], Hiv[NU][NU], rt[NU], acol[RA][NA], hux[RA][NU], qt[RA];
  };
  auto bload = [&](int k) {
    Bk o;
#pragma unroll
    for (int l = 0; l < NA; ++l) {
#pragma unroll
      for (int a = 0; a < NU; ++a) o.Bm[l][a] = op[L.Bm + k * NA * NU + l * NU + a];
      o.Vc[l] = op[L.Vc + k * NA + l];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NU; ++c) o.Hiv[a][c] = op[L.Hiv + k * NU * NU + a * NU + c];
      o.rt[a] = op[L.rt + k * NU + a];
    }
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int rc = min(g + G * j, NA - 1);
#pragma unroll
      for (int l = 0; l < NA; ++l) o.acol[j][l] = op[L.A + k * NA * NA + l * NA + rc];
#pragma unroll
      for (int a = 0; a < NU; ++a) o.hux[j][a] = op[L.Hux + k * NU * NA + a * NA + rc];
      o.qt[j] = op[L.qt + k * NA + rc];
    }
    return o;
  };
  float vv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) vv[i] = op[L.qt + N * NA + i];
  Bk cb = bload(N - 1);
  for (int k = N - 1; k >= 0; --k) {
    float w[NA], hu[NU], d[NU];
#pragma unroll
    for (int l = 0; l < NA; ++l) w[l] = cb.Vc[l] + vv[l];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = cb.Bm[0][a] * w[0];
#pragma unroll
      for (int l = 1; l < NA; ++l) acc += cb.Bm[l][a] * w[l];
      hu[a] = cb.rt[a] + acc;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) d[a] = -(cb.Hiv[a][0] * hu[0] + cb.Hiv[a][1] * hu[1]);
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a) op[L.d + k * NU + a] = d[a];
    float vn[RA];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      float atw = cb.acol[j][0] * w[0];
#pragma unroll
      for (int l = 1; l < NA; ++l) atw += cb.acol[j][l] * w[l];
      vn[j] = cb.qt[j] + atw + (cb.hux[j][0] * d[0] + cb.hux[j][1] * d[1]);
    }
    cb = bload(max(k - 1, 0));
    gather<G, NA>(gr, vn, vv);
  }
  gr.sync();   // d of every stage

  // forward: stage k's Hux, Hiv, d, and the own rows of A, B, c
  struct Fk {
    float hux[NU][NA], Hiv[NU][NU], d[NU], arow[RA][NA], brow[RA][NU], c[RA];
  };
  auto fload = [&](int k) {
    Fk o;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NA; ++j) o.hux[a][j] = op[L.Hux + k * NU * NA + a * NA + j];
#pragma unroll
      for (int c = 0; c < NU; ++c) o.Hiv[a][c] = op[L.Hiv + k * NU * NU + a * NU + c];
      o.d[a] = op[L.d + k * NU + a];
    }
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int rc = min(g + G * j, NA - 1);
#pragma unroll
      for (int l = 0; l < NA; ++l) o.arow[j][l] = op[L.A + k * NA * NA + rc * NA + l];
#pragma unroll
      for (int a = 0; a < NU; ++a) o.brow[j][a] = op[L.Bm + k * NA * NU + rc * NU + a];
      o.c[j] = op[L.c + k * NA + rc];
    }
    return o;
  };
  float x[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) x[i] = x0[i];
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = g + G * j;
    if (r < NA) op[L.X + r] = pick(x0, r);
  }
  Fk cf = fload(0);
  for (int k = 0; k < N; ++k) {
    float hx[NU], u[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float t = cf.hux[a][0] * x[0];
#pragma unroll
      for (int j = 1; j < NA; ++j) t += cf.hux[a][j] * x[j];
      hx[a] = t;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = -(cf.Hiv[a][0] * hx[0] + cf.Hiv[a][1] * hx[1]) + cf.d[a];
    float xn[RA];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int r = g + G * j;
      float t = cf.arow[j][0] * x[0];
#pragma unroll
      for (int l = 1; l < NA; ++l) t += cf.arow[j][l] * x[l];
      xn[j] = t + (cf.brow[j][0] * u[0] + cf.brow[j][1] * u[1]) + cf.c[j];
      if (r < NA) op[L.X + (k + 1) * NA + r] = xn[j];
    }
    if (g == 0)
#pragma unroll
      for (int a = 0; a < NU; ++a) op[L.U + k * NU + a] = u[a];
    cf = fload(min(k + 1, N - 1));
    gather<G, NA>(gr, xn, x);
  }
  gr.sync();   // the rollout

  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  stage_pass_dense_g(S, soft, op, L, Ln, N, true, gr, acc);
  return acc;
}

template <int NA, bool SM>
__global__ void __launch_bounds__(GROUP_THREADS) admm_kernel(const __grid_constant__ AdmmParams P) {
  constexpr int G = LANE_THREADS;
  __shared__ Sel<QpDims<NA>> sel;
  __shared__ float soft[NC];
  __shared__ int sel_ok;
  if (threadIdx.x == 0) {
    sel_ok = sel_from<QpDims<NA>>(
        [&](int c, int j) { return j < NA ? __ldg(P.Dx + c * NA + j) : __ldg(P.Du + c * NU + j - NA); },
        sel);
    for (int c = 0; c < NC; ++c) soft[c] = __ldg(P.soft + c);
  }
  __syncthreads();
  const Grp<G> gr;
  const int g = gr.g, lane = threadIdx.x / G;
  const int b = blockIdx.x * P.lanes + lane;
  if (b >= P.B) return;   // no vote: a group past B leaves at once
  const int S = P.B, N = P.N;
  const AdmmLayout<NA> L(N);
  Slice<SM> op;
  if constexpr (SM) op = Slice<SM>{dyn_smem() + lane * L.total, 1};
  else op = Slice<SM>{P.ws + b, S};
  const Lane X = lane_of(P.X, b, S), U = lane_of(P.U, b, S), st = lane_of(P.stats, b, S);
  const AdmmLane Ln{lane_of(P.s, b, S), lane_of(P.lam, b, S), lane_of(P.lb, b, S),
                    lane_of(P.ub, b, S), P.rho[b], 1.0f / P.rho[b], P.sigma, P.alpha};
  if (!sel_ok) {
    for (int k = g; k <= N; k += G) {
#pragma unroll
      for (int i = 0; i < NA; ++i) X[k * NA + i] = NAN;
      if (k < N)
#pragma unroll
        for (int a = 0; a < NU; ++a) U[k * NU + a] = NAN;
#pragma unroll
      for (int c = 0; c < NC; ++c) Ln.s[k * NC + c] = NAN, Ln.lam[k * NC + c] = NAN;
    }
    if (g == 0)
      for (int i = 0; i < 8; ++i) st[i] = NAN;
    return;
  }

  // the inputs every iteration re-reads, into the QP's slice; the split and
  // the dual from the (clipped) warm start; X, U at zero
  {
    const Lane A = lane_of(P.A, b, S), Bm = lane_of(P.Bm, b, S), c = lane_of(P.c, b, S);
    const Lane q = lane_of(P.q, b, S), r = lane_of(P.r, b, S);
    const Lane s0 = lane_of(P.s0, b, S), lam0 = lane_of(P.lam0, b, S);
    for (int k = g; k <= N; k += G) {
      if (k < N) {
#pragma unroll
        for (int i = 0; i < NA * NA; ++i) op[L.A + k * NA * NA + i] = A[k * NA * NA + i];
#pragma unroll
        for (int i = 0; i < NA * NU; ++i) op[L.Bm + k * NA * NU + i] = Bm[k * NA * NU + i];
#pragma unroll
        for (int i = 0; i < NA; ++i) op[L.c + k * NA + i] = c[k * NA + i];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          op[L.r + k * NU + a] = r[k * NU + a];
          op[L.U + k * NU + a] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        op[L.q + k * NA + i] = q[k * NA + i];
        op[L.X + k * NA + i] = 0.0f;
      }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        Ln.s[k * NC + cc] = s0[k * NC + cc];
        Ln.lam[k * NC + cc] = lam0[k * NC + cc];
      }
    }
    gr.sync();
  }
  factor_dense_g(lane_of(P.Qf, b, S), lane_of(P.Rf, b, S), lane_of(P.Mf, b, S), op, L, N, gr);
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  stage_pass_dense_g(sel, soft, op, L, Ln, N, false, gr, acc);   // the first sweep's linear terms
  float x0[NA];
  const Lane xl = lane_of(P.x0, b, S);
#pragma unroll
  for (int i = 0; i < NA; ++i) x0[i] = xl[i];

  float da = -1.0f;
  for (int it = 0; it < P.max_iter; ++it) {
    acc = admm_iteration_dense_g(sel, soft, op, L, Ln, x0, N, gr);
    if (it < P.max_iter - 1 && da < 0.0f &&
        converged(group_max(gr, acc), Ln.rho, P.eps_abs, P.eps_rel))
      da = (float)(it + 1);
  }
  acc = group_max(gr, acc);

  for (int k = g; k <= N; k += G) {
#pragma unroll
    for (int i = 0; i < NA; ++i) X[k * NA + i] = op[L.X + k * NA + i];
    if (k < N)
#pragma unroll
      for (int a = 0; a < NU; ++a) U[k * NU + a] = op[L.U + k * NU + a];
  }
  if (g != 0) return;
  st[0] = acc.r_p;
  st[1] = Ln.rho * acc.dual_ds;
  st[2] = acc.g_max;
  st[3] = acc.s_max;
  st[4] = acc.dual_lam;
  st[5] = da > 0.0f ? da : (float)P.max_iter;
  st[6] = 0.0f;
  st[7] = 0.0f;
}

template <int NA>
int launch_admm(const AdmmParams& P, void* stream) {
  const AdmmLayout<NA> L(P.N);
  if (P.ws_rows != (P.ops_smem ? 0 : L.total)) return -2;
  if (P.smem != (P.ops_smem ? P.lanes * L.total * 4 : 0)) return -2;
  const int grid = (P.B + P.lanes - 1) / P.lanes, threads = P.lanes * LANE_THREADS;
  return P.ops_smem ? launch_grouped(admm_kernel<NA, true>, P, grid, threads, 1, P.smem, stream)
                    : launch_grouped(admm_kernel<NA, false>, P, grid, threads, 1, P.smem, stream);
}

}  // namespace arl

// C entry: device pointers, float and int parameters in the order of
// ops/admm_kernel.py::_admm_cuda (the ints: B, N, max_iter, workspace rows,
// QPs per block, operands in shared memory, its bytes per block, na).
// Returns -1 on an operand-count mismatch, -2 on a workspace- or
// shared-memory-size mismatch, -3 on a bad size or width, else the CUDA
// error of the launch.
extern "C" int arl_admm_solve(void** ptrs, int n_ptrs, const float* fv, int n_f, const int* iv,
                              int n_i, int device, void* stream) {
  using namespace arl;
  if (n_ptrs != ADMM_PTRS || n_f != ADMM_FLOATS || n_i != ADMM_INTS) return -1;
  AdmmParams P{};
  const float** in[] = {&P.A, &P.Bm, &P.c, &P.Qf, &P.q, &P.Rf, &P.r, &P.Mf, &P.lb, &P.ub,
                        &P.x0, &P.s0, &P.lam0, &P.rho, &P.Dx, &P.Du, &P.soft};
  float** out[] = {&P.X, &P.U, &P.s, &P.lam, &P.stats, &P.ws};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  int* ints[] = {&P.B, &P.N, &P.max_iter, &P.ws_rows, &P.lanes, &P.ops_smem, &P.smem};
  for (int i = 0; i < ADMM_INTS - 1; ++i) *ints[i] = iv[i];
  float* floats[] = {&P.sigma, &P.alpha, &P.eps_abs, &P.eps_rel};
  for (int i = 0; i < ADMM_FLOATS; ++i) *floats[i] = fv[i];
  if (P.B < 1 || P.N < 1 || P.max_iter < 1 || P.lanes < 1 || P.lanes > BLOCK_LANES) return -3;
  cudaSetDevice(device);
  switch (iv[ADMM_INTS - 1]) {
    case 8: return launch_admm<8>(P, stream);
    case 6: return launch_admm<6>(P, stream);
    default: return -3;
  }
}

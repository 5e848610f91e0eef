// Solver-only kernel: per QP one backward Riccati factorization, then
// max_iter ADMM iterations, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/admm_kernel.py::_admm_kernel (Pallas,
// launched by pallas_admm_solve). Plain PyTorch version:
// ops/admm_kernel.py::admm_solve_plain. rho is adapted once, outside.
//
// Design. One thread owns one QP (lane), 128 threads a block; every
// operand is batch-last, so each warp access is one coalesced line. The
// gains K, Huu^-1, Hux, V c and the sweep's d live in a per-lane workspace
// in device memory; the iteration streams the stage matrices A (8x8),
// B (8x2) and c from device memory (mostly L2) twice per iteration.
//
// What bounds it on the H100: the per-lane serial chain (N stages backward
// and forward per iteration, ~2,000 dependent FMAs at N=20) and the
// ~1.2 KB of stage data each lane re-reads per stage sweep. The done-at is
// tested after every iteration but the last, as the TPU kernel does.
#include "arl_common.cuh"

namespace arl {

struct AdmmParams {
  const float *A, *Bm, *c, *Qf, *q, *Rf, *r, *Mf, *lb, *ub, *x0, *s0, *lam0, *rho;
  float *X, *U, *s, *lam, *stats, *ws;
  int B, N, max_iter, ws_rows;
  float sigma, alpha, eps_abs, eps_rel;
  float Dx[NC][NA], Du[NC][NU], soft[NC];
};

constexpr int ADMM_PTRS = 20;
constexpr int ADMM_INTS = 4;
constexpr int ADMM_FLOATS = 4 + NC * NA + NC * NU + NC;
constexpr int ADMM_WS_PER_STAGE = NU * NA + NU * NU + NU * NA + NA + NU;

// Workspace offsets per stage group: K, Hiv, Hux, Vc, d.
struct AdmmWs {
  int K, Hiv, Hux, Vc, d;
  __host__ __device__ explicit AdmmWs(int N)
      : K(0), Hiv(N * NU * NA), Hux(N * (NU * NA + NU * NU)),
        Vc(N * (2 * NU * NA + NU * NU)), d(N * (2 * NU * NA + NU * NU + NA)) {}
};

__device__ __forceinline__ void admm_factor(const AdmmParams& P, int b, const AdmmWs& W,
                                            const Lane& ws) {
  const int N = P.N, S = P.B;
  const Lane A = lane_of(P.A, b, S), Bm = lane_of(P.Bm, b, S), c = lane_of(P.c, b, S);
  const Lane Qf = lane_of(P.Qf, b, S), Rf = lane_of(P.Rf, b, S), Mf = lane_of(P.Mf, b, S);
  float V[NA][NA];
  load(V, Qf, N * NA * NA);
  for (int k = N - 1; k >= 0; --k) {
    float Ak[NA][NA], Bk[NA][NU], ck[NA];
    load(Ak, A, k * NA * NA);
    load(Bk, Bm, k * NA * NU);
    loadv(ck, c, k * NA);
    float VB[NA][NU], VA[NA][NA], Huu[NU][NU], Hux[NU][NA], Hiv[NU][NU], K[NU][NA];
    mm(V, Bk, VB);
    mtm(Bk, VB, Huu);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int l = 0; l < NU; ++l) Huu[a][l] = Rf[k * NU * NU + a * NU + l] + Huu[a][l];
    mm(V, Ak, VA);
    mtm(Bk, VA, Hux);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int j = 0; j < NA; ++j) Hux[a][j] = Mf[k * NA * NU + j * NU + a] + Hux[a][j];
    inv2(Huu, Hiv);
    mm(Hiv, Hux, K);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int j = 0; j < NA; ++j) K[a][j] = -K[a][j];
    float Vc[NA];
    mv(V, ck, Vc);
    storev(Vc, ws, W.Vc + k * NA);
    store(K, ws, W.K + k * NU * NA);
    store(Hiv, ws, W.Hiv + k * NU * NU);
    store(Hux, ws, W.Hux + k * NU * NA);
    float AVA[NA][NA], HK[NA][NA];
    mtm(Ak, VA, AVA);
    mtm(Hux, K, HK);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j) V[i][j] = Qf[k * NA * NA + i * NA + j] + AVA[i][j] + HK[i][j];
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

// One iteration; X/U/s/lam are updated in place in the output arrays.
__device__ Resid admm_iter(const AdmmParams& P, int b, const AdmmWs& W, const Lane& ws,
                           float rho) {
  const int N = P.N, S = P.B;
  const Lane A = lane_of(P.A, b, S), Bm = lane_of(P.Bm, b, S), c = lane_of(P.c, b, S);
  const Lane q = lane_of(P.q, b, S), r = lane_of(P.r, b, S);
  const Lane X = lane_of(P.X, b, S), U = lane_of(P.U, b, S);
  const Lane s_l = lane_of(P.s, b, S), lam_l = lane_of(P.lam, b, S);
  const Lane lb = lane_of(P.lb, b, S), ub = lane_of(P.ub, b, S);
  const float sigma = P.sigma;

  // backward affine sweep
  float vv[NA];
  {
    float v[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) v[cc] = s_l[N * NC + cc] - lam_l[N * NC + cc] / rho;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float t = P.Dx[0][i] * v[0];
#pragma unroll
      for (int cc = 1; cc < NC; ++cc) t += P.Dx[cc][i] * v[cc];
      vv[i] = q[N * NA + i] - rho * t - sigma * X[N * NA + i];
    }
  }
  for (int k = N - 1; k >= 0; --k) {
    float v[NC], qk[NA], rk[NU], w[NA];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) v[cc] = s_l[k * NC + cc] - lam_l[k * NC + cc] / rho;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float t = P.Dx[0][i] * v[0];
#pragma unroll
      for (int cc = 1; cc < NC; ++cc) t += P.Dx[cc][i] * v[cc];
      qk[i] = q[k * NA + i] - rho * t - sigma * X[k * NA + i];
      w[i] = ws[W.Vc + k * NA + i] + vv[i];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float t = P.Du[0][a] * v[0];
#pragma unroll
      for (int cc = 1; cc < NC; ++cc) t += P.Du[cc][a] * v[cc];
      rk[a] = r[k * NU + a] - rho * t - sigma * U[k * NU + a];
    }
    float Bk[NA][NU], Hiv[NU][NU], Hux[NU][NA], Ak[NA][NA];
    load(Bk, Bm, k * NA * NU);
    load(Hiv, ws, W.Hiv + k * NU * NU);
    float btw[NU], hu[NU], d[NU];
    mtv(Bk, w, btw);
#pragma unroll
    for (int a = 0; a < NU; ++a) hu[a] = rk[a] + btw[a];
    mv(Hiv, hu, d);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d[a] = -d[a];
      ws[W.d + k * NU + a] = d[a];
    }
    load(Ak, A, k * NA * NA);
    load(Hux, ws, W.Hux + k * NU * NA);
    float atw[NA], htd[NA];
    mtv(Ak, w, atw);
    mtv(Hux, d, htd);
#pragma unroll
    for (int i = 0; i < NA; ++i) vv[i] = qk[i] + atw[i] + htd[i];
  }

  // forward rollout
  float x[NA];
  loadv(x, lane_of(P.x0, b, S), 0);
  storev(x, X, 0);
  for (int k = 0; k < N; ++k) {
    float K[NU][NA], u[NU], Ak[NA][NA], Bk[NA][NU], ax[NA], bu[NA];
    load(K, ws, W.K + k * NU * NA);
    mv(K, x, u);
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] += ws[W.d + k * NU + a];
    load(Ak, A, k * NA * NA);
    load(Bk, Bm, k * NA * NU);
    mv(Ak, x, ax);
    mv(Bk, u, bu);
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = ax[i] + bu[i] + c[k * NA + i];
    storev(u, U, k * NU);
    storev(x, X, (k + 1) * NA);
  }

  // z-update per stage, with the residual maxima
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k <= N; ++k) {
    float xk[NA], uk[NU] = {0.0f, 0.0f};
    loadv(xk, X, k * NA);
    if (k < N) loadv(uk, U, k * NU);
    float ds[NC], lamn[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      float gx = P.Dx[cc][0] * xk[0];
#pragma unroll
      for (int j = 1; j < NA; ++j) gx += P.Dx[cc][j] * xk[j];
      const float G = k < N ? gx + (P.Du[cc][0] * uk[0] + P.Du[cc][1] * uk[1]) : gx;
      const float s = s_l[k * NC + cc], lam = lam_l[k * NC + cc];
      const float w_rel = P.alpha * G + (1.0f - P.alpha) * s;
      const float wl = w_rel + lam / rho;
      const float clipped = clampf(wl, lb[k * NC + cc], ub[k * NC + cc]);
      float s_new = clipped;
      if (!is_inf(P.soft[cc])) s_new = (P.soft[cc] * clipped + rho * wl) / (P.soft[cc] + rho);
      const float lam_new = lam + rho * (w_rel - s_new);
      s_l[k * NC + cc] = s_new;
      lam_l[k * NC + cc] = lam_new;
      acc.r_p = fmaxf(acc.r_p, fabsf(G - s_new));
      acc.g_max = fmaxf(acc.g_max, fabsf(G));
      acc.s_max = fmaxf(acc.s_max, fabsf(s_new));
      ds[cc] = s_new - s;
      lamn[cc] = lam_new;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float a = P.Dx[0][i] * ds[0], l = P.Dx[0][i] * lamn[0];
#pragma unroll
      for (int cc = 1; cc < NC; ++cc) {
        a += P.Dx[cc][i] * ds[cc];
        l += P.Dx[cc][i] * lamn[cc];
      }
      acc.dual_ds = fmaxf(acc.dual_ds, fabsf(a));
      acc.dual_lam = fmaxf(acc.dual_lam, fabsf(l));
    }
    if (k < N) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float a = P.Du[0][i] * ds[0], l = P.Du[0][i] * lamn[0];
#pragma unroll
        for (int cc = 1; cc < NC; ++cc) {
          a += P.Du[cc][i] * ds[cc];
          l += P.Du[cc][i] * lamn[cc];
        }
        acc.dual_ds = fmaxf(acc.dual_ds, fabsf(a));
        acc.dual_lam = fmaxf(acc.dual_lam, fabsf(l));
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(BLOCK) admm_kernel(const __grid_constant__ AdmmParams P) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= P.B) return;
  const int N = P.N, S = P.B;
  const AdmmWs W(N);
  const Lane ws = lane_of(P.ws, b, S);
  const float rho = P.rho[b];
  admm_factor(P, b, W, ws);

  // primal iterates start at zero; the split starts at the (clipped) warm start
  const Lane X = lane_of(P.X, b, S), U = lane_of(P.U, b, S);
  const Lane s = lane_of(P.s, b, S), lam = lane_of(P.lam, b, S);
  const Lane s0 = lane_of(P.s0, b, S), lam0 = lane_of(P.lam0, b, S);
  for (int i = 0; i < (N + 1) * NA; ++i) X[i] = 0.0f;
  for (int i = 0; i < N * NU; ++i) U[i] = 0.0f;
  for (int i = 0; i < (N + 1) * NC; ++i) {
    s[i] = s0[i];
    lam[i] = lam0[i];
  }
  float da = -1.0f;
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < P.max_iter; ++it) {
    acc = admm_iter(P, b, W, ws, rho);
    if (it < P.max_iter - 1 && da < 0.0f && converged(acc, rho, P.eps_abs, P.eps_rel))
      da = (float)(it + 1);
  }
  const Lane st = lane_of(P.stats, b, S);
  st[0] = acc.r_p;
  st[1] = rho * acc.dual_ds;
  st[2] = acc.g_max;
  st[3] = acc.s_max;
  st[4] = acc.dual_lam;
  st[5] = da > 0.0f ? da : (float)P.max_iter;
  st[6] = 0.0f;
  st[7] = 0.0f;
}

}  // namespace arl

// C entry: device pointers, float and int parameters in the order of
// ops/admm_kernel.py::_admm_cuda. Returns -1 on an operand-count mismatch,
// -2 on a workspace-size mismatch, -3 on bad sizes, else cudaGetLastError().
extern "C" int arl_admm_solve(void** ptrs, int n_ptrs, const float* fv, int n_f, const int* iv,
                              int n_i, int device, void* stream) {
  using namespace arl;
  if (n_ptrs != ADMM_PTRS || n_f != ADMM_FLOATS || n_i != ADMM_INTS) return -1;
  AdmmParams P;
  const float** in[] = {&P.A, &P.Bm, &P.c, &P.Qf, &P.q, &P.Rf, &P.r, &P.Mf,
                        &P.lb, &P.ub, &P.x0, &P.s0, &P.lam0, &P.rho};
  float** out[] = {&P.X, &P.U, &P.s, &P.lam, &P.stats, &P.ws};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  P.B = iv[0];
  P.N = iv[1];
  P.max_iter = iv[2];
  P.ws_rows = iv[3];
  P.sigma = fv[0];
  P.alpha = fv[1];
  P.eps_abs = fv[2];
  P.eps_rel = fv[3];
  int f = 4;
  for (int i = 0; i < NC * NA; ++i) (&P.Dx[0][0])[i] = fv[f++];
  for (int i = 0; i < NC * NU; ++i) (&P.Du[0][0])[i] = fv[f++];
  for (int i = 0; i < NC; ++i) P.soft[i] = fv[f++];
  if (P.ws_rows != P.N * ADMM_WS_PER_STAGE) return -2;
  if (P.B < 1 || P.N < 1 || P.max_iter < 1) return -3;
  cudaSetDevice(device);
  const int grid = (P.B + BLOCK - 1) / BLOCK;
  admm_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

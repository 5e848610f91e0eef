// Fused assembly + solve of every lane in one launch, for NVIDIA Hopper
// (sm_90a): LPV stage build + Van Loan + augmentation + linear cost +
// rho-folded Riccati factor + ADMM with an exact per-iteration done-at.
//
// Replaces the JAX package's ops/fused_kernel.py::_fused_kernel, a Pallas
// TPU kernel launched by fused_mpc_solve. Plain PyTorch version:
// ops/fused_kernel.py::fused_solve_plain. Scheduling, bounds, the reference
// and the warm-start shift come from the host (loop/mpc.py::
// mpc_prepare_light); the kernel looks nothing up: kappa, x_ref (vx already
// clamped to the friction cap), lb/ub arrive per lane and stage.
//
// Design. One thread owns one lane; 128 threads form a block. Each thread
// builds its N stage matrices into its workspace (the tracker core's
// WsLayout: Ad, Bd, q0, lb, ub, the gains and the iterates; the schedule
// slots stay unused), factors once with mpc_core.cuh's factor, and iterates
// mpc_core.cuh's admm_iteration from s0 (clipped to [lb, ub]) and lam0 with
// X, U at zero. Unlike the core's loop, the OSQP termination test runs
// after EVERY iteration, so done-at is exact. With early exit the block
// votes (__syncthreads_and) at each boundary of a chunk of `check`
// iterations and leaves when every lane has a done-at; the remainder tail
// runs only if some lane has not. Lanes past B vote "done" and touch no
// memory (the Pallas kernel padded with copies of lane 0 instead). Stats
// rows 0-4 are the last executed iteration's residuals, row 5 the done-at
// (max_iter if never); rho is adapted on the host. Both models, one
// instantiation each (Dynamic, Kinematic), selected by the last int.
//
// What bounds it on the H100: the per-lane serial chain of small dense
// algebra: per iteration a backward sweep and a forward rollout of na x na
// mat-vecs over N stages and the z-update, all per lane over a workspace
// that lives in device memory (L2-resident at B=4096). Its own inputs and
// outputs are ~5 KB per lane; the operations, ~0.5 MFLOP per lane at N=20
// and 20 iterations, are the bound — and at B=4096 only 32 of 132 SMs hold
// a block, so the card runs far below its f32 rate.
#include "mpc_core.cuh"

namespace arl {

template <class M>
struct FusedParams {
  CoreParams<M> C;   // scalars, constants, rho in; s_out, lam_out, stats out
  // inputs, batch-last: xs (N, nx), us (N, NU), kap (N), xref (N+1, nx),
  // prm (10), lb/ub/s0/lam0 (N+1, NC), x0a (na)
  const float *xs, *us, *kap, *xref, *prm, *lb, *ub, *x0a, *s0, *lam0;
  float *X_out, *U_out, *ws;   // (N+1, na), (N, NU), (ws_rows) per lane
  int ws_rows;
};

constexpr int FUSED_PTRS = 17;
constexpr int FUSED_INTS = 8;

template <class M>
__global__ void __launch_bounds__(BLOCK) fused_kernel(const __grid_constant__ FusedParams<M> P) {
  constexpr int NX = M::NX, NA = M::NA;
  const CoreParams<M>& C = P.C;
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = b < C.B;
  const int S = C.B, N = C.N;
  const WsLayout<M> W(N);
  const Lane ws = lane_of(P.ws, active ? b : 0, S);
  const Lane s_l = lane_of(C.s_out, active ? b : 0, S);
  const Lane lam_l = lane_of(C.lam_out, active ? b : 0, S);
  float rho = 1.0f, rinv = 1.0f, da = -1.0f;
  float x0a[NA] = {};
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  if (active) {
    rho = C.rho[b];
    rinv = 1.0f / rho;
    const VehParams pv = load_params(P.prm, b, S);
    const Lane xs = lane_of(P.xs, b, S), us = lane_of(P.us, b, S), kap = lane_of(P.kap, b, S);
    // 1. stage matrices at the scheduled (x, u, kappa)
    for (int k = 0; k < N; ++k) {
      float xk[NX], uk[NU], Ac[NX][NX], Bc[NX][NU], Ad[NX][NX], Bd[NX][NU];
      loadv(xk, xs, k * NX);
      loadv(uk, us, k * NU);
      M::ab_cont(xk, uk, kap[k], pv, C.tire, Ac, Bc);
      vanloan(Ac, Bc, C.dt, Ad, Bd);
      store(Ad, ws, W.Ad + k * NX * NX);
      store(Bd, ws, W.Bd + k * NX * NU);
    }
    // linear cost from the reference as given, bounds, clipped warm start
    const Lane xref = lane_of(P.xref, b, S), lb = lane_of(P.lb, b, S), ub = lane_of(P.ub, b, S);
    const Lane s0 = lane_of(P.s0, b, S), lam0 = lane_of(P.lam0, b, S);
    for (int k = 0; k <= N; ++k) {
#pragma unroll
      for (int i = 0; i < NX; ++i) ws[W.q0 + k * NX + i] = -(C.qw[i] * xref[k * NX + i]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float l = lb[k * NC + c], u = ub[k * NC + c];
        ws[W.lb + k * NC + c] = l;
        ws[W.ub + k * NC + c] = u;
        s_l[k * NC + c] = clampf(s0[k * NC + c], l, u);
        lam_l[k * NC + c] = lam0[k * NC + c];
      }
    }
    // 2. rho-folded cost + Riccati factor
    factor(C, W, ws, rho);
    const Lane xa = lane_of(P.x0a, b, S);
    for (int i = 0; i < NA; ++i) x0a[i] = xa[i];
    for (int i = 0; i < (N + 1) * NA; ++i) ws[W.Xsol + i] = 0.0f;
    for (int i = 0; i < N * NU; ++i) ws[W.Usol + i] = 0.0f;
  }

  // 3. ADMM, the termination test after every iteration (exact done-at)
  const int n_chunks = C.max_iter / C.check;
  const int rem = C.max_iter - n_chunks * C.check;
  auto iterate = [&](int it1) {
    acc = admm_iteration(C, W, ws, s_l, lam_l, x0a, rho, rinv);
    if (da < 0.0f && converged(acc, rho, C.eps_abs, C.eps_rel)) da = (float)it1;
  };
  if (C.early_exit) {
    bool all_done = false;
    for (int c = 0; c < n_chunks && !all_done; ++c) {
      if (active)
        for (int i = 0; i < C.check; ++i) iterate(c * C.check + i + 1);
      all_done = __syncthreads_and(!active || da >= 0.0f);
    }
    if (rem && !all_done && active)
      for (int i = 0; i < rem; ++i) iterate(n_chunks * C.check + i + 1);
  } else if (active) {
    for (int it = 0; it < C.max_iter; ++it) iterate(it + 1);
  }
  if (!active) return;

  // 4. residual rows of the last executed iteration, the solution
  const Lane st = lane_of(C.stats, b, S);
  st[0] = acc.r_p;
  st[1] = rho * acc.dual_ds;
  st[2] = acc.g_max;
  st[3] = acc.s_max;
  st[4] = acc.dual_lam;
  st[5] = da > 0.0f ? da : (float)C.max_iter;
  st[6] = 0.0f;
  st[7] = 0.0f;
  const Lane X_out = lane_of(P.X_out, b, S), U_out = lane_of(P.U_out, b, S);
  for (int i = 0; i < (N + 1) * NA; ++i) X_out[i] = ws[W.Xsol + i];
  for (int i = 0; i < N * NU; ++i) U_out[i] = ws[W.Usol + i];
}

template <class M>
int launch_fused(void** ptrs, const float* fv, int n_f, const int* iv, int device, void* stream) {
  if (n_f != core_floats<M>()) return -1;
  FusedParams<M> P{};
  CoreParams<M>& C = P.C;
  const float** in[] = {&P.xs, &P.us, &P.kap, &P.xref, &P.prm, &P.lb, &P.ub, &P.x0a, &P.s0,
                        &P.lam0, &C.rho};
  float** out[] = {&P.X_out, &P.U_out, &C.s_out, &C.lam_out, &C.stats, &P.ws};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  int* ints[] = {&C.B, &C.N, &C.max_iter, &C.check, &C.early_exit, &C.tire, &P.ws_rows};
  for (int i = 0; i < FUSED_INTS - 1; ++i) *ints[i] = iv[i];
  read_core_floats(C, fv);
  if (P.ws_rows != WsLayout<M>(C.N).total) return -2;
  if (C.B < 1 || C.N < 1 || C.check < 1 || C.max_iter < 1) return -3;
  cudaSetDevice(device);
  const int grid = (C.B + BLOCK - 1) / BLOCK;
  fused_kernel<M><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace arl

// C entry: device pointers, float and int parameters in the order of
// ops/fused_kernel.py::_fused_cuda; the last int selects the model (0
// dynamic, 1 kinematic). Returns -1 on an operand-count mismatch, -2 on a
// workspace-size mismatch, -3 on a bad size or model, else
// cudaGetLastError().
extern "C" int arl_fused_solve(void** ptrs, int n_ptrs, const float* fv, int n_f, const int* iv,
                               int n_i, int device, void* stream) {
  using namespace arl;
  if (n_ptrs != FUSED_PTRS || n_i != FUSED_INTS) return -1;
  switch (iv[FUSED_INTS - 1]) {
    case 0: return launch_fused<Dynamic>(ptrs, fv, n_f, iv, device, stream);
    case 1: return launch_fused<Kinematic>(ptrs, fv, n_f, iv, device, stream);
    default: return -3;
  }
}

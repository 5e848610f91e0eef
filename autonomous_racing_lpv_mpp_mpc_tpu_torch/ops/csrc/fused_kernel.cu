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
// Design. A group of G threads owns one lane (group_core.cuh): thread g
// builds the stages k = g mod G into the lane's shared-memory slice of
// ADMM operands, writes their linear cost and clipped warm start, then the
// group factors once (factor_g) and iterates admm_iteration_g from s0 and
// lam0 with X, U at zero. The OSQP
// termination test runs after EVERY iteration on the group's max-reduced
// residuals, so done-at is exact. With early exit the 128 consecutive lanes
// of 8 blocks vote (vote_group: across a thread block cluster, or through
// device memory in a co-resident launch, arl_sync.cuh launch_group, whose
// instantiation takes the device's vote slots as a second argument) at each
// boundary of a chunk of
// `check` iterations and leave when every lane has a done-at; the remainder
// tail runs only if some lane has not. Groups past B vote "done" and touch
// no memory (the Pallas kernel padded with copies of lane 0 instead). Stats
// rows 0-4 are the last executed iteration's residuals, row 5 the done-at
// (max_iter if never); rho is adapted on the host. With a section-counter
// pointer (tracing on) the traced instantiation runs (TRACE, its own
// translation unit, fused_traced_kernel.cu): each lane's thread 0 adds its
// cycles per section and its counts into the counters (group_core.cuh,
// Sec); the untraced one reads no clock. Both models (Dynamic,
// Kinematic), each with its operands in shared or in device memory, as the
// wrapper chooses from N (ops/fused_kernel.py::launch_shape); the launch
// shape is arl_sync.cuh's (G = 8, 16 lanes per block, 8 blocks a group).
//
// What bounds it on the H100: the operations, ~0.2 MFLOP per lane at N=20
// and 20 iterations (its ~5 KB of inputs and outputs per lane take far
// less). What stands between it and that bound is latency: each ADMM stage
// is a short dependent chain (mat-vec, shuffle broadcast, next stage), so
// the design shortens the chain by G, keeps the operands that every
// iteration re-reads at shared-memory latency, and spreads B=4096 over 256
// blocks of 16 lanes, 8 blocks a group. At N=20 (dynamic) a block's 95,744
// B of shared memory leaves room for two blocks per SM: 264 on the card,
// which holds 30 clusters of 8 at once (a cluster's blocks share a GPC).
// The rule (launch_group): a launch with early exit that holds more groups
// than that and fits the card's block places whole (B=4,096: 32 groups in
// 256 places) runs co-resident, in one wave; any other runs as clusters, in
// ceil(groups / clusters) waves.
#include "group_core.cuh"

namespace arl {

template <class M>
struct FusedParams {
  CoreParams<M> C;   // scalars, constants, rho in; s_out, lam_out, stats out
  Sel<M> S;
  // inputs, batch-last: xs (N, nx), us (N, NU), kap (N), xref (N+1, nx),
  // prm (10), lb/ub/s0/lam0 (N+1, NC), x0a (na)
  const float *xs, *us, *kap, *xref, *prm, *lb, *ub, *x0a, *s0, *lam0;
  float *X_out, *U_out, *ws;   // (N+1, na), (N, NU), (ws_rows) per lane
  int ws_rows;
  // (N_SEC,) section counters (group_core.cuh, Sec), or null: tracing off.
  // Last, so that every other member keeps its place in the untraced kernel
  unsigned long long* sec;
};

constexpr int FUSED_PTRS = 18;
constexpr int FUSED_INTS = 10;

// At most 168 registers, so that three blocks of 128 threads fit on an SM
// where the shared memory allows it (the kinematic model at N=10).
// `vote`: empty (clustered), or the device's vote slots (co-resident;
// arl_sync.cuh, launch_group).
template <class M, bool SM, bool TRACE, class... Vote>
__global__ void __launch_bounds__(GROUP_THREADS, 3) fused_kernel(const __grid_constant__ FusedParams<M> P,
                                                                 Vote... vote) {
  constexpr int NX = M::NX, NA = M::NA, G = LANE_THREADS;
  const CoreParams<M>& C = P.C;
  const Grp<G> gr;
  const int g = gr.g, lane = threadIdx.x / G;
  const int b = blockIdx.x * BLOCK_LANES + lane;
  const bool active = b < C.B;
  const int S = C.B, N = C.N, bb = active ? b : 0;
  const WsLayout<M> W(N);
  const Lane ws = lane_of(P.ws, bb, S);
  const Ops<SM> op = ops_of<M, SM>(N, lane, P.ws, bb, S);
  const IterLanes L{sub(ws, W.q0), lane_of(P.lb, bb, S), lane_of(P.ub, bb, S),
                    lane_of(C.s_out, bb, S), lane_of(C.lam_out, bb, S)};
  float rho = 1.0f, rinv = 1.0f, da = -1.0f;
  float x0a[NA] = {};
  Resid acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  sec_begin<TRACE>();

  if (active) {
    sec_open<TRACE>(g, SEC_PREPARE);
    rho = C.rho[b];
    rinv = 1.0f / rho;
    const VehParams pv = load_params(P.prm, b, S);
    const Lane xs = lane_of(P.xs, b, S), us = lane_of(P.us, b, S), kap = lane_of(P.kap, b, S);
    const Lane xref = lane_of(P.xref, b, S), s0 = lane_of(P.s0, b, S), lam0 = lane_of(P.lam0, b, S);
    for (int k = g; k <= N; k += G) {
      // 1. stage matrices at the scheduled (x, u, kappa)
      if (k < N) {
        float xk[NX], uk[NU];
        loadv(xk, xs, k * NX);
        loadv(uk, us, k * NU);
        build_stage<M>(op, k, xk, uk, kap[k], pv, C.tire, C.dt);
      }
      // linear cost from the reference as given, clipped warm start
#pragma unroll
      for (int i = 0; i < NX; ++i) L.q0[k * NX + i] = -(C.qw[i] * xref[k * NX + i]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        L.s[k * NC + c] = clampf(s0[k * NC + c], L.lb[k * NC + c], L.ub[k * NC + c]);
        L.lam[k * NC + c] = lam0[k * NC + c];
      }
    }
    gr.sync();
    sec_switch<TRACE>(g, SEC_PREPARE, SEC_FACTOR);
    // 2. rho-folded cost + Riccati factor; X, U at zero
    factor_g(C, op, rho, gr);
    admm_start_g(C, P.S, op, L, rho, rinv, gr);
    const Lane xa = lane_of(P.x0a, b, S);
#pragma unroll
    for (int i = 0; i < NA; ++i) x0a[i] = xa[i];
    sec_switch<TRACE>(g, SEC_FACTOR, SEC_SWEEP);
  }

  // 3. ADMM, the termination test after every iteration (exact done-at)
  const int n_chunks = C.max_iter / C.check;
  const int rem = C.max_iter - n_chunks * C.check;
  auto iterate = [&](int it1) {
    if constexpr (TRACE) {   // the test in the vote section; the untraced branch compiles to
                             // the same instructions as a kernel without counters
      const Resid mine = admm_iteration_g<M, G, Ops<SM>, true>(C, P.S, op, L, x0a, rho, rinv, gr);
      sec_open<true>(g, SEC_VOTE);
      acc = group_max(gr, mine);
      if (da < 0.0f && converged(acc, rho, C.eps_abs, C.eps_rel)) da = (float)it1;
      sec_close<true>(g, SEC_VOTE);
    } else {
      acc = group_max(gr, admm_iteration_g(C, P.S, op, L, x0a, rho, rinv, gr));
      if (da < 0.0f && converged(acc, rho, C.eps_abs, C.eps_rel)) da = (float)it1;
    }
  };
  if (C.early_exit) {
    bool all_done = false;
    for (int c = 0; c < n_chunks && !all_done; ++c) {
      if (active) {
        for (int i = 0; i < C.check; ++i) iterate(c * C.check + i + 1);
        sec_count<TRACE>(g, SEC_LANE_ITERS, C.check);
        sec_open<TRACE>(g, SEC_VOTE);
      }
      all_done = vote_group(!active || da >= 0.0f, vote...);
      if (active) sec_close<TRACE>(g, SEC_VOTE);
    }
    if (rem && !all_done && active) {
      for (int i = 0; i < rem; ++i) iterate(n_chunks * C.check + i + 1);
      sec_count<TRACE>(g, SEC_LANE_ITERS, rem);
    }
  } else if (active) {
    for (int it = 0; it < C.max_iter; ++it) iterate(it + 1);
    sec_count<TRACE>(g, SEC_LANE_ITERS, C.max_iter);
  }
  if (!active) return sec_end<TRACE>(P.sec, g);
  sec_switch<TRACE>(g, SEC_SWEEP, SEC_FINISH);
  sec_unnest<TRACE>(g);

  // 4. the solution, the residual rows of the last executed iteration
  const Lane X_out = lane_of(P.X_out, b, S), U_out = lane_of(P.U_out, b, S);
  for (int k = g; k <= N; k += G) {
#pragma unroll
    for (int i = 0; i < NA; ++i) X_out[k * NA + i] = op[op.X + k * NA + i];
    if (k < N)
#pragma unroll
      for (int i = 0; i < NU; ++i) U_out[k * NU + i] = op[op.U + k * NU + i];
  }
  if (g != 0) return;
  const Lane st = lane_of(C.stats, b, S);
  st[0] = acc.r_p;
  st[1] = rho * acc.dual_ds;
  st[2] = acc.g_max;
  st[3] = acc.s_max;
  st[4] = acc.dual_lam;
  st[5] = da > 0.0f ? da : (float)C.max_iter;
  st[6] = 0.0f;
  st[7] = 0.0f;
  sec_close<TRACE>(0, SEC_FINISH);
  sec_count<TRACE>(0, SEC_LANE_STEPS, 1u);
  sec_count<TRACE>(0, SEC_LANE_DONEAT, (unsigned)(da > 0.0f ? da : (float)C.max_iter));
  sec_end<TRACE>(P.sec, 0);
}

// The traced instantiations are compiled in a translation unit of their own
// (fused_traced_kernel.cu, which includes this file with
// ARL_FUSED_TRACED_TU defined), so that their nvcc runs beside this one's.
template <class M, bool SM>
int launch_fused_traced(const FusedParams<M>& P, int grid, int smem, void* stream);

#ifdef ARL_FUSED_TRACED_TU
template <class M, bool SM>
int launch_fused_traced(const FusedParams<M>& P, int grid, int smem, void* stream) {
  return launch_group(fused_kernel<M, SM, true>, fused_kernel<M, SM, true, VoteSlot*>, P, grid,
                      smem, stream, "fused_kernel", P.C.early_exit != 0);
}

template int launch_fused_traced<Dynamic, true>(const FusedParams<Dynamic>&, int, int, void*);
template int launch_fused_traced<Dynamic, false>(const FusedParams<Dynamic>&, int, int, void*);
template int launch_fused_traced<Kinematic, true>(const FusedParams<Kinematic>&, int, int, void*);
template int launch_fused_traced<Kinematic, false>(const FusedParams<Kinematic>&, int, int, void*);

}  // namespace arl
#else
template <class M, bool SM>
int launch_fused_as(const FusedParams<M>& P, int grid, int smem, void* stream) {
  return P.sec ? launch_fused_traced<M, SM>(P, grid, smem, stream)
               : launch_group(fused_kernel<M, SM, false>, fused_kernel<M, SM, false, VoteSlot*>, P,
                              grid, smem, stream, "fused_kernel", P.C.early_exit != 0);
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
  P.sec = static_cast<unsigned long long*>(ptrs[p++]);
  int ops_smem = 0, smem = 0;
  int* ints[] = {&C.B, &C.N, &C.max_iter, &C.check, &C.early_exit, &C.tire, &P.ws_rows,
                 &ops_smem, &smem};
  for (int i = 0; i < FUSED_INTS - 1; ++i) *ints[i] = iv[i];
  read_core_floats(C, fv);
  if (!make_sel(C, P.S)) return -1;
  if (P.ws_rows != WsLayout<M>(C.N).total) return -2;
  if (smem != (ops_smem ? BLOCK_LANES * OpsLayout<M>(C.N).total * 4 : 0)) return -2;
  if (C.B < 1 || C.N < 1 || C.check < 1 || C.max_iter < 1) return -3;
  cudaSetDevice(device);
  const int grid = (C.B + BLOCK - 1) / BLOCK * CLUSTER;
  return ops_smem ? launch_fused_as<M, true>(P, grid, smem, stream)
                  : launch_fused_as<M, false>(P, grid, smem, stream);
}

}  // namespace arl

// C entry: device pointers (the last, the section counters, null with
// tracing off), float and int parameters in the order of
// ops/fused_kernel.py::_fused_cuda (the last three ints: operands in shared
// memory, its bytes per block, the model: 0 dynamic, 1 kinematic). Returns
// -1 on an operand-count mismatch, -2 on a workspace- or shared-memory-size
// mismatch, -3 on a bad size or model, -4 if the card cannot hold one
// cluster of the shape (a launch that takes the clustered path), else the
// CUDA error of the launch.
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
#endif  // ARL_FUSED_TRACED_TU

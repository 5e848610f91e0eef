// Megastep: the whole receding-horizon control step of every scenario in
// one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/megastep_kernel.py::_megastep_kernel
// (with its body _mpc_core), a Pallas TPU kernel. Plain PyTorch version:
// ops/megastep_kernel.py::megastep_plain. One instantiation per model:
// the dynamic bicycle (nx=6) and the kinematic one (nx=4, BASELINE
// config 1), selected by the last int parameter.
//
// Design. A group of G threads owns one scenario (lane), 16 lanes a block
// and 8 blocks the 128 lanes that leave ADMM together, launched as a thread
// block cluster or co-resident (arl_sync.cuh, launch_group). Each group runs
// the tracker core of group_core.cuh (mpc_core_g, sections 1-8: schedule
// shift, curvature + friction-cap bounds, LPV + Van Loan + linear cost,
// warm-start shift, Riccati factor, ADMM in chunks of `check` iterations,
// residuals / rho, accept or limp-home), then section 9, n_sub Euler
// sub-steps of the Frenet plant, on the group's first thread. An optional
// (N+1, 2, B) e_y corridor (obstacle blocks evaluated on the host along the
// scheduled s) replaces row 1's box in section 2; its pointer is null
// otherwise, and the ADMM loop never reads it. With the discretization cache
// (SolverConfig.cache_build, its own instantiation: CACHE) the group core
// takes the JAX kernel's shift-reuse branch per 128-lane cluster: the drift
// of the new schedule from the cached one and the age, each a cluster-wide
// maximum (max_all), decide between building every stage and taking
// stage k + 1 of the old cache as stage k with only stage N-1 built
// (group_core.cuh::cache_stages_g); the kernel reads the old cache and
// writes a new one. The cache's pointers are null without it and the
// uncached instantiation is the kernel as it was; the cached one is always
// launched as clusters. With early exit the group votes after each chunk
// (vote_group: the cluster's vote_all, or, in the co-resident instantiation,
// which takes the device's vote slots as a second argument,
// vote_all_resident) and stops when all its 128 lanes have a done-at: the
// 128-lane grouping of the TPU kernel. Lanes
// past B vote "done" and touch no memory. With a section-counter pointer
// (tracing on) the traced instantiation runs (TRACE, its own translation
// unit, megastep_traced_kernel.cu): each lane's thread 0 adds its cycles per
// section, the plant's included, and its counts into the counters
// (group_core.cuh, Sec); the untraced one reads no clock. The stage
// operands, iterate and linear terms live in the block's shared memory, or
// in the device-memory workspace where N is too long
// (ops/fused_kernel.py::launch_shape).
//
// What bounds it on the H100: the operations of the core (~0.12 MFLOP per
// lane at N=20 and ~8 executed iterations, dynamic). What stands between it
// and that bound is latency: each ADMM stage is a short dependent chain
// (mat-vec, shuffle broadcast, next stage); the group shortens it by G and
// keeps the operands that every iteration re-reads at shared-memory
// latency, as in the fused kernel and the racestep.
#include "group_core.cuh"

namespace arl {

template <class M>
struct MegaParams {
  CoreParams<M> C;
  Sel<M> S;
  const float *x, *xref, *prm;   // (nx, B), (N+1, nx, B), (10, B)
  float *x_out, *ws;             // (nx, B), (ws_rows, B) per-lane workspace
  int n_sub, sim_tire, ws_rows;
  CacheIO cache;                 // null pointers without the cache
  // (N_SEC,) section counters (group_core.cuh, Sec), or null: tracing off.
  // Last, so that every other member keeps its place in the untraced kernel
  unsigned long long* sec;
};

constexpr int MEGA_PTRS = 33;
constexpr int MEGA_INTS = 15;

// At most 168 registers, so that three blocks of 128 threads fit on an SM
// where the shared memory allows it (the kinematic model at N=10); the
// dynamic model fits in them without spills. `vote`: empty (clustered), or
// the device's vote slots (co-resident; arl_sync.cuh, launch_group).
template <class M, bool SM, bool CACHE, bool TRACE, class... Vote>
__global__ void __launch_bounds__(GROUP_THREADS, 3) megastep_kernel(const __grid_constant__ MegaParams<M> P,
                                                                    Vote... vote) {
  constexpr int NX = M::NX;
  const Grp<LANE_THREADS> gr;
  const int lane = threadIdx.x / LANE_THREADS;
  const int b = blockIdx.x * BLOCK_LANES + lane;
  const int S = P.C.B;
  const bool active = b < S;
  const int bb = active ? b : 0;
  const Lane ws = lane_of(P.ws, bb, S);
  const Ops<SM> op = ops_of<M, SM>(P.C.N, lane, P.ws, bb, S);
  sec_begin<TRACE>();
  VehParams pv{};
  float x[NX] = {};
  if (active) {
    pv = load_params(P.prm, b, S);
    const Lane xl = lane_of(P.x, b, S);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xl[i];
  }
  float u0[NU];
  mpc_core_g(P.C, P.S, b, active, x, pv, lane_of(P.xref, bb, S), ws, op, gr, u0, &P.cache,
             std::bool_constant<CACHE>{}, std::bool_constant<TRACE>{}, vote...);
  if (!active || gr.g != 0) return sec_end<TRACE>(P.sec, gr.g);
  sec_switch<TRACE>(0, SEC_FINISH, SEC_PLANT);
  const Lane st = lane_of(P.C.stats, b, S);
  st[5] = 0.0f;
  st[6] = 0.0f;
  st[7] = 0.0f;

  // 9. plant: n_sub Euler sub-steps of the nonlinear model
  const float length = P.C.taux[0], inv_ds = P.C.taux[1];
  const float h = P.C.dt / (float)P.n_sub;
  for (int i = 0; i < P.n_sub; ++i) {
    float dx[NX];
    M::f(pv, x, u0, kap_at(P.C.kappa, P.C.n_cells, length, inv_ds, x[M::S]), P.sim_tire, dx);
#pragma unroll
    for (int j = 0; j < NX; ++j) x[j] = x[j] + h * dx[j];
  }
  const Lane x_out = lane_of(P.x_out, b, S);
#pragma unroll
  for (int i = 0; i < NX; ++i) x_out[i] = x[i];
  sec_close<TRACE>(0, SEC_PLANT);
  sec_end<TRACE>(P.sec, 0);
}

// The cached and the traced instantiations are compiled in translation
// units of their own (megastep_cache_kernel.cu and megastep_traced_kernel.cu,
// which include this file with ARL_MEGASTEP_CACHED_TU or
// ARL_MEGASTEP_TRACED_TU defined), so that their nvcc runs beside this one's
// and the build's wall time does not grow by theirs. The cached
// instantiations keep no section counters.
template <class M, bool SM>
int launch_megastep_cached(const MegaParams<M>& P, int grid, int smem, void* stream);
template <class M, bool SM>
int launch_megastep_traced(const MegaParams<M>& P, int grid, int smem, void* stream);

#if defined(ARL_MEGASTEP_CACHED_TU)
template <class M, bool SM>
int launch_megastep_cached(const MegaParams<M>& P, int grid, int smem, void* stream) {
  return launch_clustered(megastep_kernel<M, SM, true, false>, P, grid, smem, stream,
                          "megastep_kernel");
}

template int launch_megastep_cached<Dynamic, true>(const MegaParams<Dynamic>&, int, int, void*);
template int launch_megastep_cached<Dynamic, false>(const MegaParams<Dynamic>&, int, int, void*);
template int launch_megastep_cached<Kinematic, true>(const MegaParams<Kinematic>&, int, int, void*);
template int launch_megastep_cached<Kinematic, false>(const MegaParams<Kinematic>&, int, int, void*);

}  // namespace arl
#elif defined(ARL_MEGASTEP_TRACED_TU)
template <class M, bool SM>
int launch_megastep_traced(const MegaParams<M>& P, int grid, int smem, void* stream) {
  return launch_group(megastep_kernel<M, SM, false, true>,
                      megastep_kernel<M, SM, false, true, VoteSlot*>, P, grid, smem, stream,
                      "megastep_kernel", P.C.early_exit != 0);
}

template int launch_megastep_traced<Dynamic, true>(const MegaParams<Dynamic>&, int, int, void*);
template int launch_megastep_traced<Dynamic, false>(const MegaParams<Dynamic>&, int, int, void*);
template int launch_megastep_traced<Kinematic, true>(const MegaParams<Kinematic>&, int, int, void*);
template int launch_megastep_traced<Kinematic, false>(const MegaParams<Kinematic>&, int, int, void*);

}  // namespace arl
#else
template <class M, bool SM>
int launch_megastep_as(const MegaParams<M>& P, int grid, int smem, void* stream) {
  if (P.cache.A) return launch_megastep_cached<M, SM>(P, grid, smem, stream);
  return P.sec ? launch_megastep_traced<M, SM>(P, grid, smem, stream)
               : launch_group(megastep_kernel<M, SM, false, false>,
                              megastep_kernel<M, SM, false, false, VoteSlot*>, P, grid, smem,
                              stream, "megastep_kernel", P.C.early_exit != 0);
}

template <class M>
int launch_megastep(void** ptrs, const float* fv, int n_f, const int* iv, int device,
                    void* stream) {
  if (n_f != core_floats<M>() + 1) return -1;
  MegaParams<M> P{};
  CoreParams<M>& C = P.C;
  CacheIO& K = P.cache;
  const float** in[] = {&P.x, &C.Xp, &C.Up, &C.sw, &C.lamw, &C.uprev, &C.rho, &P.xref,
                        &P.prm, &C.kappa, &C.taux, &C.eyb};
  float** out[] = {&P.x_out, &C.Xp_out, &C.Up_out, &C.s_out, &C.lam_out, &C.u0_out,
                   &C.stats, &P.ws};
  const float** cache_in[] = {&K.A, &K.B, &K.Xs, &K.Us, &K.kap, &K.age};
  float** cache_out[] = {&K.A_out, &K.B_out, &K.Xs_out, &K.Us_out, &K.kap_out, &K.age_out};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  int n_null = 0;
  for (auto q : cache_in) n_null += (*q = static_cast<const float*>(ptrs[p++])) == nullptr;
  for (auto q : cache_out) n_null += (*q = static_cast<float*>(ptrs[p++])) == nullptr;
  if (n_null != 0 && n_null != 12) return -1;   // the whole cache or none of it
  P.sec = static_cast<unsigned long long*>(ptrs[p++]);
  int ops_smem = 0, smem = 0;
  int* ints[] = {&C.B, &C.N, &C.n_cells, &P.n_sub, &C.max_iter, &C.check, &C.early_exit,
                 &C.tire, &P.sim_tire, &C.kappa_speed_cap, &P.ws_rows, &ops_smem, &smem,
                 &K.max_age};
  for (int i = 0; i < MEGA_INTS - 1; ++i) *ints[i] = iv[i];
  read_core_floats(C, fv);
  K.tol = fv[core_floats<M>()];
  if (!make_sel(C, P.S)) return -1;
  if (P.ws_rows != WsLayout<M>(C.N).total) return -2;
  if (smem != (ops_smem ? BLOCK_LANES * OpsLayout<M>(C.N).total * 4 : 0)) return -2;
  if (C.B < 1 || C.N < 1 || C.check < 1 || C.max_iter < 1 || P.n_sub < 1 || C.n_cells < 1)
    return -3;
  cudaSetDevice(device);
  const int grid = (C.B + BLOCK - 1) / BLOCK * CLUSTER;
  return ops_smem ? launch_megastep_as<M, true>(P, grid, smem, stream)
                  : launch_megastep_as<M, false>(P, grid, smem, stream);
}

}  // namespace arl

// C entry: device pointers (the corridor, the last input, may be null;
// then the cache's six inputs and six outputs, all null without the
// cache; last the section counters, null with tracing off and ignored with
// the cache), float and int parameters in the order of
// ops/megastep_kernel.py::_megastep_cuda (the floats end with
// cache_drift_tol; the last four ints: operands in shared memory, its bytes
// per block, cache_max_age, the model: 0 dynamic, 1 kinematic).
// Returns -1 on an operand-count mismatch, -2 on a workspace- or
// shared-memory-size mismatch, -3 on a bad size or model, -4 if the card
// cannot hold one cluster of the shape (a launch that takes the clustered
// path), else the CUDA error of the launch.
extern "C" int arl_megastep(void** ptrs, int n_ptrs, const float* fv, int n_f, const int* iv,
                            int n_i, int device, void* stream) {
  using namespace arl;
  if (n_ptrs != MEGA_PTRS || n_i != MEGA_INTS) return -1;
  switch (iv[MEGA_INTS - 1]) {
    case 0: return launch_megastep<Dynamic>(ptrs, fv, n_f, iv, device, stream);
    case 1: return launch_megastep<Kinematic>(ptrs, fv, n_f, iv, device, stream);
    default: return -3;
  }
}
#endif  // ARL_MEGASTEP_CACHED_TU, ARL_MEGASTEP_TRACED_TU

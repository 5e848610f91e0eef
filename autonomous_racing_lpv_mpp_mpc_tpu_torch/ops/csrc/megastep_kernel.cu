// Megastep: the whole receding-horizon control step of every scenario in
// one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/megastep_kernel.py::_megastep_kernel
// (with its body _mpc_core), a Pallas TPU kernel. Plain PyTorch version:
// ops/megastep_kernel.py::megastep_plain. One instantiation per model:
// the dynamic bicycle (nx=6) and the kinematic one (nx=4, BASELINE
// config 1), selected by the last int parameter.
//
// Design. One thread owns one scenario; 128 threads form a block. Each
// thread runs the tracker core of mpc_core.cuh (sections 1-8: schedule
// shift, curvature + friction-cap bounds, LPV + Van Loan + linear cost,
// warm-start shift, Riccati factor, ADMM in chunks of `check` iterations,
// residuals / rho, accept or limp-home), then section 9, n_sub Euler
// sub-steps of the Frenet plant. With early exit, the block votes after
// each chunk (__syncthreads_and) and stops when all its lanes have a
// done-at: the 128-lane grouping of the TPU kernel, so results match lane
// for lane. Lanes past B vote "done" and touch no memory.
//
// What bounds it on the H100: each lane is one long serial chain of small
// dense algebra (per ADMM iteration 20 stages of 8x8 mat-vecs backward and
// forward) with little parallelism inside a lane, and a per-lane workspace
// (2,493 floats at N=20, computed from WsLayout) for the stage matrices,
// gains and iterates — far beyond registers or shared memory, so
// it lives in device memory, batch-last so every warp access is one
// coalesced 128-byte line, and mostly inside the 50 MB L2. The augmented
// dynamics [[Ad 0][0 0]], [[Bd][I]] are stored as Ad (6x6) and Bd (6x2)
// only, which cuts the iteration's loads to ~60%. Only 32 blocks exist at
// B=4096, so most SMs idle: finer-grained work per lane is later work.
#include "mpc_core.cuh"

namespace arl {

template <class M>
struct MegaParams {
  CoreParams<M> C;
  const float *x, *xref, *prm;   // (nx, B), (N+1, nx, B), (10, B)
  float *x_out, *ws;             // (nx, B), (ws_rows, B) per-lane workspace
  int n_sub, sim_tire, ws_rows;
};

constexpr int MEGA_PTRS = 19;
constexpr int MEGA_INTS = 12;

template <class M>
__global__ void __launch_bounds__(BLOCK) megastep_kernel(const __grid_constant__ MegaParams<M> P) {
  constexpr int NX = M::NX;
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = b < P.C.B;
  const int S = P.C.B;
  const Lane ws = lane_of(P.ws, active ? b : 0, S);
  VehParams pv{};
  float x[NX] = {};
  if (active) {
    pv = load_params(P.prm, b, S);
    const Lane xl = lane_of(P.x, b, S);
    for (int i = 0; i < NX; ++i) x[i] = xl[i];
  }
  float u0[NU];
  mpc_core(P.C, b, active, x, pv, lane_of(P.xref, active ? b : 0, S), ws, u0);
  if (!active) return;
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
  for (int i = 0; i < NX; ++i) x_out[i] = x[i];
}

template <class M>
int launch_megastep(void** ptrs, const float* fv, int n_f, const int* iv, int device,
                    void* stream) {
  if (n_f != core_floats<M>()) return -1;
  MegaParams<M> P;
  CoreParams<M>& C = P.C;
  const float** in[] = {&P.x, &C.Xp, &C.Up, &C.sw, &C.lamw, &C.uprev, &C.rho, &P.xref,
                        &P.prm, &C.kappa, &C.taux};
  float** out[] = {&P.x_out, &C.Xp_out, &C.Up_out, &C.s_out, &C.lam_out, &C.u0_out,
                   &C.stats, &P.ws};
  int p = 0;
  for (auto q : in) *q = static_cast<const float*>(ptrs[p++]);
  for (auto q : out) *q = static_cast<float*>(ptrs[p++]);
  int* ints[] = {&C.B, &C.N, &C.n_cells, &P.n_sub, &C.max_iter, &C.check, &C.early_exit,
                 &C.tire, &P.sim_tire, &C.kappa_speed_cap, &P.ws_rows};
  for (int i = 0; i < MEGA_INTS - 1; ++i) *ints[i] = iv[i];
  read_core_floats(C, fv);
  if (P.ws_rows != WsLayout<M>(C.N).total) return -2;
  if (C.B < 1 || C.N < 1 || C.check < 1 || C.max_iter < 1 || P.n_sub < 1) return -3;
  cudaSetDevice(device);
  const int grid = (C.B + BLOCK - 1) / BLOCK;
  megastep_kernel<M><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace arl

// C entry: device pointers, float and int parameters in the order of
// ops/megastep_kernel.py::_megastep_cuda; the last int selects the model
// (0 dynamic, 1 kinematic). Returns -1 on an operand-count mismatch, -2 on
// a workspace-size mismatch, -3 on a bad size or model, else
// cudaGetLastError().
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

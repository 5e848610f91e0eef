// The tracker core's parameters, constants and per-lane workspace layout:
// what the group core (group_core.cuh::mpc_core_g, sections 1-8 of one
// receding-horizon step) and the three kernels that run it (megastep,
// racestep, fused) share.
//
// Counterpart of the JAX package's ops/megastep_kernel.py::_mpc_core, which
// its megastep and racestep Pallas kernels share; plain PyTorch version:
// ops/megastep_kernel.py::mpc_core_plain. Everything is a template on the
// model traits M of arl_common.cuh (Dynamic, Kinematic): the state width,
// the augmented width, the indices of s and e_y, the stage build.
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
  // (N+1, 2, B) per-stage e_y corridor (lo, hi) replacing row 1's box, or
  // null: obstacles on the fast path (JAX ops/megastep_kernel.py::_mpc_core,
  // eyb_ref). Read once per stage in prepare_g, never in the ADMM loop.
  const float *eyb;
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
// core_workspace mirrors the total. Ad holds the fixed columns once and each
// stage's computed columns (AdMap), the slots of the device-memory operands
// (group_core.cuh Ops).
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
    Ad = o;   o += N * AdMap<M>::n;
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

}  // namespace arl

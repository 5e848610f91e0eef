"""Fused assembly + solve: LPV + Van Loan + augmentation + folded cost +
Riccati + ADMM for every lane in one kernel launch (kernel 4; CUDA source
``csrc/fused_kernel.cu``).

Replaces the JAX package's ``ops/fused_kernel.py::_fused_kernel`` (Pallas,
launched by ``fused_mpc_solve``), the solve of ``mpc_step_batched`` with
``backend="fused"``. Scheduling, bounds, the reference and the warm-start
shift stay outside (``loop.mpc.mpc_prepare_light``), as does the rho
adaptation: the kernel returns the residual rows, the wrapper adapts rho.
Per lane:

    1 the N stage matrices from the scheduled (x, u, kappa) and the linear
      cost from the reference as given -> 2 rho-folded cost + Riccati
      factor -> 3 ADMM from s0 (clipped to the bounds) and lam0 with X, U
      at zero, the OSQP termination test after EVERY iteration (exact
      done-at) -> 4 the residual rows of the last executed iteration

With ``SolverConfig.early_exit`` the ADMM loop of a 128-lane group stops at
the first boundary of a chunk of ``check_termination`` iterations where
every lane of the group has a done-at; the remainder tail runs only if
some lane has not. Both the dynamic (nx=6) and the kinematic (nx=4) model.

On the card a lane is a group of ``THREADS_PER_LANE`` threads and the
128-lane group a cluster of thread blocks; :func:`launch_shape` gives the
shape and where the stage operands live (the racestep uses it too).

This module also holds what the three tracker kernels share in plain
PyTorch: the constant operands (``_make_consts``), the batch-last
small-matrix helpers, the Riccati factor and the ADMM loop that
``megastep_kernel.mpc_core_plain`` runs too. :func:`fused_solve_plain` is
the plain version; the wrapper :func:`fused_mpc_solve` takes it for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..solver.admm import ADMMSolution, ADMMState, _new_rho
from . import _cuda
from .stage_math import (
    NC,
    NU,
    model_dims,
    model_s_ey,
    stack_params,
    stage_aug_ab,
    unpack_params,
)

GROUP = 128   # lanes that exit the ADMM loop together (one CUDA thread block cluster)
THREADS_PER_LANE = 8          # csrc/arl_sync.cuh LANE_THREADS
LANES_PER_BLOCK = 16          # csrc/arl_sync.cuh BLOCK_LANES
BLOCK_SMEM = 232_448          # bytes of shared memory one block may use on the H100
STATIC_SMEM = 1_024           # room left for the kernels' static shared memory
MODELS = {"dynamic": 0, "kinematic": 1}
TIRES = {"linear": 0, "pacejka": 1}


class MegaConsts(NamedTuple):
    """Host-side constant operands (the JAX fused kernel's ``_make_consts``)."""

    Dx: torch.Tensor     # (NC, na)
    Du: torch.Tensor     # (NC, NU)
    soft: torch.Tensor   # (NC,)
    Qc: torch.Tensor     # (na, na) stage cost + sigma I
    Qtc: torch.Tensor    # (na, na) terminal cost + sigma I
    Rc: torch.Tensor     # (NU, NU)
    Mc: torch.Tensor     # (na, NU)
    DxDx: torch.Tensor
    DuDu: torch.Tensor
    DxDu: torch.Tensor
    qw: torch.Tensor     # (nx,)


def _make_consts(cfg: MPCConfig, scfg: SolverConfig, device="cpu") -> MegaConsts:
    """Constraint rows, soft weights and the sigma-shifted cost blocks of
    ``cfg.model`` (the e_y row at the model's e_y index)."""
    w = cfg.weights
    sigma = float(scfg.sigma)
    nx, na = model_dims(cfg.model)
    _, ey_i = model_s_ey(cfg.model)
    Dx = np.zeros((NC, na), np.float32)
    Du = np.zeros((NC, NU), np.float32)
    Dx[0, 0] = 1.0
    Dx[1, ey_i] = 1.0
    Du[2, 0] = 1.0
    Du[3, 1] = 1.0
    Dx[4, nx] = -1.0
    Du[4, 0] = 1.0
    Dx[5, nx + 1] = -1.0
    Du[5, 1] = 1.0
    soft = np.full((NC,), np.inf, np.float32)
    soft[1] = float(cfg.bounds.ey_soft)
    q_w = np.asarray(w.q, np.float32)
    if q_w.shape[0] != nx:
        raise ValueError(f"MPCWeights.q has {q_w.shape[0]} entries but model {cfg.model!r} has "
                         f"{nx} states; use MPCWeights.for_model")
    r_w = np.asarray(w.r, np.float32)
    dr_w = np.asarray(w.dr, np.float32)
    Qc = np.diag(np.concatenate([q_w, dr_w])) + sigma * np.eye(na, dtype=np.float32)
    Qtc = np.diag(np.concatenate([q_w, np.zeros(NU, np.float32)])) + sigma * np.eye(na, dtype=np.float32)
    Rc = np.diag(r_w + dr_w) + sigma * np.eye(NU, dtype=np.float32)
    Mc = np.zeros((na, NU), np.float32)
    Mc[nx:, :] = -np.diag(dr_w)
    arrs = (Dx, Du, soft, Qc, Qtc, Rc, Mc, Dx.T @ Dx, Du.T @ Du, Dx.T @ Du, q_w)
    return MegaConsts(*(torch.tensor(np.asarray(a, np.float32), device=device) for a in arrs))


@functools.lru_cache(maxsize=64)
def core_floats(cfg: MPCConfig, scfg: SolverConfig) -> tuple:
    """The float parameters of ``mpc_core.cuh``'s ``CoreParams`` in its
    order: 15 scalars, then the constants of :func:`_make_consts` (built
    once per configuration: the wrappers call this every launch)."""
    b = cfg.bounds
    k = _make_consts(cfg, scfg)
    return tuple([cfg.dt, scfg.sigma, scfg.alpha, scfg.eps_abs, scfg.eps_rel, scfg.eps_fallback,
                  b.vx_min, b.vx_max, b.ey_max, b.delta_max, b.a_min, b.a_max, b.ddelta_max,
                  b.da_max, cfg.a_lat_frac] + torch.cat([t.reshape(-1) for t in k]).tolist())


def core_workspace(N: int, model: str = "dynamic") -> int:
    """Per-lane float32 workspace of ``mpc_core.cuh``'s ``WsLayout``."""
    nx, na = model_dims(model)
    return ((N + 1) * nx + N * NU + (N + 1) + 2 * (N + 1) * NC + N * nx * nx
            + N * nx * NU + (N + 1) * nx + N * NU * na + N * NU * NU + N * NU * na
            + N * NU + (N + 1) * na + N * NU)


class LaunchShape(NamedTuple):
    """Launch shape of the group core's kernels (megastep, racestep, fused):
    THREADS_PER_LANE adjacent threads own a lane, a block holds
    LANES_PER_BLOCK lanes, a cluster of ``cluster`` blocks the GROUP lanes
    of one early-exit vote (fixed in ``csrc/arl_sync.cuh``); the
    per-iteration ADMM operands live in ``smem_bytes`` of dynamic shared
    memory per block, or in the device-memory workspace when
    ``ops_in_smem`` is False."""

    cluster: int
    smem_bytes: int
    ops_in_smem: bool

    def ints(self) -> list:
        """The shape's ints of the kernels' C entries."""
        return [int(self.ops_in_smem), self.smem_bytes]


def ops_floats(N: int, model: str = "dynamic") -> int:
    """Per-lane float32 ADMM operands of ``group_core.cuh``'s ``OpsLayout``:
    Ad, Bd, the first nx columns of Hux, Hiv and d of every stage, the
    backward sweep's linear terms (N+1, na) and (N, NU), the iterate X
    (N+1, na) and U (N, NU)."""
    nx, na = model_dims(model)
    return N * (nx * nx + 2 * nx * NU + NU * NU + 3 * NU) + 2 * (N + 1) * na


def launch_shape(N: int, model: str = "dynamic") -> LaunchShape:
    """The launch shape for horizon N: the ADMM operands in shared memory
    where a block's lanes fit in what a block may hold, else in device
    memory (chosen from N and the model alone)."""
    smem = LANES_PER_BLOCK * ops_floats(N, model) * 4
    fits = smem <= BLOCK_SMEM - STATIC_SMEM
    return LaunchShape(GROUP // LANES_PER_BLOCK, smem if fits else 0, fits)


# ---- batch-last small-matrix helpers (matrix dims lead, batch last) ----

def _mm(a, b):
    return torch.einsum("ijb,jlb->ilb", a, b)


def _mtm(a, b):
    return torch.einsum("jib,jlb->ilb", a, b)


def _mv(a, x):
    return torch.einsum("ijb,jb->ib", a, x)


def _mtv(a, x):
    return torch.einsum("jib,jb->ib", a, x)


def _inv2(H):
    a, b, c, d = H[0, 0], H[0, 1], H[1, 0], H[1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d * inv_det, -b * inv_det]),
                        torch.stack([-c * inv_det, a * inv_det])])


def _dual_norm(k: MegaConsts, y, N):
    """inf-norm of D' y over the stages; y (N+1, NC, B) -> (B,)."""
    tx = torch.einsum("ci,kcb->kib", k.Dx, y)
    tu = torch.einsum("ci,kcb->kib", k.Du, y[:N])
    return torch.maximum(tx.abs().amax(dim=(0, 1)), tu.abs().amax(dim=(0, 1)))


def _groups_done(da):
    """(B,) lane mask: the lane's 128-lane group has a done-at everywhere
    (lanes past B count as done)."""
    B = da.shape[0]
    n_g = -(-B // GROUP)
    done = torch.ones(n_g * GROUP, dtype=torch.bool, device=da.device)
    done[:B] = da >= 0.0
    return done.reshape(n_g, GROUP).all(dim=1).repeat_interleave(GROUP)[:B]


def riccati_factor_plain(k: MegaConsts, A_s, B_s, rho):
    """Backward Riccati factorization of the rho-folded cost over the
    augmented stages A_s (N, na, na, B), B_s (N, na, NU, B). Returns the
    per-stage lists (K, Hiv, Hux)."""
    N = A_s.shape[0]
    c1 = lambda a: a[:, :, None]
    Qf = c1(k.Qc) + c1(k.DxDx) * rho
    V = c1(k.Qtc) + c1(k.DxDx) * rho
    Rf = c1(k.Rc) + c1(k.DuDu) * rho
    Mf = c1(k.Mc) + c1(k.DxDu) * rho
    K_s, Hiv_s, Hux_s = [None] * N, [None] * N, [None] * N
    for i in range(N - 1, -1, -1):
        Ak, Bk = A_s[i], B_s[i]
        VB = _mm(V, Bk)
        Huu = Rf + _mtm(Bk, VB)
        VA = _mm(V, Ak)
        Hux = Mf.transpose(0, 1) + _mtm(Bk, VA)
        Hiv = _inv2(Huu)
        K = -_mm(Hiv, Hux)
        K_s[i], Hiv_s[i], Hux_s[i] = K, Hiv, Hux
        Vn = Qf + _mtm(Ak, VA) + _mtm(Hux, K)
        V = 0.5 * (Vn + Vn.transpose(0, 1))
    return K_s, Hiv_s, Hux_s


def residual_rows(k: MegaConsts, N, G, s, lam, sprev, rho):
    """The OSQP termination quantities of an iterate: |G - s|, rho |D'(s -
    s_prev)|, |G|, |s|, |D' lam| (inf-norms per lane)."""
    red = lambda t: t.abs().amax(dim=(0, 1))
    return red(G - s), rho * _dual_norm(k, s - sprev, N), red(G), red(s), _dual_norm(k, lam, N)


def admm_plain(scfg: SolverConfig, k: MegaConsts, A_s, B_s, gains, q0, lb, ub, x0a, s, lam, rho,
               exact_done_at: bool):
    """ADMM from (s, lam) with X, U at zero (the sigma-prox reads the
    previous iterate), with the 128-lane early exit of ``scfg``. The
    termination test is recorded after every iteration (``exact_done_at``,
    the fused kernel) or at chunk boundaries (the megastep's core).

    Returns (s, lam, X, U, G, s_prev, done_at): the last executed
    iteration's iterate, G = D z, the split before it, and the first
    iteration (or boundary) at which the test held, -1 if never."""
    K_s, Hiv_s, Hux_s = gains
    N, na = A_s.shape[0], A_s.shape[1]
    B = x0a.shape[-1]
    f32 = dict(dtype=torch.float32, device=x0a.device)
    sigma, alpha = float(scfg.sigma), float(scfg.alpha)
    Xsol = torch.zeros((N + 1, na, B), **f32)
    Usol = torch.zeros((N, NU, B), **f32)
    G = torch.zeros((N + 1, NC, B), **f32)
    sprev = s
    beta = torch.clamp_max(k.soft, 1e30)[None, :, None]
    hard = torch.isinf(k.soft)[None, :, None]
    rinv = 1.0 / rho
    soft_blend_inv = 1.0 / (beta + rho)

    def iteration(s, lam, Xsol, Usol):
        v = s - lam * rinv
        qv = q0 - rho * torch.einsum("ci,kcb->kib", k.Dx, v) - sigma * Xsol
        rv = -rho * torch.einsum("ci,kcb->kib", k.Du, v[:N]) - sigma * Usol
        vvec = qv[N]
        d = [None] * N
        for i in range(N - 1, -1, -1):
            h_u = rv[i] + _mtv(B_s[i], vvec)
            d[i] = -_mv(Hiv_s[i], h_u)
            vvec = qv[i] + _mtv(A_s[i], vvec) + _mtv(Hux_s[i], d[i])
        xs, us = [x0a], []
        x = x0a
        for i in range(N):
            u = _mv(K_s[i], x) + d[i]
            x = _mv(A_s[i], x) + _mv(B_s[i], u)
            xs.append(x)
            us.append(u)
        Xn, Un = torch.stack(xs), torch.stack(us)
        Gx = torch.einsum("ci,kib->kcb", k.Dx, Xn)
        Gu = torch.einsum("ci,kib->kcb", k.Du, Un)
        Gn = torch.cat([Gx[:N] + Gu, Gx[N:]], dim=0)
        w_rel = alpha * Gn + (1.0 - alpha) * s
        wl = w_rel + lam * rinv
        clipped = torch.clamp(wl, lb, ub)
        soft_s = (beta * clipped + rho * wl) * soft_blend_inv
        s_new = torch.where(hard, clipped, soft_s)
        return s_new, lam + rho * (w_rel - s_new), Xn, Un, Gn, s

    def record(state, da, it1):
        r_p, r_d, g_max, s_max, d_lam = residual_rows(k, N, state[4], state[0], state[1], state[5], rho)
        conv = (r_p <= scfg.eps_abs + scfg.eps_rel * torch.maximum(g_max, s_max)) & \
               (r_d <= scfg.eps_abs + scfg.eps_rel * d_lam)
        return torch.where((da < 0.0) & conv, torch.full_like(da, float(it1)), da)

    def run(state, da, n_it, it0, act=None):
        for j in range(n_it):
            new = iteration(*state[:4])
            if act is None:
                state = new
            else:
                state = tuple(torch.where(act, n, o) for n, o in zip(new, state))
            if exact_done_at:
                da = record(state, da, it0 + j + 1)
        return state, da

    da = torch.full((B,), -1.0, **f32)
    state = (s, lam, Xsol, Usol, G, sprev)
    check = max(1, scfg.check_termination)
    n_chunks = scfg.max_iter // check
    rem = scfg.max_iter - n_chunks * check
    for c in range(n_chunks):
        act = None
        if scfg.early_exit:
            act = ~_groups_done(da)
            if not bool(act.any()):
                break
        state, da = run(state, da, check, c * check, act)
        if not exact_done_at:
            da = record(state, da, (c + 1) * check)
    act = ~_groups_done(da) if scfg.early_exit else None
    if rem and (act is None or bool(act.any())):
        state, da = run(state, da, rem, n_chunks * check, act)
    return state + (da,)


# ---- the fused solve ----

def _check_fused(cfg: MPCConfig, scfg: SolverConfig):
    if cfg.linearization != "lpv" or cfg.discretization != "expm":
        raise NotImplementedError("the fused solve builds LPV stages with the Van Loan expm")
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if scfg.max_iter < 1:
        raise ValueError("fused_mpc_solve: max_iter must be >= 1")


def _solution(scfg: SolverConfig, rho, X, U, s, lam, stats) -> ADMMSolution:
    """Batch-last solution + stats rows (r_prim, r_dual, |G|, |s|, |D'lam|,
    done-at) -> batch-first :class:`ADMMSolution` with the adapted rho."""
    fb = lambda t: t.movedim(-1, 0)
    r_prim, r_dual = stats[0], stats[1]
    eps_prim = scfg.eps_abs + scfg.eps_rel * torch.maximum(stats[2], stats[3])
    eps_dual = scfg.eps_abs + scfg.eps_rel * stats[4]
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    no = torch.zeros(r_prim.shape, dtype=torch.bool, device=r_prim.device)
    X, U, s, lam = fb(X), fb(U), fb(s), fb(lam)
    st = ADMMState(X, U, s, lam, r_prim, r_dual, eps_prim, eps_dual, no)
    return ADMMSolution(X=X, U=U, s=s, lam=lam, r_prim=r_prim, r_dual=r_dual, converged=converged,
                        iters=stats[5].to(torch.int32), rho=_new_rho(rho, st), primal_infeasible=no)


def fused_solve_plain(cfg: MPCConfig, scfg: SolverConfig, p_b: VehicleParams, X_sched, U_sched,
                      kappas, x_ref_b, lb, ub, x0a, s0, lam0, rho0) -> ADMMSolution:
    """Plain PyTorch version of the fused kernel (any device). Batch-first
    inputs: X_sched (B, N+1, nx), U_sched (B, N, NU), kappas (B, N), x_ref_b
    (B, N+1, nx) used as given, lb/ub/s0/lam0 (B, N+1, NC), x0a (B, na),
    rho0 (B,)."""
    _check_fused(cfg, scfg)
    N, B, dev = cfg.N, x0a.shape[0], x0a.device
    k = _make_consts(cfg, scfg, dev)
    pv = unpack_params(stack_params(p_b, B, dev))
    Aa, Ba = stage_aug_ab(X_sched[:, :N].permute(2, 1, 0), U_sched.permute(2, 1, 0), kappas.T, pv,
                          dt=float(cfg.dt), tire=cfg.tire, model=cfg.model)
    A_s = Aa.permute(2, 0, 1, 3)                                  # (N, na, na, B)
    B_s = Ba.permute(2, 0, 1, 3)                                  # (N, na, NU, B)
    bl = lambda t: t.permute(1, 2, 0)
    q0 = torch.cat([-(k.qw[None, :, None] * bl(x_ref_b)),
                    torch.zeros((N + 1, NU, B), dtype=torch.float32, device=dev)], dim=1)
    lb_b, ub_b = bl(lb), bl(ub)
    rho = torch.as_tensor(rho0, dtype=torch.float32, device=dev).expand(B)
    gains = riccati_factor_plain(k, A_s, B_s, rho)
    s, lam, X, U, G, sprev, da = admm_plain(
        scfg, k, A_s, B_s, gains, q0, lb_b, ub_b, x0a.T, torch.clamp(bl(s0), lb_b, ub_b), bl(lam0),
        rho, exact_done_at=True)
    iters = torch.where(da > 0.0, da, torch.full_like(da, float(scfg.max_iter)))
    stats = torch.stack(residual_rows(k, N, G, s, lam, sprev, rho) + (iters,))
    return _solution(scfg, rho, X, U, s, lam, stats)


def fused_mpc_solve(cfg: MPCConfig, scfg: SolverConfig, p_b: VehicleParams, X_sched, U_sched,
                    kappas, x_ref_b, lb, ub, x0a, s0, lam0, rho0) -> ADMMSolution:
    """The fused solve of every lane: the plain version for CPU tensors,
    one CUDA kernel launch for CUDA tensors (the JAX signature, batch-first
    operands; see :func:`fused_solve_plain`)."""
    dev = x0a.device
    if dev.type == "cpu":
        return fused_solve_plain(cfg, scfg, p_b, X_sched, U_sched, kappas, x_ref_b, lb, ub, x0a,
                                 s0, lam0, rho0)
    if dev.type != "cuda":
        raise ValueError(f"fused_mpc_solve: tensors on {dev}; expected cpu or cuda")
    return _fused_cuda(cfg, scfg, p_b, X_sched, U_sched, kappas, x_ref_b, lb, ub, x0a, s0, lam0,
                       rho0)


def _fused_cuda(cfg, scfg, p_b, X_sched, U_sched, kappas, x_ref_b, lb, ub, x0a, s0, lam0, rho0):
    """Launch the kernel on the operands' device (batch-last operands)."""
    _check_fused(cfg, scfg)
    if cfg.tire not in TIRES:
        raise ValueError(f"fused_mpc_solve: unknown tire {cfg.tire!r}")
    nx, na = model_dims(cfg.model)
    N, B, dev = cfg.N, x0a.shape[0], x0a.device
    want = {"X_sched": (X_sched, (B, N + 1, nx)), "U_sched": (U_sched, (B, N, NU)),
            "kappas": (kappas, (B, N)), "x_ref_b": (x_ref_b, (B, N + 1, nx)),
            "lb": (lb, (B, N + 1, NC)), "ub": (ub, (B, N + 1, NC)), "x0a": (x0a, (B, na)),
            "s0": (s0, (B, N + 1, NC)), "lam0": (lam0, (B, N + 1, NC))}
    for name, (t, dims) in want.items():
        if tuple(t.shape) != dims:
            raise ValueError(f"fused_mpc_solve: {name} has shape {tuple(t.shape)}, expected {dims}")
    kw = dict(dtype=torch.float32, device=dev)
    bl = lambda t: t.to(torch.float32).movedim(0, -1).contiguous()
    rho = torch.as_tensor(rho0, **kw).expand(B).contiguous()
    ins = [bl(X_sched[:, :N]), bl(U_sched), bl(kappas), bl(x_ref_b), stack_params(p_b, B, dev),
           bl(lb), bl(ub), bl(x0a), bl(s0), bl(lam0), rho]
    X = torch.empty((N + 1, na, B), **kw)
    U = torch.empty((N, NU, B), **kw)
    s = torch.empty((N + 1, NC, B), **kw)
    lam = torch.empty((N + 1, NC, B), **kw)
    stats = torch.empty((8, B), **kw)
    ws_rows = core_workspace(N, cfg.model)
    ws = torch.empty((ws_rows, B), **kw)
    _cuda.launch(
        "arl_fused_solve", ins + [X, U, s, lam, stats, ws], core_floats(cfg, scfg),
        [B, N, scfg.max_iter, max(1, scfg.check_termination), int(scfg.early_exit),
         TIRES[cfg.tire], ws_rows, *launch_shape(N, cfg.model).ints(),
         MODELS[cfg.model]],
    )
    fused_mpc_solve.launches += 1
    _cuda.check_outputs("arl_fused_solve", X, U, s, lam, stats[:6])
    return _solution(scfg, rho, X, U, s, lam, stats)


fused_mpc_solve.launches = 0   # kernel launches (CPU calls never count)

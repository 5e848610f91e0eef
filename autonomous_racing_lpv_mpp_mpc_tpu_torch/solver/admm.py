"""Batched ADMM with OSQP semantics; x-update = Riccati affine sweep (the
JAX package's ``solver/admm.py``).

Problem (block form, from engine/assembly.py):

    min  sum_k stage_cost(x_k, u_k)
    s.t. x_{k+1} = A_k x_k + B_k u_k + c_k   (eliminated by Riccati)
         l_k <= Dx x_k + Du u_k <= u_k       (ADMM box splitting)

Batch dims lead every per-QP tensor (A (..., N, na, na), lb (..., N+1, nc),
x0 (..., na), rho (...)); the rows ``Dx`` (nc, na), ``Du`` (nc, nu) and the
per-row softness ``soft`` (nc,) are shared by the batch.

Two entry points, as in the JAX package:

- :func:`admm_solve`: a fixed iteration count in chunks of
  ``rho_interval`` (the batched path). With ``graphed=True`` and CUDA
  tensors one chunk (refactorization, ``rho_interval`` iterations, rho
  update) is captured once as a CUDA graph per shape and solver config and
  replayed for every chunk of every later solve of that shape (the
  planner's long-horizon solves, which would otherwise be thousands of
  small launches per iteration);
- :func:`admm_solve_single`: early exit, checking OSQP termination every
  ``check_termination`` iterations. With batch dims each QP stops on its
  own (a lane that is done keeps its iterate), the semantics of the JAX
  function under ``vmap``; the loop reads one any-flag per chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import SolverConfig
from .riccati import LQRCost, LQRDynamics, RiccatiFactors, lqr_linear_solve, riccati_factor

_RHO_MIN = 1e-4
_RHO_MAX = 1e3
_RHO_TOL = 5.0  # OSQP adaptive_rho_tolerance


class BoxQP(NamedTuple):
    """Block-structured MPC QP (all arrays on the augmented state)."""

    dyn: LQRDynamics
    cost: LQRCost
    Dx: torch.Tensor        # (nc, nx) constraint rows, state part
    Du: torch.Tensor        # (nc, nu) constraint rows, input part
    lb: torch.Tensor        # (..., N+1, nc)
    ub: torch.Tensor        # (..., N+1, nc)
    x0: torch.Tensor        # (..., nx)
    # per-row softness: +inf = hard box; finite beta = quadratic penalty
    # beta/2 * dist(row, [lb, ub])^2
    soft: torch.Tensor      # (nc,)


def hard_rows(nc: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(nc,) softness of all-hard box rows."""
    return torch.full((nc,), float("inf"), dtype=dtype, device=device)


class ADMMState(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    eps_prim: torch.Tensor
    eps_dual: torch.Tensor
    primal_infeasible: torch.Tensor


class ADMMSolution(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    converged: torch.Tensor
    # int32 done-at: the first iteration at which the OSQP termination check
    # held (checked every iteration here), else the iteration count
    iters: torch.Tensor
    rho: torch.Tensor       # adapted rho, for the next solve
    primal_infeasible: torch.Tensor


def _amax(t):
    return torch.amax(torch.abs(t), dim=(-2, -1))


def _col(rho, n):
    """rho (...) -> (..., 1, ..., 1) with n trailing singleton dims."""
    return rho.reshape(rho.shape + (1,) * n)


def _folded_cost(qp: BoxQP, rho, sigma) -> LQRCost:
    """Fold the constant-per-rho ADMM quadratic penalties into the cost."""
    nx, nu = qp.Dx.shape[1], qp.Du.shape[1]
    kw = dict(dtype=qp.Dx.dtype, device=qp.Dx.device)
    r3 = _col(rho, 3)
    Q = qp.cost.Q + sigma * torch.eye(nx, **kw) + r3 * (qp.Dx.T @ qp.Dx)
    R = qp.cost.R + sigma * torch.eye(nu, **kw) + r3 * (qp.Du.T @ qp.Du)
    M = qp.cost.M + r3 * (qp.Dx.T @ qp.Du)
    return LQRCost(Q=Q, q=qp.cost.q, R=R, r=qp.cost.r, M=M)


def _dual_norm(qp: BoxQP, y, N):
    """inf-norm of D' y in the z-space (y has N+1 stages, u_N absent)."""
    return torch.maximum(_amax(y @ qp.Dx), _amax(y[..., :N, :] @ qp.Du))


def _iterate(qp: BoxQP, fac: RiccatiFactors, cfg: SolverConfig, rho, st: ADMMState) -> ADMMState:
    N = qp.dyn.A.shape[-3]
    r2 = _col(rho, 2)
    v = st.s - st.lam / r2
    q_lin = qp.cost.q - r2 * (v @ qp.Dx) - cfg.sigma * st.X
    r_lin = qp.cost.r - r2 * (v[..., :N, :] @ qp.Du) - cfg.sigma * st.U
    X, U = lqr_linear_solve(fac, q_lin, r_lin, qp.x0)

    Uext = torch.cat([U, torch.zeros_like(U[..., :1, :])], dim=-2)
    w = X @ qp.Dx.T + Uext @ qp.Du.T
    w_rel = cfg.alpha * w + (1.0 - cfg.alpha) * st.s
    wl = w_rel + st.lam / r2
    clipped = torch.clamp(wl, qp.lb, qp.ub)
    # hard rows project; soft rows take the prox of beta/2 dist(., [l, u])^2
    beta = torch.clamp_max(qp.soft, 1e30)
    soft_s = (beta * clipped + r2 * wl) / (beta + r2)
    s_new = torch.where(torch.isinf(qp.soft), clipped, soft_s)
    lam_new = st.lam + r2 * (w_rel - s_new)

    r_prim = _amax(w - s_new)
    r_dual = rho * _dual_norm(qp, s_new - st.s, N)
    eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(_amax(w), _amax(s_new))
    eps_dual = cfg.eps_abs + cfg.eps_rel * _dual_norm(qp, lam_new, N)
    # settled dual with the primal stuck far above tolerance: the box set is
    # unreachable (the in-solver infeasibility heuristic)
    pinf = (r_dual <= eps_dual) & (r_prim > 1e2 * eps_prim)
    return ADMMState(X, U, s_new, lam_new, r_prim, r_dual, eps_prim, eps_dual, pinf)


def _init_state(qp: BoxQP, warm) -> ADMMState:
    batch = qp.x0.shape[:-1]
    N = qp.dyn.A.shape[-3]
    nx, nu, nc = qp.Dx.shape[1], qp.Du.shape[1], qp.Dx.shape[0]
    kw = dict(dtype=qp.dyn.A.dtype, device=qp.dyn.A.device)
    if warm is None:
        s = torch.zeros(batch + (N + 1, nc), **kw)
        lam = torch.zeros(batch + (N + 1, nc), **kw)
        X = torch.zeros(batch + (N + 1, nx), **kw)
        U = torch.zeros(batch + (N, nu), **kw)
    else:
        s, lam, X, U = warm
    s = torch.clamp(s, qp.lb, qp.ub)
    big = torch.full(batch, float("inf"), **kw)
    zero = torch.zeros(batch, **kw)
    return ADMMState(X, U, s, lam, big, big, zero, zero, torch.zeros(batch, dtype=torch.bool, device=kw["device"]))


def _new_rho(rho, st: ADMMState):
    """OSQP adaptive rho: scale by the sqrt of the scaled-residual ratio."""
    ratio = torch.sqrt(
        (st.r_prim / torch.clamp_min(st.eps_prim, 1e-12))
        / torch.clamp_min(st.r_dual / torch.clamp_min(st.eps_dual, 1e-12), 1e-12)
    )
    rho_new = torch.clamp(rho * ratio, _RHO_MIN, _RHO_MAX)
    adapt = (ratio > _RHO_TOL) | (ratio < 1.0 / _RHO_TOL)
    return torch.where(adapt, rho_new, rho)


def _converged(st: ADMMState):
    return (st.r_prim <= st.eps_prim) & (st.r_dual <= st.eps_dual)


def _chunk(qp: BoxQP, cfg: SolverConfig, interval: int, st: ADMMState, rho, it, done_at):
    """One rho chunk: refactorize at rho, ``interval`` iterations, adapt rho.
    ``it`` is the 0-d int32 count of iterations run so far and ``done_at``
    (int32, -1 until converged) the first iteration at which termination
    held; both stay on the device, so a chunk reads nothing back."""
    fac = riccati_factor(qp.dyn, _folded_cost(qp, rho, cfg.sigma), cfg.riccati)
    for _ in range(interval):
        st = _iterate(qp, fac, cfg, rho, st)
        it = it + 1
        done_at = torch.where((done_at < 0) & _converged(st), it, done_at)
    return st, _new_rho(rho, st), it, done_at


class _ChunkGraph:
    """A CUDA graph of :func:`_chunk` over static buffers. ``run`` copies a
    solve's QP and starting state into them, replays the graph once per
    chunk (the graph writes its outputs back over its inputs) and returns
    copies of the final state."""

    def __init__(self, qp: BoxQP, cfg: SolverConfig, interval: int, state):
        self.qp = _map_qp(torch.clone, qp)
        self.state = tuple(t.clone() for t in _flat_state(*state))
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):      # first calls: library handles, workspaces
            for _ in range(2):
                _chunk(self.qp, cfg, interval, *_unflat_state(self.state))
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = _chunk(self.qp, cfg, interval, *_unflat_state(self.state))
            for dst, src in zip(self.state, _flat_state(*out)):
                dst.copy_(src)

    def run(self, qp: BoxQP, state, n_chunks: int):
        for dst, src in zip(_flat_qp(self.qp), _flat_qp(qp)):
            dst.copy_(src)
        for dst, src in zip(self.state, _flat_state(*state)):
            dst.copy_(src)
        for _ in range(n_chunks):
            self.graph.replay()
        return _unflat_state(tuple(t.clone() for t in self.state))


_CHUNK_GRAPHS = {}   # (device, solver config, interval, shapes) -> _ChunkGraph


def _flat_qp(qp: BoxQP):
    return (*qp.dyn, *qp.cost, qp.Dx, qp.Du, qp.lb, qp.ub, qp.x0, qp.soft)


def _map_qp(fn, qp: BoxQP) -> BoxQP:
    return BoxQP(dyn=LQRDynamics(*(fn(t) for t in qp.dyn)), cost=LQRCost(*(fn(t) for t in qp.cost)),
                 Dx=fn(qp.Dx), Du=fn(qp.Du), lb=fn(qp.lb), ub=fn(qp.ub), x0=fn(qp.x0), soft=fn(qp.soft))


def _flat_state(st: ADMMState, rho, it, done_at):
    return (*st, rho, it, done_at)


def _unflat_state(flat):
    n = len(ADMMState._fields)
    return ADMMState(*flat[:n]), *flat[n:]


def admm_solve(
    qp: BoxQP,
    cfg: SolverConfig,
    warm: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    rho0: Optional[torch.Tensor] = None,
    graphed: bool = False,
) -> ADMMSolution:
    """Fixed-iteration batched ADMM.

    Runs chunks of ``rho_interval`` iterations (one chunk of ``max_iter``
    when it is 0), refactorizing at the start of each chunk and adapting
    rho at its end. With ``rho_interval=0`` and a carried ``rho0`` that is
    exactly one factorization per solve. ``graphed=True`` replays each chunk
    from a CUDA graph captured at the first solve of these shapes and this
    config (CUDA tensors only; CPU tensors run the same ops eagerly).
    """
    interval = cfg.rho_interval if cfg.rho_interval > 0 else cfg.max_iter
    n_chunks = max(1, -(-cfg.max_iter // interval))
    batch = qp.x0.shape[:-1]
    kw = dict(dtype=qp.dyn.A.dtype, device=qp.dyn.A.device)

    st = _init_state(qp, warm)
    if rho0 is None:
        rho = torch.full(batch, cfg.rho, **kw)
    else:
        rho = torch.as_tensor(rho0, **kw).expand(batch).clone()
    state = (st, rho, torch.zeros((), dtype=torch.int32, device=kw["device"]),
             torch.full(batch, -1, dtype=torch.int32, device=kw["device"]))

    if graphed and kw["device"].type == "cuda":
        key = (kw["device"], cfg, interval,
               tuple((tuple(t.shape), t.dtype) for t in _flat_qp(qp) + _flat_state(*state)))
        if key not in _CHUNK_GRAPHS:
            _CHUNK_GRAPHS[key] = _ChunkGraph(qp, cfg, interval, state)
        st, rho, it, done_at = _CHUNK_GRAPHS[key].run(qp, state, n_chunks)
    else:
        for _ in range(n_chunks):
            state = _chunk(qp, cfg, interval, *state)
        st, rho, it, done_at = state

    return ADMMSolution(
        X=st.X, U=st.U, s=st.s, lam=st.lam,
        r_prim=st.r_prim, r_dual=st.r_dual,
        converged=_converged(st),
        iters=torch.where(done_at > 0, done_at, it),
        rho=rho,
        primal_infeasible=st.primal_infeasible,
    )


def _lanes(mask, t):
    """``mask`` (batch) broadcast against a batch-first leaf ``t``."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def admm_solve_single(
    qp: BoxQP,
    cfg: SolverConfig,
    warm: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> ADMMSolution:
    """Early-exit ADMM: chunks of ``check_termination`` iterations at one
    factorization until OSQP termination holds or ``max_iter`` is reached;
    rho adapts on the chunk that crosses a ``rho_interval`` boundary.
    ``iters`` is the iteration count at exit (a multiple of the check
    cadence). Each QP of a batch stops on its own; the loop ends when every
    QP has, which costs one host read per chunk."""
    check = max(1, cfg.check_termination)
    interval = cfg.rho_interval if cfg.rho_interval > 0 else cfg.max_iter
    batch = qp.x0.shape[:-1]
    kw = dict(dtype=qp.dyn.A.dtype, device=qp.dyn.A.device)
    st = _init_state(qp, warm)
    rho = torch.full(batch, cfg.rho, **kw)
    it = torch.zeros(batch, dtype=torch.int32, device=kw["device"])
    while True:
        active = (it < cfg.max_iter) & ~_converged(st)
        if not bool(active.any()):
            break
        fac = riccati_factor(qp.dyn, _folded_cost(qp, rho, cfg.sigma), cfg.riccati)
        st_new = st
        for _ in range(check):
            st_new = _iterate(qp, fac, cfg, rho, st_new)
        it_new = it + check
        rho_new = torch.where((it_new % interval) < check, _new_rho(rho, st_new), rho)
        st = ADMMState(*(torch.where(_lanes(active, a), a, b) for a, b in zip(st_new, st)))
        it = torch.where(active, it_new, it)
        rho = torch.where(active, rho_new, rho)
    return ADMMSolution(
        X=st.X, U=st.U, s=st.s, lam=st.lam,
        r_prim=st.r_prim, r_dual=st.r_dual,
        converged=_converged(st), iters=it, rho=rho,
        primal_infeasible=st.primal_infeasible,
    )


def qp_objective(qp: BoxQP, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """0.5 z'Pz + q'z of the tracking cost per QP (diagnostics, oracle
    checks); (batch) from X (..., N+1, nx), U (..., N, nu)."""
    N = qp.dyn.A.shape[-3]
    c = qp.cost
    quad = lambda v, M: torch.einsum("...ki,...kij,...kj->...", v, M, v)
    lin = lambda v, w: torch.einsum("...ki,...ki->...", v, w)
    return (0.5 * quad(X, c.Q) + lin(c.q, X) + 0.5 * quad(U, c.R) + lin(c.r, U)
            + torch.einsum("...ki,...kij,...kj->...", X[..., :N, :], c.M, U))

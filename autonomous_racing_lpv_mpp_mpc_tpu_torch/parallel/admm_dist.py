"""Horizon-sharded ADMM (the JAX package's ``parallel/admm_dist.py``): every
rank of a process group (the mesh's ``horizon`` dim) does ~1/n_h of the
whole solve.

``riccati_dist.py`` shares out the O(N na^3) factorization; this module
shares out the per-iteration O(N na^2) affine sweeps and the stage-local
ADMM updates as well. The backward sweep is an affine recursion
v_k = G_k v_{k+1} + f_k whose matrix G_k = A_k' - Hux_k' Huu_inv_k B_k' is
constant over the iterations of one factorization, and the forward
rollout x_{k+1} = Phi_k x_k + e_k has Phi_k = A_k + B_k K_k; both are
"scan, then correct" across chunk boundaries:

- once per rho value: the local suffix products SufG_k = G_k ... G_{hi-1}
  and prefix products PrePhi_k = Phi_{k-1} ... Phi_lo, and the chunk
  products SufG_lo and PrePhi_hi, all-gathered once ((n_h, na, na) each);
- on each ADMM iteration: a local backward sweep from a zero boundary and
  an all-gather of its (na,) chunk offset (with the terminal linear cost),
  the correction d_k = d0_k + D_k vb_{j+1} with D_k = -Huu_inv_k B_k'
  SufG_{k+1}; a local forward rollout from zero and an all-gather of its
  chunk offset, the correction x_k = x0_k + PrePhi_k xb_j; the stage-local
  projection and dual update on the rank's own rows; and one pmax of the
  four residual inf-norms, so that every rank takes the same convergence
  and rho decisions.

The boundary values vb_{j+1} and xb_j are composed from the gathered chunk
maps in a loop over the group's ranks (n_h small maps each way); the JAX
package composes them with an associative scan, so the rounding differs.

Stage rows: rank j owns global stage rows [j Nc, (j + 1) Nc); its arrays
carry Nc + 1 rows, row Nc being the chunk boundary, active (the terminal
stage N) only on the last rank and neutral elsewhere (bounds +-inf, zero
cost), so nothing counts twice. Leading batch dims are kept: one solve per
lane, each with its own rho.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.config import SolverConfig
from ..solver.admm import BoxQP, _new_rho
from ..solver.riccati import LQRCost, LQRDynamics, RiccatiFactors, _mv, _t
from .collectives import all_gather, pmax_scalar
from .riccati_dist import riccati_factor_horizon_sharded


class ShardedBoxQP(NamedTuple):
    """A rank's chunk of a BoxQP (the row layout of the module docstring).

    dyn: local stages (..., Nc, na, na) / (..., Nc, na, nu) / (..., Nc, na);
    cost: local rows, Q and q (..., Nc+1, ...), row Nc used only on the
    last rank; lb/ub (..., Nc+1, nc) with the boundary row +-inf on the
    other ranks; x0 (..., na) the global initial state (replicated); Dx,
    Du, soft as in ``solver.admm.BoxQP``."""

    dyn: LQRDynamics
    cost: LQRCost
    Dx: torch.Tensor
    Du: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    x0: torch.Tensor
    soft: torch.Tensor


class _SweepPrecomp(NamedTuple):
    fac: RiccatiFactors      # local-chunk factors
    PrePhi: torch.Tensor     # (..., Nc+1, na, na)  PrePhi[0] = I
    Phi: torch.Tensor        # (..., Nc, na, na)
    D: torch.Tensor          # (..., Nc, nu, na)    d-correction vs the boundary v
    Gprods: torch.Tensor     # (..., n_h, na, na)   gathered chunk products
    Phiprods: torch.Tensor   # (..., n_h, na, na)


class ShardedADMMSolution(NamedTuple):
    X: torch.Tensor          # (..., Nc+1, na) local rows
    U: torch.Tensor          # (..., Nc, nu)
    s: torch.Tensor          # (..., Nc+1, nc)
    lam: torch.Tensor        # (..., Nc+1, nc)
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    converged: torch.Tensor
    rho: torch.Tensor


class _Residuals(NamedTuple):
    """The group-wide residuals that rho adapts on (``solver.admm._new_rho``)."""

    r_prim: torch.Tensor
    r_dual: torch.Tensor
    eps_prim: torch.Tensor
    eps_dual: torch.Tensor


def _fold_cost(qp: ShardedBoxQP, rho, sigma) -> LQRCost:
    kw = dict(dtype=qp.Dx.dtype, device=qp.Dx.device)
    r3 = rho[..., None, None, None]
    Q = qp.cost.Q + sigma * torch.eye(qp.Dx.shape[1], **kw) + r3 * (qp.Dx.T @ qp.Dx)
    R = qp.cost.R + sigma * torch.eye(qp.Du.shape[1], **kw) + r3 * (qp.Du.T @ qp.Du)
    M = qp.cost.M + r3 * (qp.Dx.T @ qp.Du)
    return LQRCost(Q=Q, q=qp.cost.q, R=R, r=qp.cost.r, M=M)


def _precompute(qp: ShardedBoxQP, folded: LQRCost, group) -> _SweepPrecomp:
    """Factorize the chunk (distributed) and build the sweeps' constant
    maps: O(Nc na^3) local work and two (na, na) all-gathers."""
    fac = riccati_factor_horizon_sharded(qp.dyn, folded, group)
    A, B = qp.dyn.A, qp.dyn.B
    Nc = A.shape[-3]
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape[:-3] + A.shape[-2:])
    HivB = fac.Huu_inv @ _t(B)                               # (..., Nc, nu, na)
    G = _t(A) - _t(fac.Hux) @ HivB
    suf = [I]
    for k in range(Nc - 1, -1, -1):
        suf.append(G[..., k, :, :] @ suf[-1])
    SufG = torch.stack(suf[::-1], dim=-3)                    # (..., Nc+1, na, na), SufG[Nc] = I
    Phi = A + B @ fac.K
    pre = [I]
    for k in range(Nc):
        pre.append(Phi[..., k, :, :] @ pre[-1])
    PrePhi = torch.stack(pre, dim=-3)                        # (..., Nc+1, na, na), PrePhi[0] = I
    D = -(HivB @ SufG[..., 1:, :, :])
    return _SweepPrecomp(fac, PrePhi, Phi, D, all_gather(SufG[..., 0, :, :], group, axis=-3),
                         all_gather(PrePhi[..., -1, :, :], group, axis=-3))


def _backward_d(pre: _SweepPrecomp, q_lin, r_lin, group):
    """The distributed affine backward sweep: d (..., Nc, nu) from q_lin
    (..., Nc+1, na) (the terminal row live only on the last rank) and r_lin
    (..., Nc, nu)."""
    fac = pre.fac
    nh, idx = dist.get_world_size(group), dist.get_rank(group)
    Nc = r_lin.shape[-2]
    v = torch.zeros_like(q_lin[..., 0, :])
    d0 = [None] * Nc
    for k in range(Nc - 1, -1, -1):
        w = fac.Vc[..., k, :] + v
        h_u = r_lin[..., k, :] + _mv(_t(fac.B[..., k, :, :]), w)
        d0[k] = -_mv(fac.Huu_inv[..., k, :, :], h_u)
        v = q_lin[..., k, :] + _mv(_t(fac.A[..., k, :, :]), w) + _mv(_t(fac.Hux[..., k, :, :]), d0[k])
    # each chunk's offset (v at its first row from a zero boundary) and the
    # terminal linear cost, which only the last rank holds
    qN = q_lin[..., -1, :] if idx == nh - 1 else torch.zeros_like(v)
    gathered = all_gather(torch.stack([v, qN], dim=-2), group, axis=-3)   # (..., nh, 2, na)
    # vb_j = Gprod_j vb_{j+1} + f_j from vb_nh = q_N, down to this rank's vb_{idx+1}
    vb = gathered[..., 1, :].sum(dim=-2)
    for j in range(nh - 1, idx, -1):
        vb = _mv(pre.Gprods[..., j, :, :], vb) + gathered[..., j, 0, :]
    return torch.stack(d0, dim=-2) + _mv(pre.D, vb.unsqueeze(-2))


def _forward_xu(pre: _SweepPrecomp, x0, d, group):
    """The distributed affine forward rollout: (X (..., Nc+1, na), U (...,
    Nc, nu)) for the rank's rows (row Nc repeats the next rank's row 0)."""
    fac = pre.fac
    idx = dist.get_rank(group)
    Nc = d.shape[-2]
    e = _mv(fac.B, d) + fac.c
    x = torch.zeros_like(x0)
    xs = [x]
    for k in range(Nc):
        x = _mv(pre.Phi[..., k, :, :], x) + e[..., k, :]
        xs.append(x)
    e_aggs = all_gather(x, group, axis=-2)                    # (..., nh, na)
    # xb_{j+1} = Phiprod_j xb_j + e_j from xb_0 = x0, up to this rank's xb_idx
    xb = x0
    for j in range(idx):
        xb = _mv(pre.Phiprods[..., j, :, :], xb) + e_aggs[..., j, :]
    X = torch.stack(xs, dim=-2) + _mv(pre.PrePhi, xb.unsqueeze(-2))
    return X, _mv(fac.K, X[..., :Nc, :]) + d


def _amax(t):
    return torch.amax(torch.abs(t), dim=(-2, -1))


def admm_solve_horizon_sharded(qp: ShardedBoxQP, cfg: SolverConfig,
                               group: Optional[dist.ProcessGroup] = None,
                               warm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                               rho0=None) -> ShardedADMMSolution:
    """Fixed-iteration ADMM with every per-stage piece sharded over the
    group (the semantics of ``solver.admm.admm_solve`` on the assembled
    QP): chunks of ``rho_interval`` iterations, each refactorized at its
    rho, rho adapted at its end from the group-wide residuals. ``warm`` is
    the local (s, lam)."""
    Nc = qp.dyn.A.shape[-3]
    na, nu, nc = qp.Dx.shape[1], qp.Du.shape[1], qp.Dx.shape[0]
    batch = qp.x0.shape[:-1]
    kw = dict(dtype=qp.dyn.A.dtype, device=qp.dyn.A.device)
    interval = cfg.rho_interval if cfg.rho_interval > 0 else cfg.max_iter
    n_chunks = max(1, -(-cfg.max_iter // interval))
    nh, idx = dist.get_world_size(group), dist.get_rank(group)
    # row ownership: the boundary row Nc belongs to the next rank, except on
    # the last one (the terminal row); keeps duplicate rows out of the norms
    own = torch.ones((Nc + 1, 1), **kw)
    own[Nc] = 1.0 if idx == nh - 1 else 0.0

    if warm is None:
        s = torch.clamp(torch.zeros(batch + (Nc + 1, nc), **kw), qp.lb, qp.ub)
        lam = torch.zeros(batch + (Nc + 1, nc), **kw)
    else:
        s, lam = torch.clamp(warm[0], qp.lb, qp.ub), warm[1]
    X = torch.zeros(batch + (Nc + 1, na), **kw)
    U = torch.zeros(batch + (Nc, nu), **kw)
    rho = torch.as_tensor(cfg.rho if rho0 is None else rho0, **kw).expand(batch).clone()
    beta = torch.clamp_max(qp.soft, 1e30)
    hard = torch.isinf(qp.soft)
    glob = None

    for _ in range(n_chunks):
        pre = _precompute(qp, _fold_cost(qp, rho, cfg.sigma), group)
        r2 = rho[..., None, None]
        for _ in range(interval):
            v = s - lam / r2
            q_lin = qp.cost.q - r2 * (v @ qp.Dx) - cfg.sigma * X
            r_lin = qp.cost.r - r2 * (v[..., :Nc, :] @ qp.Du) - cfg.sigma * U
            d = _backward_d(pre, q_lin, r_lin, group)
            X, U = _forward_xu(pre, qp.x0, d, group)
            Uext = torch.cat([U, torch.zeros_like(U[..., :1, :])], dim=-2)
            w = X @ qp.Dx.T + Uext @ qp.Du.T
            w_rel = cfg.alpha * w + (1.0 - cfg.alpha) * s
            wl = w_rel + lam / r2
            clipped = torch.clamp(wl, qp.lb, qp.ub)
            s_new = torch.where(hard, clipped, (beta * clipped + r2 * wl) / (beta + r2))
            lam = lam + r2 * (w_rel - s_new)
            ds, lam_own = (s_new - s) * own, lam * own
            s = s_new
            # the local inf-norms over owned rows, then their max over the group
            loc = torch.stack([
                _amax((w - s) * own),
                torch.maximum(_amax(ds @ qp.Dx), _amax(ds[..., :Nc, :] @ qp.Du)),
                torch.maximum(_amax(w * own), _amax(s * own)),
                torch.maximum(_amax(lam_own @ qp.Dx), _amax(lam_own[..., :Nc, :] @ qp.Du)),
            ], dim=-1)
            glob = pmax_scalar(loc, group)
        r_prim, r_dual = glob[..., 0], rho * glob[..., 1]
        eps_prim = cfg.eps_abs + cfg.eps_rel * glob[..., 2]
        eps_dual = cfg.eps_abs + cfg.eps_rel * glob[..., 3]
        rho = _new_rho(rho, _Residuals(r_prim, r_dual, eps_prim, eps_dual))
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    return ShardedADMMSolution(X, U, s, lam, r_prim, r_dual, converged, rho)


def shard_boxqp(qp: BoxQP, group: Optional[dist.ProcessGroup], n_h: int) -> ShardedBoxQP:
    """Cut a full BoxQP (leading batch dims allowed) into this rank's
    :class:`ShardedBoxQP` chunk, the boundary row neutral on every rank but
    the last. For tests and callers that assemble the whole QP; the
    production path assembles chunk by chunk (``horizon.py``)."""
    idx = dist.get_rank(group)
    N = qp.dyn.A.shape[-3]
    if N % n_h:
        raise ValueError(f"N={N} does not split over {n_h} horizon ranks")
    Nc = N // n_h
    lo = idx * Nc
    st = lambda a, n: a[..., lo:lo + n, :]           # stage rows of (..., N, k)
    sm = lambda a, n: a[..., lo:lo + n, :, :]        # stage rows of (..., N, k, l)
    lb, ub, q, Q = st(qp.lb, Nc + 1).clone(), st(qp.ub, Nc + 1).clone(), st(qp.cost.q, Nc + 1).clone(), \
        sm(qp.cost.Q, Nc + 1).clone()
    if idx != n_h - 1:
        lb[..., Nc, :] = -float("inf")
        ub[..., Nc, :] = float("inf")
        q[..., Nc, :] = 0.0
        Q[..., Nc, :, :] = 0.0
    return ShardedBoxQP(
        dyn=LQRDynamics(sm(qp.dyn.A, Nc), sm(qp.dyn.B, Nc), st(qp.dyn.c, Nc)),
        cost=LQRCost(Q, q, sm(qp.cost.R, Nc), st(qp.cost.r, Nc), sm(qp.cost.M, Nc)),
        Dx=qp.Dx, Du=qp.Du, lb=lb, ub=ub, x0=qp.x0, soft=qp.soft)

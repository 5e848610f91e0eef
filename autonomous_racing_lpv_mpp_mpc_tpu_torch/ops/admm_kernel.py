"""Solver-only kernel: one Riccati factorization plus ``max_iter`` ADMM
iterations per QP (kernel 1; CUDA source ``csrc/admm_kernel.cu``).

Replaces the JAX package's ``ops/admm_kernel.py::_admm_kernel`` (Pallas,
launched by ``pallas_admm_solve``). Semantics are those of
``solver.admm.admm_solve`` at ``rho_interval=0`` with a zero primal warm
start: factor once, iterate ``max_iter`` times, adapt rho once on the way
out. :func:`admm_solve_plain` is that plain version; the wrapper
:func:`admm_kernel_solve` takes it for CPU tensors and launches the kernel
for CUDA tensors.

The kernel takes the 8-state augmented tracker QP (na=8, nu=2, nc=6),
batch-last; the wrapper moves the batch axis and back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import SolverConfig
from ..solver.admm import ADMMSolution, ADMMState, BoxQP, _folded_cost, _new_rho, admm_solve
from . import _cuda

KERNEL_DIMS = (8, 2, 6)   # (na, nu, nc) the CUDA kernel is compiled for
WS_PER_STAGE = 16 + 4 + 16 + 8 + 2   # K, Huu_inv, Hux, Vc, d floats per lane


def _warm_start(qp: BoxQP, cfg: SolverConfig, warm, rho0):
    batch = qp.x0.shape[:-1]
    N, nc = qp.dyn.A.shape[-3], qp.Dx.shape[0]
    kw = dict(dtype=torch.float32, device=qp.x0.device)
    rho = (torch.full(batch, cfg.rho, **kw) if rho0 is None
           else torch.as_tensor(rho0, **kw).expand(batch).contiguous())
    if warm is None:
        s0 = torch.zeros(batch + (N + 1, nc), **kw)
        lam0 = torch.zeros(batch + (N + 1, nc), **kw)
    else:
        s0, lam0 = warm[0], warm[1]
    return torch.clamp(s0, qp.lb, qp.ub), lam0, rho


def admm_solve_plain(qp: BoxQP, cfg: SolverConfig, warm=None, rho0=None) -> ADMMSolution:
    """Plain PyTorch version of the kernel: ``admm_solve`` with one
    factorization and only the (s, lam) part of the warm start."""
    s0, lam0, rho = _warm_start(qp, cfg, warm, rho0)
    X0 = torch.zeros(qp.x0.shape[:-1] + (qp.dyn.A.shape[-3] + 1, qp.Dx.shape[1]),
                     dtype=torch.float32, device=qp.x0.device)
    U0 = torch.zeros(qp.dyn.B.shape[:-2] + (qp.Du.shape[1],), dtype=torch.float32, device=qp.x0.device)
    return admm_solve(qp, dataclasses.replace(cfg, rho_interval=0),
                      warm=(s0, lam0, X0, U0), rho0=rho)


def admm_kernel_solve(qp: BoxQP, cfg: SolverConfig, warm=None, rho0=None) -> ADMMSolution:
    """Batched solve: plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error). ``qp`` leaves lead with the batch B."""
    dev = qp.x0.device
    if dev.type == "cpu":
        return admm_solve_plain(qp, cfg, warm, rho0)
    if dev.type != "cuda":
        raise ValueError(f"admm_kernel_solve: tensors on {dev}; expected cpu or cuda")
    return _admm_cuda(qp, cfg, warm, rho0)


def _admm_cuda(qp: BoxQP, cfg: SolverConfig, warm, rho0) -> ADMMSolution:
    """Launch the kernel on the QPs' device (batch-last operands)."""
    if qp.x0.dim() != 2:
        raise ValueError("admm_kernel_solve: qp must have exactly one leading batch dim")
    na, nu, nc = qp.Dx.shape[1], qp.Du.shape[1], qp.Dx.shape[0]
    if (na, nu, nc) != KERNEL_DIMS:
        raise ValueError(f"admm_kernel_solve: kernel built for (na, nu, nc)={KERNEL_DIMS}, "
                         f"got {(na, nu, nc)}")
    if cfg.max_iter < 1:
        raise ValueError("admm_kernel_solve: max_iter must be >= 1")
    dev = qp.x0.device
    B, N = qp.x0.shape[0], qp.dyn.A.shape[1]
    s0, lam0, rho = _warm_start(qp, cfg, warm, rho0)
    cost_f = _folded_cost(qp, rho, cfg.sigma)
    bl = lambda t: t.to(torch.float32).movedim(0, -1).contiguous()
    ins = [bl(t) for t in (qp.dyn.A, qp.dyn.B, qp.dyn.c, cost_f.Q, qp.cost.q, cost_f.R,
                           qp.cost.r, cost_f.M, qp.lb, qp.ub, qp.x0, s0, lam0)]
    ins.append(rho.reshape(1, B).contiguous())
    kw = dict(dtype=torch.float32, device=dev)
    X = torch.empty((N + 1, na, B), **kw)
    U = torch.empty((N, nu, B), **kw)
    s = torch.empty((N + 1, nc, B), **kw)
    lam = torch.empty((N + 1, nc, B), **kw)
    stats = torch.empty((8, B), **kw)
    ws = torch.empty((N * WS_PER_STAGE, B), **kw)
    consts = torch.cat([qp.Dx.reshape(-1), qp.Du.reshape(-1), qp.soft.reshape(-1)]).tolist()
    _cuda.launch(
        "arl_admm_solve", ins + [X, U, s, lam, stats, ws],
        [cfg.sigma, cfg.alpha, cfg.eps_abs, cfg.eps_rel] + consts,
        [B, N, cfg.max_iter, N * WS_PER_STAGE],
    )
    admm_kernel_solve.launches += 1

    fb = lambda t: t.movedim(-1, 0)
    X, U, s, lam = fb(X), fb(U), fb(s), fb(lam)
    r_prim, r_dual = stats[0], stats[1]
    eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(stats[2], stats[3])
    eps_dual = cfg.eps_abs + cfg.eps_rel * stats[4]
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    no = torch.zeros((B,), dtype=torch.bool, device=dev)
    st = ADMMState(X, U, s, lam, r_prim, r_dual, eps_prim, eps_dual, no)
    return ADMMSolution(
        X=X, U=U, s=s, lam=lam, r_prim=r_prim, r_dual=r_dual, converged=converged,
        iters=stats[5].to(torch.int32), rho=_new_rho(rho, st), primal_infeasible=no,
    )


admm_kernel_solve.launches = 0   # kernel launches (CPU calls never count)

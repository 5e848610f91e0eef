"""Solver-only kernel: one Riccati factorization plus ``max_iter`` ADMM
iterations per QP (kernel 1; CUDA source ``csrc/admm_kernel.cu``).

Replaces the JAX package's ``ops/admm_kernel.py::_admm_kernel`` (Pallas,
launched by ``pallas_admm_solve``). Semantics are those of
``solver.admm.admm_solve`` at ``rho_interval=0`` with a zero primal warm
start: factor once, iterate ``max_iter`` times, adapt rho once on the way
out. :func:`admm_solve_plain` is that plain version; the wrapper
:func:`admm_kernel_solve` takes it for CPU tensors and launches the kernel
for CUDA tensors.

The kernel takes the augmented tracker QPs of both models (na = 8
dynamic, 6 kinematic; nu = 2, nc = 6), batch-last; the wrapper moves the
batch axis and back. On the card a QP is a group of ``THREADS_PER_LANE``
threads; :func:`admm_launch_shape` gives the QPs per block and where the
per-iteration operands live.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.config import SolverConfig
from ..solver.admm import ADMMSolution, ADMMState, BoxQP, _folded_cost, _new_rho, admm_solve
from . import _cuda
from .fused_kernel import BLOCK_SMEM, LANES_PER_BLOCK, STATIC_SMEM

KERNEL_NA = (8, 6)   # state widths the CUDA kernel is instantiated for
KERNEL_NU, KERNEL_NC = 2, 6


def check_widths(na: int, nu: int, nc: int) -> None:
    """Raise unless the kernel takes QPs of these widths: (na, nu, nc) =
    (8, 2, 6), the dynamic tracker QP, or (6, 2, 6), the kinematic one."""
    if na not in KERNEL_NA or (nu, nc) != (KERNEL_NU, KERNEL_NC):
        raise ValueError(f"admm_kernel_solve: the kernel takes (na, nu, nc) in "
                         f"{[(n, KERNEL_NU, KERNEL_NC) for n in KERNEL_NA]}, got {(na, nu, nc)}")


def admm_ops_floats(N: int, na: int) -> int:
    """Per-QP float32 operands of ``csrc/admm_kernel.cu``'s ``AdmmLayout``:
    A, B, c, r, Hux, Hiv, Vc, d, rt, U of every stage and q, qt, X of every
    stage and the terminal one."""
    nu = KERNEL_NU
    return N * (na * na + 2 * na * nu + 2 * na + nu * nu + 4 * nu) + 3 * (N + 1) * na


class AdmmShape(NamedTuple):
    """Launch shape of the solver-only kernel: ``lanes`` QPs per block of
    ``lanes * THREADS_PER_LANE`` threads, no cluster; the per-iteration
    operands in ``smem_bytes`` of dynamic shared memory per block, or in the
    device-memory workspace when ``ops_in_smem`` is False."""

    lanes: int
    smem_bytes: int
    ops_in_smem: bool

    def ints(self) -> list:
        """The shape's ints of the kernel's C entry."""
        return [self.lanes, int(self.ops_in_smem), self.smem_bytes]


def admm_launch_shape(N: int, na: int) -> AdmmShape:
    """The most QPs per block, up to ``LANES_PER_BLOCK``, whose operand
    slices fit in the shared memory a block may hold; if not even one fits,
    ``LANES_PER_BLOCK`` QPs per block with the operands in device memory
    (chosen from N and na alone)."""
    per_qp = admm_ops_floats(N, na) * 4
    lanes = LANES_PER_BLOCK
    while lanes >= 1:
        if lanes * per_qp <= BLOCK_SMEM - STATIC_SMEM:
            return AdmmShape(lanes, lanes * per_qp, True)
        lanes //= 2
    return AdmmShape(LANES_PER_BLOCK, 0, False)


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
    if qp.Dx.dim() != 2 or qp.Du.dim() != 2 or qp.soft.dim() != 1:
        raise ValueError("admm_kernel_solve: Dx, Du and soft must be shared by the batch")
    na, nu, nc = qp.Dx.shape[1], qp.Du.shape[1], qp.Dx.shape[0]
    check_widths(na, nu, nc)
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
    # the selector rows stay on the device: the kernel reads them itself
    ins += [t.to(torch.float32).contiguous() for t in (qp.Dx, qp.Du, qp.soft)]
    kw = dict(dtype=torch.float32, device=dev)
    X = torch.empty((N + 1, na, B), **kw)
    U = torch.empty((N, nu, B), **kw)
    s = torch.empty((N + 1, nc, B), **kw)
    lam = torch.empty((N + 1, nc, B), **kw)
    stats = torch.empty((8, B), **kw)
    shape = admm_launch_shape(N, na)
    ws_rows = 0 if shape.ops_in_smem else admm_ops_floats(N, na)
    ws = torch.empty((max(ws_rows, 1), B), **kw)
    _cuda.launch(
        "arl_admm_solve", ins + [X, U, s, lam, stats, ws],
        [cfg.sigma, cfg.alpha, cfg.eps_abs, cfg.eps_rel],
        [B, N, cfg.max_iter, ws_rows, *shape.ints(), na],
    )
    admm_kernel_solve.launches += 1
    _cuda.check_outputs("arl_admm_solve", X, U, s, lam, stats[:6])

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

"""Block-structured BoxQP -> dense stacked (P, q, A, l, u) for the oracle.

The port's copy of the JAX package's ``oracle/stack.py``: the cost
blkdiag, the dynamics equality rows [-I, A_k, B_k] and the box rows, in
dense float64 numpy, so the oracle solves the *same* QP the solvers under
test see. Decision ordering: z = [x_1..x_N, u_0..u_{N-1}]. As in the JAX
oracle, every box row is stacked hard (``BoxQP.soft`` is not read).

The input is one unbatched port :class:`BoxQP` (torch tensors on any
device), taken to the host in float64. It shares no code with
``solver/polish.py::stack_boxqp``, the float32 batched stacker that the
polish runs: that one is under test, this one is the reference.
"""

from __future__ import annotations

import numpy as np

from ..solver.admm import BoxQP
from ..solver.riccati import LQRCost, LQRDynamics


def _f64(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def boxqp_lane(qp: BoxQP, b: int) -> BoxQP:
    """Lane ``b`` of a batched, batch-first BoxQP (the one
    ``loop.mpc_prepare`` assembles): its stage arrays, bounds and x0; the
    constraint rows and softness as they are when the batch shares them."""
    lane = lambda t, unbatched: t[b] if t.dim() > unbatched else t
    return BoxQP(dyn=LQRDynamics(*(t[b] for t in qp.dyn)), cost=LQRCost(*(t[b] for t in qp.cost)),
                 Dx=lane(qp.Dx, 2), Du=lane(qp.Du, 2), lb=qp.lb[b], ub=qp.ub[b], x0=qp.x0[b],
                 soft=lane(qp.soft, 1))


def stack_boxqp(qp: BoxQP):
    A_ = _f64(qp.dyn.A)
    B_ = _f64(qp.dyn.B)
    c_ = _f64(qp.dyn.c)
    Q_ = _f64(qp.cost.Q)
    q_ = _f64(qp.cost.q)
    R_ = _f64(qp.cost.R)
    r_ = _f64(qp.cost.r)
    M_ = _f64(qp.cost.M)
    Dx = _f64(qp.Dx)
    Du = _f64(qp.Du)
    lb = _f64(qp.lb)
    ub = _f64(qp.ub)
    x0 = _f64(qp.x0)

    N, nx, nu = B_.shape
    nc = Dx.shape[0]
    nz = N * nx + N * nu

    def xi(k):  # columns of x_k, k in 1..N
        return slice((k - 1) * nx, k * nx)

    def ui(k):  # columns of u_k, k in 0..N-1
        return slice(N * nx + k * nu, N * nx + (k + 1) * nu)

    P = np.zeros((nz, nz))
    q = np.zeros(nz)
    for k in range(1, N + 1):
        P[xi(k), xi(k)] = Q_[k]
        q[xi(k)] = q_[k]
    for k in range(N):
        P[ui(k), ui(k)] = R_[k]
        q[ui(k)] = r_[k]
    for k in range(1, N):
        P[xi(k), ui(k)] = M_[k]
        P[ui(k), xi(k)] = M_[k].T
    q[ui(0)] += M_[0].T @ x0

    # equality rows: x_{k+1} - A_k x_k - B_k u_k = c_k (+ A_0 x0 for k=0)
    Aeq = np.zeros((N * nx, nz))
    beq = np.zeros(N * nx)
    for k in range(N):
        rows = slice(k * nx, (k + 1) * nx)
        Aeq[rows, xi(k + 1)] = np.eye(nx)
        Aeq[rows, ui(k)] = -B_[k]
        beq[rows] = c_[k]
        if k == 0:
            beq[rows] += A_[0] @ x0
        else:
            Aeq[rows, xi(k)] = -A_[k]

    # box rows: stage k pairs (x_k, u_k); k=0 uses fixed x0; k=N has no u
    Ain = np.zeros(((N + 1) * nc, nz))
    lin = np.zeros((N + 1) * nc)
    uin = np.zeros((N + 1) * nc)
    for k in range(N + 1):
        rows = slice(k * nc, (k + 1) * nc)
        if k == 0:
            Ain[rows, ui(0)] = Du
            lin[rows] = lb[0] - Dx @ x0
            uin[rows] = ub[0] - Dx @ x0
        elif k < N:
            Ain[rows, xi(k)] = Dx
            Ain[rows, ui(k)] = Du
            lin[rows] = lb[k]
            uin[rows] = ub[k]
        else:
            Ain[rows, xi(N)] = Dx
            lin[rows] = lb[N]
            uin[rows] = ub[N]

    Acon = np.vstack([Aeq, Ain])
    l = np.concatenate([beq, lin])
    u = np.concatenate([beq, uin])
    return P, q, Acon, l, u


def unstack_solution(qp: BoxQP, z: np.ndarray):
    """Oracle z -> (X (N+1,nx) with X[0]=x0, U (N,nu))."""
    N, nx, nu = qp.dyn.B.shape
    X = np.concatenate([_f64(qp.x0)[None], z[: N * nx].reshape(N, nx)], axis=0)
    U = z[N * nx:].reshape(N, nu)
    return X, U

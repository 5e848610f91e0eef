"""Riccati / LQR factorization of the equality-constrained QP core (the JAX
package's ``solver/riccati.py``, sequential form).

    min  sum_k [ 1/2 x'Q x + q'x + 1/2 u'R u + r'u + x'M u ] + terminal
    s.t. x_{k+1} = A_k x_k + B_k u_k + c_k,   x_0 given.

The quadratic factor (gains, Schur complements) is computed once; the
affine sweep reuses it every ADMM iteration. Leading batch dims are kept:
A (..., N, nx, nx), q (..., N+1, nx), x0 (..., nx).

Two factorizations: :func:`riccati_factor_scan` loops over the horizon in
Python (JAX: ``lax.scan``); :func:`riccati_factor_assoc` composes the
stages' value-function maps in a reverse log-depth scan written out as
batched tensor ops (JAX: ``lax.associative_scan``), ``ceil(log2(N+1))``
rounds of one batched combine each, for the planner's long horizons.

Small inverses and solves go through ``torch.linalg.inv_ex`` /
``solve_ex``: the checked forms read an ``info`` tensor back to the host,
and that wait would break CUDA-graph capture of a solve
(``solver.admm.admm_solve(graphed=True)``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRDynamics(NamedTuple):
    A: torch.Tensor   # (..., N, nx, nx)
    B: torch.Tensor   # (..., N, nx, nu)
    c: torch.Tensor   # (..., N, nx)


class LQRCost(NamedTuple):
    Q: torch.Tensor   # (..., N+1, nx, nx)  index N = terminal
    q: torch.Tensor   # (..., N+1, nx)
    R: torch.Tensor   # (..., N, nu, nu)
    r: torch.Tensor   # (..., N, nu)
    M: torch.Tensor   # (..., N, nx, nu) cross term x'Mu


class RiccatiFactors(NamedTuple):
    K: torch.Tensor        # (..., N, nu, nx)
    Huu_inv: torch.Tensor  # (..., N, nu, nu)
    Hux: torch.Tensor      # (..., N, nu, nx)
    Vc: torch.Tensor       # (..., N, nx) == V_{k+1} c_k
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    # the affine sweep's closed-loop maps, folded once per factorization
    Acl: torch.Tensor      # (..., N, nx, nx) == A + B K
    HB: torch.Tensor       # (..., N, nu, nx) == Huu_inv B'


def _factors(K, Huu_inv, Hux, Vc, dyn: LQRDynamics) -> RiccatiFactors:
    return RiccatiFactors(K, Huu_inv, Hux, Vc, dyn.A, dyn.B, dyn.c,
                          Acl=dyn.A + dyn.B @ K, HB=Huu_inv @ _t(dyn.B))


def _t(X):
    return X.transpose(-1, -2)


def _sym(X):
    return 0.5 * (X + _t(X))


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def riccati_factor_scan(dyn: LQRDynamics, cost: LQRCost) -> RiccatiFactors:
    """Sequential backward Riccati factorization."""
    N = dyn.A.shape[-3]
    V = cost.Q[..., N, :, :]
    K, Hiv, Hux, Vc = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A, B, c = dyn.A[..., k, :, :], dyn.B[..., k, :, :], dyn.c[..., k, :]
        Q, R, M = cost.Q[..., k, :, :], cost.R[..., k, :, :], cost.M[..., k, :, :]
        VB = V @ B
        Huu = R + _t(B) @ VB
        Hux_k = _t(M) + _t(B) @ V @ A
        Huu_inv = torch.linalg.inv_ex(_sym(Huu))[0]
        K_k = -Huu_inv @ Hux_k
        K[k], Hiv[k], Hux[k], Vc[k] = K_k, Huu_inv, Hux_k, _mv(V, c)
        V = _sym(Q + _t(A) @ V @ A + _t(Hux_k) @ K_k)
    return _factors(torch.stack(K, dim=-3), torch.stack(Hiv, dim=-3), torch.stack(Hux, dim=-3),
                    torch.stack(Vc, dim=-2), dyn)


def _reverse_scan(combine, elems):
    """Inclusive reverse scan over axis -3 of the stacked elements: out[k] =
    e_k o e_{k+1} o ... o e_last, where ``combine(later, earlier)`` takes
    the later-in-time aggregate first (JAX ``associative_scan`` under
    ``reverse=True``). Hillis-Steele doubling: after the round with offset
    d, out[k] covers stages k .. k+2d-1, so ceil(log2(n)) rounds of one
    batched combine each; the tree differs from XLA's, so the rounding
    does too."""
    n = elems[0].shape[-3]
    d = 1
    while d < n:
        later = tuple(e[..., d:, :, :] for e in elems)
        earlier = tuple(e[..., : n - d, :, :] for e in elems)
        head = combine(later, earlier)
        elems = tuple(torch.cat([h, e[..., n - d:, :, :]], dim=-3) for h, e in zip(head, elems))
        d *= 2
    return elems


def riccati_factor_assoc(dyn: LQRDynamics, cost: LQRCost) -> RiccatiFactors:
    """Parallel-in-horizon factorization (parallel dynamic programming,
    Sarkka & Garcia-Fernandez): each stage is the map

        P -> J + A'(P^{-1} + C)^{-1} A

    on the value Hessian, stored as its (A, C, J); the reverse scan of
    their compositions gives every suffix value Hessian V_{k+1} at once.
    The cross terms M are removed first by completing the square
    (u = w - R^{-1} M' x); the gains are then formed stage by stage, as in
    the JAX package."""
    nx = dyn.A.shape[-1]
    kw = dict(dtype=dyn.A.dtype, device=dyn.A.device)
    Rinv = torch.linalg.inv_ex(_sym(cost.R))[0]
    MRinv = cost.M @ Rinv
    F = dyn.A - dyn.B @ Rinv @ _t(cost.M)
    Xq = _sym(cost.Q[..., :-1, :, :] - MRinv @ _t(cost.M))
    C = dyn.B @ Rinv @ _t(dyn.B)
    zero = torch.zeros_like(F[..., :1, :, :])
    elems = (torch.cat([F, zero], dim=-3), torch.cat([C, zero], dim=-3),
             torch.cat([Xq, cost.Q[..., -1:, :, :]], dim=-3))
    I = torch.eye(nx, **kw)

    def combine(e_later, e_earlier):
        Ai, Ci, Ji = e_earlier
        Aj, Cj, Jj = e_later
        # (I + Ci Jj)^{-1} [Ai, Ci] in one solve, (I + Jj Ci)^{-1} Jj
        M1C = torch.linalg.solve_ex(I + Ci @ Jj, torch.cat([Ai, Ci], dim=-1))[0]
        M1, MC = M1C[..., :nx], M1C[..., nx:]
        M2 = torch.linalg.solve_ex(I + Jj @ Ci, Jj)[0]
        return (Aj @ M1, _sym(Aj @ MC @ _t(Aj) + Cj), _sym(_t(Ai) @ M2 @ Ai + Ji))

    V_next = _reverse_scan(combine, elems)[2][..., 1:, :, :]
    Huu = cost.R + _t(dyn.B) @ V_next @ dyn.B
    Hux = _t(cost.M) + _t(dyn.B) @ (V_next @ dyn.A)
    Huu_inv = torch.linalg.inv_ex(_sym(Huu))[0]
    K = -(Huu_inv @ Hux)
    return _factors(K, Huu_inv, Hux, _mv(V_next, dyn.c), dyn)


def riccati_factor(dyn: LQRDynamics, cost: LQRCost, method: str = "scan") -> RiccatiFactors:
    if method == "scan":
        return riccati_factor_scan(dyn, cost)
    if method == "assoc":
        return riccati_factor_assoc(dyn, cost)
    raise ValueError(f"unknown riccati method: {method!r}")


def lqr_linear_solve(fac: RiccatiFactors, q, r, x0):
    """Affine backward/forward sweep given a factorization.

    Returns (X, U): X (..., N+1, nx) with X[0] = x0, U (..., N, nu).

    The JAX package's sweep, per stage,

        w = Vc_k + v_{k+1},  d_k = -Huu_inv (r_k + B'w),
        v_k = q_k + A'w + Hux' d_k,   u_k = K x_k + d_k,
        x_{k+1} = A x_k + B u_k + c_k,

    is folded into the closed-loop maps of the factorization (K = -Huu_inv
    Hux, so Hux' d_k = K'(r_k + B'w)):

        v_k = Acl_k' v_{k+1} + (q_k + K_k' r_k + Acl_k' Vc_k),
        x_{k+1} = Acl_k x_k + (B_k d_k + c_k),

    with Acl = A + B K. Everything but the two recurrences is computed for
    all stages at once, so the sequential part is one matrix-vector product
    and one add per stage each way (the planner's horizons of 256-512
    stages run this 400 times per solve). The sums are associated
    differently from the JAX sweep; the rounding differs accordingly.
    """
    N = fac.K.shape[-3]
    nx = fac.A.shape[-1]
    batch = x0.shape[:-1]
    lanes = x0.reshape(-1, nx).shape[0]
    flat = lambda t: t.reshape((lanes, N) + t.shape[-2:])
    AclT = _t(fac.Acl)
    g = flat((q[..., :N, :] + _mv(_t(fac.K), r) + _mv(AclT, fac.Vc)).unsqueeze(-1))
    G = flat(AclT)
    v = q[..., N, :].reshape(lanes, nx, 1)
    vs = [v]
    for k in range(N - 1, -1, -1):
        v = torch.baddbmm(g[:, k], G[:, k], v)
        vs.append(v)
    v_next = torch.stack(vs[-2::-1], dim=1).reshape(batch + (N, nx))      # v_{k+1}, k = 0..N-1
    d = -(_mv(fac.Huu_inv, r) + _mv(fac.HB, fac.Vc + v_next))
    o = flat((_mv(fac.B, d) + fac.c).unsqueeze(-1))
    F = flat(fac.Acl)
    x = x0.reshape(lanes, nx, 1)
    xs = [x]
    for k in range(N):
        x = torch.baddbmm(o[:, k], F[:, k], x)
        xs.append(x)
    X = torch.stack(xs, dim=1).reshape(batch + (N + 1, nx))
    return X, _mv(fac.K, X[..., :N, :]) + d


def lqr_solve(dyn: LQRDynamics, cost: LQRCost, x0, method: str = "scan"):
    """One-shot equality-constrained solve (factor + affine sweep)."""
    return lqr_linear_solve(riccati_factor(dyn, cost, method), cost.q, cost.r, x0)

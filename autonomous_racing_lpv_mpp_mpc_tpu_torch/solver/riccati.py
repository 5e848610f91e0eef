"""Riccati / LQR factorization of the equality-constrained QP core (the JAX
package's ``solver/riccati.py``, sequential form).

    min  sum_k [ 1/2 x'Q x + q'x + 1/2 u'R u + r'u + x'M u ] + terminal
    s.t. x_{k+1} = A_k x_k + B_k u_k + c_k,   x_0 given.

The quadratic factor (gains, Schur complements) is computed once; the
affine sweep reuses it every ADMM iteration. Leading batch dims are kept:
A (..., N, nx, nx), q (..., N+1, nx), x0 (..., nx). The horizon is a Python
loop (JAX: ``lax.scan``). The associative (parallel-in-horizon) form is not
ported yet.
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
        Huu_inv = torch.linalg.inv(_sym(Huu))
        K_k = -Huu_inv @ Hux_k
        K[k], Hiv[k], Hux[k], Vc[k] = K_k, Huu_inv, Hux_k, _mv(V, c)
        V = _sym(Q + _t(A) @ V @ A + _t(Hux_k) @ K_k)
    return RiccatiFactors(
        torch.stack(K, dim=-3), torch.stack(Hiv, dim=-3), torch.stack(Hux, dim=-3),
        torch.stack(Vc, dim=-2), dyn.A, dyn.B, dyn.c,
    )


def riccati_factor(dyn: LQRDynamics, cost: LQRCost, method: str = "scan") -> RiccatiFactors:
    if method == "scan":
        return riccati_factor_scan(dyn, cost)
    raise NotImplementedError(f"riccati method {method!r} is not ported yet")


def lqr_linear_solve(fac: RiccatiFactors, q, r, x0):
    """Affine backward/forward sweep given a factorization.

    Returns (X, U): X (..., N+1, nx) with X[0] = x0, U (..., N, nu).
    """
    N = fac.K.shape[-3]
    v = q[..., N, :]
    d = [None] * N
    for k in range(N - 1, -1, -1):
        w = fac.Vc[..., k, :] + v
        h_u = r[..., k, :] + _mv(_t(fac.B[..., k, :, :]), w)
        d[k] = -_mv(fac.Huu_inv[..., k, :, :], h_u)
        v = q[..., k, :] + _mv(_t(fac.A[..., k, :, :]), w) + _mv(_t(fac.Hux[..., k, :, :]), d[k])
    xs, us = [x0], []
    x = x0
    for k in range(N):
        u = _mv(fac.K[..., k, :, :], x) + d[k]
        x = _mv(fac.A[..., k, :, :], x) + _mv(fac.B[..., k, :, :], u) + fac.c[..., k, :]
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


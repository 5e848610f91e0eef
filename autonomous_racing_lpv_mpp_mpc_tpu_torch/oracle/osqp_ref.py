"""The ground truth: OSQP's algorithm in dense float64 numpy/scipy on the host.

The port's copy of the JAX package's ``oracle/osqp_ref.py``, kept line for
line, so that both packages' oracles give the same bits on the same QP.
It stays numpy on the host on purpose: it is the reference that the
port's float32 solvers and CUDA kernels are held against, so it shares no
code, no precision and no device with them. A torch or GPU version would
be one more implementation under test, not a ground truth.

The OSQP wheels are not available offline, so this is a self-built
float64 implementation of OSQP's ADMM:

    [ P + sigma*I   A' ] [x~]   [ sigma*x - q   ]
    [ A       -1/rho*I ] [nu] = [ z - y/rho     ]

    z~ = z + (nu - y)/rho
    x  <- alpha*x~ + (1-alpha)*x
    z  <- Proj_[l,u]( alpha*z~ + (1-alpha)*z + y/rho )
    y  <- y + rho*( alpha*z~ + (1-alpha)*z - z_new )

with per-row rho (equality rows get 1e3*rho, OSQP's rho_eq scaling),
adaptive rho with KKT refactorization, OSQP's eps_abs/eps_rel
termination on r_prim = ||Ax - z||_inf, r_dual = ||Px + q + A'y||_inf,
and OSQP's primal and dual infeasibility certificates.

Solves the QP   min 1/2 x'Px + q'x  s.t.  l <= Ax <= u   (dense float64;
the tracker's QP at N=20 has n=200 variables and m=286 rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg


@dataclasses.dataclass
class OsqpRefSettings:
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 4000
    eps_abs: float = 1e-8
    eps_rel: float = 1e-8
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    adaptive_rho_tolerance: float = 5.0
    rho_eq_scale: float = 1e3
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # OSQP infeasibility-certificate tolerances (eps_prim_inf / eps_dual_inf)
    eps_pinf: float = 1e-4
    eps_dinf: float = 1e-4
    # certificates are evaluated only every `check_interval` iterations and
    # must hold on two consecutive checks (OSQP checks at check_termination
    # cadence; raw one-step deltas on early transients can spuriously
    # certify marginally feasible problems)
    check_interval: int = 25


@dataclasses.dataclass
class OsqpRefResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    iters: int
    r_prim: float
    r_dual: float
    converged: bool
    obj: float
    # OSQP status certificates: delta-y proves primal infeasibility, delta-x
    # proves dual infeasibility (unboundedness). None if not certified.
    primal_infeasible: bool = False
    dual_infeasible: bool = False
    cert_dy: Optional[np.ndarray] = None
    cert_dx: Optional[np.ndarray] = None


def _primal_infeasibility_cert(A, l, u, dy, eps) -> bool:
    """OSQP: dy certifies primal infeasibility iff
    ||A' dy||_inf <= eps*||dy||_inf  and  u'[dy]_+ + l'[dy]_- <= -eps*||dy||_inf
    (rows with infinite bounds cannot carry a certificate component of the
    matching sign, which the support-function term enforces)."""
    norm = np.abs(dy).max() if dy.size else 0.0
    if norm < 1e-14:
        return False
    dyp = np.maximum(dy, 0.0)
    dym = np.minimum(dy, 0.0)
    # infinite bound with a nonzero matching component -> support = +inf
    sup = 0.0
    for b, d in ((u, dyp), (l, dym)):
        inf_rows = ~np.isfinite(b)
        if np.any(np.abs(d[inf_rows]) > eps * norm):
            return False
        sup += float(b[~inf_rows] @ d[~inf_rows])
    return (np.abs(A.T @ dy).max() <= eps * norm) and (sup <= -eps * norm)


def _dual_infeasibility_cert(P, q, A, l, u, dx, eps) -> bool:
    """OSQP: dx certifies dual infeasibility (an unbounded ray) iff
    ||P dx||_inf <= eps*||dx||_inf, q'dx <= -eps*||dx||_inf, and A dx stays
    feasible along the ray (rows pushing past a finite bound disqualify)."""
    norm = np.abs(dx).max()
    if norm < 1e-14:
        return False
    if np.abs(P @ dx).max() > eps * norm or q @ dx > -eps * norm:
        return False
    Adx = A @ dx
    bad_up = (Adx > eps * norm) & np.isfinite(u)
    bad_lo = (Adx < -eps * norm) & np.isfinite(l)
    return not (np.any(bad_up) or np.any(bad_lo))


def _kkt_factor(P, A, sigma, rho_vec):
    n, m = P.shape[0], A.shape[0]
    K = np.zeros((n + m, n + m))
    K[:n, :n] = P + sigma * np.eye(n)
    K[:n, n:] = A.T
    K[n:, :n] = A
    K[n:, n:] = -np.diag(1.0 / rho_vec)
    return scipy.linalg.lu_factor(K)


def osqp_ref_solve(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    settings: Optional[OsqpRefSettings] = None,
    x0: Optional[np.ndarray] = None,
    y0: Optional[np.ndarray] = None,
) -> OsqpRefResult:
    s = settings or OsqpRefSettings()
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    n, m = P.shape[0], A.shape[0]

    eq = np.isclose(l, u)
    rho_bar = s.rho
    rho_vec = np.where(eq, s.rho_eq_scale * rho_bar, rho_bar)
    lu_piv = _kkt_factor(P, A, s.sigma, rho_vec)

    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    y = np.zeros(m) if y0 is None else np.asarray(y0, dtype=np.float64).copy()
    z = np.clip(A @ x, l, u)

    r_prim = r_dual = np.inf
    it = 0
    pinf = dinf = False
    pinf_pending = dinf_pending = False
    cert_dy = cert_dx = None
    for it in range(1, s.max_iter + 1):
        x_prev, y_prev = x, y
        rhs = np.concatenate([s.sigma * x - q, z - y / rho_vec])
        sol = scipy.linalg.lu_solve(lu_piv, rhs)
        x_t, nu = sol[:n], sol[n:]
        z_t = z + (nu - y) / rho_vec
        x = s.alpha * x_t + (1 - s.alpha) * x
        z_r = s.alpha * z_t + (1 - s.alpha) * z
        z_new = np.clip(z_r + y / rho_vec, l, u)
        y = y + rho_vec * (z_r - z_new)
        z = z_new

        # infeasibility certificates from the iterate deltas (OSQP §3.4),
        # evaluated at check_interval cadence and required to hold on two
        # consecutive checks
        if it % s.check_interval == 0:
            dy = y - y_prev
            dx = x - x_prev
            if _primal_infeasibility_cert(A, l, u, dy, s.eps_pinf):
                if pinf_pending:
                    pinf, cert_dy = True, dy / max(np.abs(dy).max(), 1e-30)
                    break
                pinf_pending = True
            else:
                pinf_pending = False
            if _dual_infeasibility_cert(P, q, A, l, u, dx, s.eps_dinf):
                if dinf_pending:
                    dinf, cert_dx = True, dx / max(np.abs(dx).max(), 1e-30)
                    break
                dinf_pending = True
            else:
                dinf_pending = False

        Ax = A @ x
        r_prim = np.abs(Ax - z).max() if m else 0.0
        r_dual = np.abs(P @ x + q + A.T @ y).max()
        eps_prim = s.eps_abs + s.eps_rel * max(np.abs(Ax).max(), np.abs(z).max())
        eps_dual = s.eps_abs + s.eps_rel * max(
            np.abs(P @ x).max(), np.abs(q).max(), np.abs(A.T @ y).max()
        )
        if r_prim <= eps_prim and r_dual <= eps_dual:
            break

        if s.adaptive_rho and it % s.adaptive_rho_interval == 0:
            ratio = np.sqrt(
                (r_prim / max(eps_prim, 1e-15)) / max(r_dual / max(eps_dual, 1e-15), 1e-15)
            )
            if ratio > s.adaptive_rho_tolerance or ratio < 1 / s.adaptive_rho_tolerance:
                rho_bar = float(np.clip(rho_bar * ratio, s.rho_min, s.rho_max))
                rho_vec = np.where(eq, s.rho_eq_scale * rho_bar, rho_bar)
                lu_piv = _kkt_factor(P, A, s.sigma, rho_vec)

    obj = 0.5 * x @ P @ x + q @ x
    eps_prim = s.eps_abs + s.eps_rel * max(np.abs(A @ x).max(), np.abs(z).max()) if m else s.eps_abs
    conv = bool(r_prim <= eps_prim and r_dual <= s.eps_abs + s.eps_rel * max(
        np.abs(P @ x).max(), np.abs(q).max(), np.abs(A.T @ y).max()
    ))
    return OsqpRefResult(x=x, y=y, z=z, iters=it, r_prim=float(r_prim),
                         r_dual=float(r_dual), converged=conv, obj=float(obj),
                         primal_infeasible=pinf, dual_infeasible=dinf,
                         cert_dy=cert_dy, cert_dx=cert_dx)

"""What the kernels' operation counts share: scalar statement counts and
the zero patterns of the tracker's stage, with the operations of each part
of the solve.

Operations per lane that the algorithm needs: a multiply-add counts 2; an
add, multiply, division, compare, square root or transcendental counts 1.
A product with a matrix whose zero pattern is fixed counts only its
structural multiply-adds: the constant +-1 selector rows D = [Dx Du] cost
only the additions where two of their entries meet in one output, and the
LPV (A, B) and the discrete (Ad, Bd) count the nonzeros that the plain
stage build leaves. The Riccati cost-to-go and the gains count dense.
Bytes: each input read once, each output written once. The zero patterns
come from the benchmark's reference (``reference/tracker.py``), never from
the program."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import tracker as ref

NU, NC = ref.NU, ref.NC

# Scalar code, counted statement by statement in the kernels' source order.
SCALAR_OPS = {
    # kap_at: divide, floor, multiply, subtract, multiply, clamp 2
    "kap_at": 7,
    # the dynamic LPV (A, B): vxs 1, sin/cos of delta and e_psi 4, den 3,
    # A00 3, A01 4, A02 3, A11 3, A12 6, A21 6, A22 7, A30 2, A31 2, A40 1,
    # A41 1, A53 (vxs sinc) 5, B00 2, B10 2, B20 3
    "ab_cont_dynamic": sum((1, 4, 3, 3, 4, 3, 3, 6, 6, 7, 2, 2, 1, 1, 5, 2, 2, 3)),
    # Pacejka secant stiffness: fzf 5, fzr 4, af 4, ar 3, the two slip
    # floors 2, Bf 3, Br 3, Cf 6, Cr 6
    "secant_pacejka": sum((5, 4, 4, 3, 2, 3, 3, 6, 6)),
    # the Frenet dynamic bicycle: vxs 1, alpha_f 4, alpha_r 3, L 1, fzf 4,
    # fzr 4, sin/cos 4, denom 3, sdot 4, dx0 9, dx1 5, dx2 5, dx3 2, dx5 3;
    # the tyre forces are added by tyre_ops
    "f_dynamic": sum((1, 4, 3, 1, 4, 4, 4, 3, 4, 9, 5, 5, 2, 3)),
    # per stage: the friction-circle vx cap (multiply 2, max, divide,
    # square root, clamp 2), the vx-reference clamp 1
    "stage_cap": 8,
    # the termination test: max, multiply-add 2 x 2, multiply, compare 2
    "converged": 8,
    # after the loop: r_dual 1, eps_prim 3, eps_dual 2, conv 2, ratio 8,
    # rho_new 3, rho_next 3
    "core_tail": sum((1, 3, 2, 2, 8, 3, 3)),
}


def tyre_ops(tire: str) -> int:
    """Axle forces: linear 2; Pacejka Bf 3, Br 3, fyf 5, fyr 5."""
    return 16 if tire == "pacejka" else 2


def pat(P, Q):
    """Zero pattern of the product of two zero patterns."""
    return (P.astype(np.int64) @ Q.astype(np.int64)) > 0


def pmm(P, Q):
    """Operations of the product of two zero patterns: 2 per structural
    multiply-add."""
    return 2 * int((P.astype(np.int64) @ Q.astype(np.int64)).sum())


def sel(D):
    """Operations of y = D v for a +-1 selector D: its additions."""
    return int(D.sum() - D.any(axis=1).sum())


def ones(r, c):
    return np.ones((r, c), dtype=bool)


class Structure(NamedTuple):
    """Zero patterns of the stage: continuous A (nx, nx), B (nx, NU), the
    augmented discrete Aa (na, na), Ba (na, NU), the selector rows
    D = [Dx Du] (NC, na + NU), and the number of soft rows."""

    A: np.ndarray
    B: np.ndarray
    Aa: np.ndarray
    Ba: np.ndarray
    D: np.ndarray
    soft: int


def vanloan_ops(A, B):
    """The Van Loan exponential on the top blocks [Ad Bd]: the scaling, 5
    Horner steps and 4 squarings, each product at the patterns its operands
    have at that step. Returns (ops, Ad pattern, Bd pattern)."""
    nx = A.shape[0]
    eye = np.eye(nx, dtype=bool)
    Ad, Bd = A | eye, B.copy()
    ops = 2 * int(A.sum()) + nx + 2 * int(B.sum())
    for _ in range(5):
        T, Tb = pat(A, Ad), pat(A, Bd)
        ops += pmm(A, Ad) + pmm(A, Bd) + int(T.sum()) + nx + 2 * int((Tb | B).sum())
        Ad, Bd = T | eye, Tb | B
    for _ in range(4):
        ops += pmm(Ad, Ad) + pmm(Ad, Bd) + int(Bd.sum())
        Ad, Bd = pat(Ad, Ad), pat(Ad, Bd) | Bd
    return ops, Ad, Bd


def structure(setup: "ref.Setup") -> Structure:
    """The zero patterns of the configuration's stage, from the reference's
    stage build at 64 random scheduling points."""
    g = torch.Generator().manual_seed(0)
    x = 0.5 + torch.rand((ref.NX, 64), generator=g)
    u = 0.2 * torch.rand((NU, 64), generator=g) - 0.1
    kap = 0.5 * torch.rand((64,), generator=g) - 0.25
    pv = ref.vehicle_rows(setup, torch.full((64,), float(setup.vehicle["mu"])))
    A, B = ref.lpv_ab(x, u, kap, pv, setup.tire)
    Aa, Ba = ref.discretize_aug(A, B, setup.dt, ref.Precision())
    nz = lambda t: (t != 0).any(dim=-1).numpy()
    k = ref.consts(setup, "cpu")
    D = np.concatenate([k.Dx.numpy() != 0, k.Du.numpy() != 0], axis=1)
    S = Structure(nz(A), nz(B), nz(Aa), nz(Ba), D, int(torch.isfinite(k.soft).sum()))
    _, Ad, Bd = vanloan_ops(S.A, S.B)
    nx = S.A.shape[0]
    if not (np.array_equal(Ad, S.Aa[:nx, :nx]) and np.array_equal(Bd, S.Ba[:nx])):
        raise ValueError("the Van Loan pattern count disagrees with the reference's stage build")
    return S


def stage_build_ops(S: Structure, tire: str) -> int:
    """One stage's LPV (A, B) and its Van Loan discretization."""
    lpv = SCALAR_OPS["ab_cont_dynamic"] + (SCALAR_OPS["secant_pacejka"] if tire == "pacejka" else 0)
    return lpv + vanloan_ops(S.A, S.B)[0]


def fold_ops(S: Structure) -> int:
    """The rho-folded cost blocks Qc + rho DxDx, Qtc + rho DxDx,
    Rc + rho DuDu, Mc + rho DxDu, once per solve."""
    na = S.Aa.shape[0]
    Dx, Du = S.D[:, :na], S.D[:, na:]
    return 2 * (2 * int(pat(Dx.T, Dx).sum()) + int(pat(Du.T, Du).sum()) + int(pat(Dx.T, Du).sum()))


def factor_ops(Aa, Ba) -> int:
    """One stage of the backward Riccati factor."""
    na, nu = Ba.shape
    V = ones(na, na)
    VA = pat(V, Aa)
    return (pmm(V, Ba) + pmm(Ba.T, ones(na, nu)) + nu * nu       # V Ba, Huu = Rf + Ba' V Ba
            + pmm(V, Aa) + pmm(Ba.T, VA) + nu * na               # V Aa, Hux = Mf' + Ba' V Aa
            + 8 + pmm(ones(nu, nu), ones(nu, na))                # inv2, K = -Huu^-1 Hux
            + pmm(Aa.T, VA) + pmm(ones(na, nu), ones(nu, na))    # Aa' V Aa, Hux' K
            + 2 * na * na + na * (na - 1))                       # V = Qf + ..., symmetrize


def iteration_ops(S: Structure, N: int) -> int:
    """One ADMM iteration over N stages and the terminal one, with its
    z-update and the termination test."""
    Aa, Ba = S.Aa, S.Ba
    na, nu = Ba.shape
    D, Dx = S.D, S.D[:, :na]
    ncol, ncol_x = int(D.any(axis=0).sum()), int(Dx.any(axis=0).sum())
    col = ones(na, 1)
    back = (2 * NC + sel(D.T) + 2 * (na + nu) + 2 * ncol                  # v, D'v, q, r
            + pmm(Ba.T, col) + nu + pmm(ones(nu, nu), ones(nu, 1))       # hu, d
            + pmm(Aa.T, col) + pmm(ones(na, nu), ones(nu, 1)) + 2 * na)  # v_k
    back_n = 2 * NC + sel(Dx.T) + 2 * na + 2 * ncol_x
    # z-update per row: w_rel 3, wl 2, clamp 2, lam 3, |G - s| max 2, |G|
    # max 1, |s| max 1, ds 1; a soft row adds its prox 4; then the dual
    # norms D'ds and D'lam with their maxima
    z = sel(D) + 15 * NC + 4 * S.soft + 2 * sel(D.T) + 2 * ncol
    z_n = sel(Dx) + 15 * NC + 4 * S.soft + 2 * sel(Dx.T) + 2 * ncol_x
    fwd = pmm(ones(nu, na), col) + nu + pmm(Aa, col) + pmm(Ba, ones(nu, 1)) + z
    return N * (back + fwd) + back_n + z_n + SCALAR_OPS["converged"]


def core_ops(S: Structure, tire: str, N: int, iters: float) -> float:
    """The tracker's solve per lane: per stage the curvature, friction
    cap, reference clamp, linear cost and warm-start clip; N stage builds;
    the folded cost; N factor stages; ``iters`` iterations; residuals and
    rho. The limp-home branch, which no converged lane takes, is not
    counted."""
    nx = S.A.shape[0]
    per_stage = SCALAR_OPS["kap_at"] + SCALAR_OPS["stage_cap"] + nx + 2 * NC
    return (N * stage_build_ops(S, tire) + (N + 1) * per_stage + fold_ops(S)
            + N * factor_ops(S.Aa, S.Ba) + iters * iteration_ops(S, N) + SCALAR_OPS["core_tail"])


def plant_ops(S: Structure, tire: str, n_sub: int) -> int:
    """``n_sub`` Euler sub-steps of the Frenet plant, each with its
    curvature lookup."""
    nx = S.A.shape[0]
    return n_sub * (SCALAR_OPS["f_dynamic"] + tyre_ops(tire) + SCALAR_OPS["kap_at"] + 2 * nx)


def step_ops(setup: "ref.Setup", iters: float) -> float:
    """Operations per lane of one closed-loop step (the solve and the
    plant), whatever route computes it."""
    S = structure(setup)
    return core_ops(S, setup.tire, setup.N, iters) + plant_ops(S, setup.sim_tire, setup.n_sub)

"""Batch-last stage math in plain PyTorch (the JAX package's
``ops/stage_math.py``), used by the plain megastep, racestep and fused
solve, for the dynamic (nx=6) and the kinematic (nx=4) bicycle.

The scenario batch is the LAST axis; any axes between the matrix axes and
the batch are carried along (the plain megastep builds all N stages at
once as (..., N, B)). The CUDA kernels compute the same functions per lane
in ``csrc/arl_common.cuh``.
"""

from __future__ import annotations

import math

import torch

NX, NU, NA, NC = 6, 2, 8, 6            # dynamic-bicycle dims
KIN_NX, KIN_NA = 4, 6                  # kinematic bicycle (BASELINE config 1)
VX_EPS = 0.05
DENOM_EPS = 0.1
PACEJKA_C = 1.3
PARAM_ROWS = ("m", "Iz", "lf", "lr", "Cf", "Cr", "mu", "g", "cd0", "cd1")


def model_dims(model: str):
    """(nx, na) for a model; na = nx + NU (the (x, u_prev) augmentation)."""
    if model == "dynamic":
        return NX, NA
    if model == "kinematic":
        return KIN_NX, KIN_NA
    raise ValueError(model)


def model_s_ey(model: str):
    """(s_idx, ey_idx) in the model's state vector."""
    return (4, 5) if model == "dynamic" else (2, 3)


def unpack_params(prm: torch.Tensor) -> dict:
    """(10, B) vehicle-parameter rows -> named (B,) values."""
    return dict(zip(PARAM_ROWS, prm))


def stack_params(p_b, B: int, device) -> torch.Tensor:
    """(10, B) float32 rows of a :class:`VehicleParams` whose leaves are
    floats or (B,) tensors, on ``device``. Float leaves are filled on the
    device (no host-to-device copy, which would wait for the device)."""
    rows = []
    for n in PARAM_ROWS:
        v = getattr(p_b, n)
        if isinstance(v, torch.Tensor):
            rows.append(v.to(device=device, dtype=torch.float32).reshape(-1).expand(B))
        else:
            rows.append(torch.full((B,), float(v), dtype=torch.float32, device=device))
    return torch.stack(rows).contiguous()


def _mm(a, b):
    """(i, j, ...) @ (j, l, ...) -> (i, l, ...)"""
    return torch.einsum("ij...,jl...->il...", a, b)


def _sinc(x):
    return torch.sinc(x / math.pi)


def secant_stiffness(pv, delta, vy, wz, vxs, tire: str):
    """Per-lane cornering stiffnesses: the linear constants or the Pacejka
    secant stiffness at the scheduled slip."""
    if tire != "pacejka":
        return pv["Cf"], pv["Cr"]
    lf, lr = pv["lf"], pv["lr"]
    fzf = pv["mu"] * pv["m"] * pv["g"] * lr / (lf + lr)
    fzr = pv["mu"] * pv["m"] * pv["g"] * lf / (lf + lr)
    af = delta - torch.atan2(vy + lf * wz, vxs)
    ar = -torch.atan2(vy - lr * wz, vxs)
    eps = 1e-4
    af = torch.where(torch.abs(af) < eps, torch.full_like(af, eps), af)
    ar = torch.where(torch.abs(ar) < eps, torch.full_like(ar, eps), ar)
    Bf_ = pv["Cf"] / (PACEJKA_C * torch.clamp_min(fzf, 1e-6))
    Br_ = pv["Cr"] / (PACEJKA_C * torch.clamp_min(fzr, 1e-6))
    Cf = fzf * torch.sin(PACEJKA_C * torch.atan(Bf_ * af)) / af
    Cr = fzr * torch.sin(PACEJKA_C * torch.atan(Br_ * ar)) / ar
    return Cf, Cr


def _ab_cont_dynamic(x, u, kap, pv, tire: str):
    """Continuous-time LPV (A, B) for the dynamic bicycle, batch-last:
    x (NX, ...), u (NU, ...), kap (...) -> (NX, NX, ...), (NX, NU, ...)."""
    m_, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    cd0, cd1 = pv["cd0"], pv["cd1"]
    vx, vy, wz, epsi, ey = x[0], x[1], x[2], x[3], x[5]
    delta = u[0]
    vxs = torch.clamp_min(vx, VX_EPS)
    Cf, Cr = secant_stiffness(pv, delta, vy, wz, vxs, tire)

    sd, cd_ = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    den = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    z = torch.zeros_like(vx)
    one = torch.ones_like(vx)

    a00 = -(cd1 + cd0 / vxs) / m_
    a01 = Cf * sd / (m_ * vxs) + wz
    a02 = Cf * lf * sd / (m_ * vxs)
    a11 = -(Cf * cd_ + Cr) / (m_ * vxs)
    a12 = (-Cf * lf * cd_ + Cr * lr) / (m_ * vxs) - vxs
    a21 = (-lf * Cf * cd_ + lr * Cr) / (Iz * vxs)
    a22 = -(lf ** 2 * Cf * cd_ + lr ** 2 * Cr) / (Iz * vxs)
    a30 = -kap * ce / den
    a31 = kap * se / den
    a40 = ce / den
    a41 = -se / den
    a51 = ce
    a53 = vxs * _sinc(epsi)
    A6 = torch.stack([
        torch.stack([a00, a01, a02, z, z, z]),
        torch.stack([z, a11, a12, z, z, z]),
        torch.stack([z, a21, a22, z, z, z]),
        torch.stack([a30, a31, one, z, z, z]),
        torch.stack([a40, a41, z, z, z, z]),
        torch.stack([z, a51, z, a53, z, z]),
    ])
    b00 = -Cf * sd / m_
    b10 = Cf * cd_ / m_
    b20 = lf * Cf * cd_ / Iz
    B6 = torch.stack([
        torch.stack([b00, one]),
        torch.stack([b10, z]),
        torch.stack([b20, z]),
        torch.stack([z, z]),
        torch.stack([z, z]),
        torch.stack([z, z]),
    ])
    return A6, B6


def _ab_cont_kinematic(x, u, kap, pv):
    """Continuous-time LPV (A, B) for the kinematic bicycle, batch-last:
    x = (vx, e_psi, s, e_y) (KIN_NX, ...), u (NU, ...), kap (...)."""
    m_, lf, lr = pv["m"], pv["lf"], pv["lr"]
    vx, epsi, ey = x[0], x[1], x[3]
    vxs = torch.clamp_min(vx, VX_EPS)
    L = lf + lr
    se, ce = torch.sin(epsi), torch.cos(epsi)
    den = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    z = torch.zeros_like(vx)
    one = torch.ones_like(vx)
    a00 = -(pv["cd1"] + pv["cd0"] / vxs) / m_
    A4 = torch.stack([
        torch.stack([a00, z, z, z]),
        torch.stack([-kap * ce / den, z, z, z]),
        torch.stack([ce / den, z, z, z]),
        torch.stack([z, vxs * _sinc(epsi), z, z]),
    ])
    B4 = torch.stack([
        torch.stack([z, one]),
        torch.stack([vxs / L, z]),
        torch.stack([z, z]),
        torch.stack([z, z]),
    ])
    return A4, B4


def _vanloan_aug(A_c, B_c, *, dt: float, squarings: int, order: int):
    """Van Loan exp([[A, B], [0, 0]] dt) + (x, u_prev) augmentation,
    batch-last. Returns (Aa (NA, NA, ...), Ba (NA, NU, ...))."""
    nx = A_c.shape[0]
    na = nx + NU
    lanes = A_c.shape[2:]
    kw = dict(dtype=A_c.dtype, device=A_c.device)
    top = torch.cat([A_c, B_c], dim=1)
    Mv = torch.cat([top, torch.zeros((NU, na) + lanes, **kw)], dim=0) * (dt / (2.0 ** squarings))
    Iav = torch.eye(na, **kw).reshape((na, na) + (1,) * len(lanes))
    E = Iav + Mv / order
    for j in range(order - 1, 0, -1):
        E = Iav + _mm(Mv, E) / j
    for _ in range(squarings):
        E = _mm(E, E)
    Ad = E[:nx, :nx]
    Bd = E[:nx, nx:]
    Aa = torch.zeros((na, na) + lanes, **kw)
    Aa[:nx, :nx] = Ad
    Ba = torch.cat([Bd, torch.eye(NU, **kw).reshape((NU, NU) + (1,) * len(lanes)).expand((NU, NU) + lanes)], dim=0)
    return Aa, Ba


def stage_aug_ab(x, u, kap, pv, *, dt: float, tire: str, squarings: int = 4, order: int = 6,
                 model: str = "dynamic"):
    """One scheduled stage (or a stack of them): LPV linearization + Van
    Loan discretization + augmentation, batch-last. ``model`` selects the
    dynamic (nx=6) or kinematic (nx=4) LPV; the kinematic one has no tires."""
    if model == "kinematic":
        A_c, B_c = _ab_cont_kinematic(x, u, kap, pv)
    else:
        A_c, B_c = _ab_cont_dynamic(x, u, kap, pv, tire)
    return _vanloan_aug(A_c, B_c, dt=dt, squarings=squarings, order=order)


def f_dynamic_bl(pv, x, u, kap, tire: str):
    """Batch-last nonlinear dynamic-bicycle Frenet ODE. x (NX, B)."""
    vx, vy, wz, epsi, ey = x[0], x[1], x[2], x[3], x[5]
    delta, a = u[0], u[1]
    m_, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    vxs = torch.clamp_min(vx, VX_EPS)

    alpha_f = delta - torch.atan2(vy + lf * wz, vxs)
    alpha_r = -torch.atan2(vy - lr * wz, vxs)
    L = lf + lr
    fzf = pv["mu"] * m_ * pv["g"] * lr / L
    fzr = pv["mu"] * m_ * pv["g"] * lf / L
    if tire == "pacejka":
        Bf_ = pv["Cf"] / (PACEJKA_C * torch.clamp_min(fzf, 1e-6))
        Br_ = pv["Cr"] / (PACEJKA_C * torch.clamp_min(fzr, 1e-6))
        fyf = fzf * torch.sin(PACEJKA_C * torch.atan(Bf_ * alpha_f))
        fyr = fzr * torch.sin(PACEJKA_C * torch.atan(Br_ * alpha_r))
    else:
        fyf = pv["Cf"] * alpha_f
        fyr = pv["Cr"] * alpha_r

    sd, cd_ = torch.sin(delta), torch.cos(delta)
    dvx = a - (fyf * sd) / m_ + wz * vy - (pv["cd0"] + pv["cd1"] * vx) / m_
    dvy = (fyf * cd_ + fyr) / m_ - wz * vx
    dwz = (lf * fyf * cd_ - lr * fyr) / Iz

    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    sdot = (vx * ce - vy * se) / denom
    depsi = wz - kap * sdot
    dey = vx * se + vy * ce
    return torch.stack([dvx, dvy, dwz, depsi, sdot, dey])


def f_kinematic_bl(pv, x, u, kap):
    """Batch-last kinematic-bicycle Frenet ODE; x (KIN_NX, B). tan(delta)
    as sin/cos, the form the CUDA version computes."""
    vx, epsi, ey = x[0], x[1], x[3]
    delta, a = u[0], u[1]
    L = pv["lf"] + pv["lr"]
    dvx = a - (pv["cd0"] + pv["cd1"] * vx) / pv["m"]
    psidot = vx * torch.sin(delta) / (torch.cos(delta) * L)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    sdot = vx * ce / denom
    return torch.stack([dvx, psidot - kap * sdot, sdot, vx * se])


def f_model_bl(model: str, pv, x, u, kap, tire: str):
    if model == "kinematic":
        return f_kinematic_bl(pv, x, u, kap)
    return f_dynamic_bl(pv, x, u, kap, tire)


def f_global_bl(pv, xg, u, tire: str):
    """Batch-last world-frame dynamic-bicycle ODE; xg (6, B) = (vx, vy,
    wz, X, Y, psi). No curvature: the Frenet state is measured from it."""
    vx, vy, wz, psi = xg[0], xg[1], xg[2], xg[5]
    delta, a = u[0], u[1]
    m_, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    vxs = torch.clamp_min(vx, VX_EPS)
    alpha_f = delta - torch.atan2(vy + lf * wz, vxs)
    alpha_r = -torch.atan2(vy - lr * wz, vxs)
    L = lf + lr
    fzf = pv["mu"] * m_ * pv["g"] * lr / L
    fzr = pv["mu"] * m_ * pv["g"] * lf / L
    if tire == "pacejka":
        Bf_ = pv["Cf"] / (PACEJKA_C * torch.clamp_min(fzf, 1e-6))
        Br_ = pv["Cr"] / (PACEJKA_C * torch.clamp_min(fzr, 1e-6))
        fyf = fzf * torch.sin(PACEJKA_C * torch.atan(Bf_ * alpha_f))
        fyr = fzr * torch.sin(PACEJKA_C * torch.atan(Br_ * alpha_r))
    else:
        fyf = pv["Cf"] * alpha_f
        fyr = pv["Cr"] * alpha_r
    sd, cd_ = torch.sin(delta), torch.cos(delta)
    dvx = a - (fyf * sd) / m_ + wz * vy - (pv["cd0"] + pv["cd1"] * vx) / m_
    dvy = (fyf * cd_ + fyr) / m_ - wz * vx
    dwz = (lf * fyf * cd_ - lr * fyr) / Iz
    sp, cp = torch.sin(psi), torch.cos(psi)
    return torch.stack([dvx, dvy, dwz, vx * cp - vy * sp, vx * sp + vy * cp, wz])


def pacejka_mu_sensitivity(mu, alpha, stiffness, fz):
    """(Fy, dFy/dmu) of the magic formula Fy = mu fz sin(C atan(B alpha)),
    B = stiffness / (C mu fz), in closed form: dFy/dmu = fz [sin th -
    cos th C t / (1 + t^2)] with t = B alpha, th = C atan(t)."""
    D = torch.clamp_min(mu * fz, 1e-6)
    t = stiffness / (PACEJKA_C * D) * alpha
    th = PACEJKA_C * torch.atan(t)
    fy = mu * fz * torch.sin(th)
    return fy, fz * (torch.sin(th) - torch.cos(th) * PACEJKA_C * t / (1.0 + t * t))


def _inv6(S):
    """Batched (6, 6, B) inverse by unrolled Gauss-Jordan without pivoting:
    S is an innovation covariance (SPD, positive diagonal), so no pivot
    vanishes."""
    M = S
    Inv = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)[:, :, None].expand_as(S)
    for j in range(S.shape[0]):
        rec = 1.0 / M[j, j]
        Mj, Ij = M[j] * rec, Inv[j] * rec
        fac = M[:, j][:, None, :]
        M = M - fac * Mj[None]
        Inv = Inv - fac * Ij[None]
        M = torch.cat([M[:j], Mj[None], M[j + 1:]])
        Inv = torch.cat([Inv[:j], Ij[None], Inv[j + 1:]])
    return Inv

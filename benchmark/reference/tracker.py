"""Plain reference of the batched LPV-MPC tracker step and its plant, the
benchmark's frozen copy of the semantics (dynamic bicycle), batch-LAST:
every tensor carries the scenario batch as its last axis.

One step, per lane: shift the schedule one stage -> curvature and
friction-cap bounds -> LPV (A, B) per stage and their Van Loan
discretization with the (x, u_prev) augmentation -> warm start shifted and
clipped -> rho-folded cost and the backward Riccati factor -> ADMM (OSQP
semantics: over-relaxation, soft e_y row, sigma prox) with the termination
test per iteration or per chunk, and the 128-lane early exit -> residuals,
convergence and the adaptive rho -> the solution or the limp-home control
-> ``n_sub`` Euler steps of the nonlinear plant.

It imports nothing of the program and takes nothing the program made but
the carry it is told to step from. Every product of small matrices goes
through :meth:`Precision.ein`, which computes it in float32 or, for the
control, with its operands rounded to TF32 first.

It is also the reference a cell is held to by default (the interface in
``reference/__init__.py``): :func:`setup_from_config`, :func:`track`,
``GROUP`` and :func:`compare`, the comparison that decides ``correct``.
Its numbers (the names a cell's ``check.limits`` use):

- ``init_gap``: the first sweep's initial carry, max |program - reference|
  over the sampled lanes (the schedule's Euler rollout; the split, duals,
  inputs and rho must start as the reference's);
- ``groups_split``: the share of sampled 128-lane groups in which the two
  sides leave the ADMM loop at another iteration or take another branch
  (solution or limp-home) on some lane; the numbers below are over the
  other groups' lanes;
- ``u0_p99``, ``u0_max``: the 99th percentile and the maximum of
  |u0 program - u0 reference| (rad, m/s^2) over those lanes;
- ``x_max``: max |next state program - reference| over those lanes;
- ``pred_max``: max |X_pred, U_pred program - reference| over those lanes
  (the next step's schedule and warm start);
- ``doneat_split``: the share of all sampled lanes whose done-at (the
  iteration at which the lane passed the termination test) differs from
  the reference's.

``doneat_gap`` (the widest done-at difference) is printed beside them; it
swings by whole chunks from a single lane at the test's threshold, so it
is not compared.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import check
from benchmark.reference.track import curvature_lookup, track_table

NX, NU, NA, NC = 6, 2, 8, 6
S_IDX, EY_IDX = 4, 5
GROUP = 128            # lanes that leave the ADMM loop together
VX_EPS, DENOM_EPS, PACEJKA_C = 0.05, 0.1, 1.3
RHO_MIN, RHO_MAX, RHO_TOL = 1e-4, 1e3, 5.0
VANLOAN_SQUARINGS, VANLOAN_ORDER = 4, 6
PARAM_NAMES = ("m", "Iz", "lf", "lr", "Cf", "Cr", "mu", "g", "cd0", "cd1")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the tensor cores round a TF32 product's operands."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """How the reference computes its small-matrix products: "f32" (the
    configuration's precision) or "tf32" (the control)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def ein(self, spec: str, *ops):
        if self.mode == "tf32":
            ops = tuple(tf32_round(o) for o in ops)
        return torch.einsum(spec, *ops)


class Setup(NamedTuple):
    """The numbers of one configuration that the step needs."""

    N: int
    dt: float
    tire: str                 # the controller's LPV tyres
    sim_tire: str             # the plant's
    n_sub: int
    kappa_speed_cap: bool
    a_lat_frac: float
    q: tuple
    r: tuple
    dr: tuple
    bounds: dict
    solver: dict
    vehicle: dict


def setup_from_config(cfg: dict) -> Setup:
    """A :class:`Setup` from a configuration file's dict."""
    if cfg["model"] != "dynamic":
        raise NotImplementedError("the reference steps the dynamic bicycle")
    w = cfg["weights"]
    return Setup(N=int(cfg["N"]), dt=float(cfg["dt"]), tire=cfg["tire"], sim_tire=cfg["sim_tire"],
                 n_sub=int(cfg["n_sub"]), kappa_speed_cap=bool(cfg["kappa_speed_cap"]),
                 a_lat_frac=float(cfg["a_lat_frac"]), q=tuple(w["q"]), r=tuple(w["r"]),
                 dr=tuple(w["dr"]), bounds=dict(cfg["bounds"]), solver=dict(cfg["solver"]),
                 vehicle=dict(cfg["vehicle"]))


def vehicle_rows(S: Setup, mu: torch.Tensor) -> dict:
    """Per-lane vehicle parameters: the configuration's, with friction mu
    (B,) per lane."""
    pv = {n: torch.full_like(mu, float(S.vehicle[n])) for n in PARAM_NAMES}
    pv["mu"] = mu.to(torch.float32)
    return pv


class Consts(NamedTuple):
    Dx: torch.Tensor
    Du: torch.Tensor
    soft: torch.Tensor
    Qc: torch.Tensor
    Qtc: torch.Tensor
    Rc: torch.Tensor
    Mc: torch.Tensor
    DxDx: torch.Tensor
    DuDu: torch.Tensor
    DxDu: torch.Tensor
    qw: torch.Tensor


def consts(S: Setup, device) -> Consts:
    """Constraint rows (vx, e_y, delta, a, Ddelta, Da), the soft e_y
    weight and the sigma-shifted cost blocks."""
    f = dict(dtype=torch.float64)
    sigma = float(S.solver["sigma"])
    Dx, Du = torch.zeros((NC, NA), **f), torch.zeros((NC, NU), **f)
    Dx[0, 0] = Dx[1, EY_IDX] = 1.0
    Du[2, 0] = Du[3, 1] = 1.0
    Dx[4, NX], Du[4, 0] = -1.0, 1.0
    Dx[5, NX + 1], Du[5, 1] = -1.0, 1.0
    soft = torch.full((NC,), math.inf, **f)
    soft[1] = float(S.bounds["ey_soft"])
    q, r, dr = (torch.tensor(v, **f) for v in (S.q, S.r, S.dr))
    Qc = torch.diag(torch.cat([q, dr])) + sigma * torch.eye(NA, **f)
    Qtc = torch.diag(torch.cat([q, torch.zeros(NU, **f)])) + sigma * torch.eye(NA, **f)
    Rc = torch.diag(r + dr) + sigma * torch.eye(NU, **f)
    Mc = torch.zeros((NA, NU), **f)
    Mc[NX:] = -torch.diag(dr)
    arrs = (Dx, Du, soft, Qc, Qtc, Rc, Mc, Dx.T @ Dx, Du.T @ Du, Dx.T @ Du, q)
    return Consts(*(a.to(device=device, dtype=torch.float32) for a in arrs))


# ---- model ----

def secant_stiffness(pv, delta, vy, wz, vxs, tire):
    if tire != "pacejka":
        return pv["Cf"], pv["Cr"]
    lf, lr = pv["lf"], pv["lr"]
    fzf = pv["mu"] * pv["m"] * pv["g"] * lr / (lf + lr)
    fzr = pv["mu"] * pv["m"] * pv["g"] * lf / (lf + lr)
    af = delta - torch.atan2(vy + lf * wz, vxs)
    ar = -torch.atan2(vy - lr * wz, vxs)
    af = torch.where(torch.abs(af) < 1e-4, torch.full_like(af, 1e-4), af)
    ar = torch.where(torch.abs(ar) < 1e-4, torch.full_like(ar, 1e-4), ar)
    Bf = pv["Cf"] / (PACEJKA_C * torch.clamp_min(fzf, 1e-6))
    Br = pv["Cr"] / (PACEJKA_C * torch.clamp_min(fzr, 1e-6))
    return (fzf * torch.sin(PACEJKA_C * torch.atan(Bf * af)) / af,
            fzr * torch.sin(PACEJKA_C * torch.atan(Br * ar)) / ar)


def lpv_ab(x, u, kap, pv, tire):
    """Continuous LPV (A (NX, NX, ...), B (NX, NU, ...)) at the scheduled
    x (NX, ...), u (NU, ...), kap (...)."""
    m, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    vx, vy, wz, epsi, ey = x[0], x[1], x[2], x[3], x[5]
    delta = u[0]
    vxs = torch.clamp_min(vx, VX_EPS)
    Cf, Cr = secant_stiffness(pv, delta, vy, wz, vxs, tire)
    sd, cd = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    den = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    z, one = torch.zeros_like(vx), torch.ones_like(vx)
    A = torch.stack([
        torch.stack([-(pv["cd1"] + pv["cd0"] / vxs) / m, Cf * sd / (m * vxs) + wz,
                     Cf * lf * sd / (m * vxs), z, z, z]),
        torch.stack([z, -(Cf * cd + Cr) / (m * vxs), (-Cf * lf * cd + Cr * lr) / (m * vxs) - vxs,
                     z, z, z]),
        torch.stack([z, (-lf * Cf * cd + lr * Cr) / (Iz * vxs),
                     -(lf ** 2 * Cf * cd + lr ** 2 * Cr) / (Iz * vxs), z, z, z]),
        torch.stack([-kap * ce / den, kap * se / den, one, z, z, z]),
        torch.stack([ce / den, -se / den, z, z, z, z]),
        torch.stack([z, ce, z, vxs * torch.sinc(epsi / math.pi), z, z]),
    ])
    B = torch.stack([
        torch.stack([-Cf * sd / m, one]),
        torch.stack([Cf * cd / m, z]),
        torch.stack([lf * Cf * cd / Iz, z]),
        torch.stack([z, z]), torch.stack([z, z]), torch.stack([z, z]),
    ])
    return A, B


def discretize_aug(A, B, dt, prec: Precision):
    """exp([[A B] [0 0]] dt) by scaling, a degree-6 Taylor (Horner) and 4
    squarings; returns the augmented stage Aa = [[Ad 0] [0 0]] (NA, NA,
    ...), Ba = [[Bd] [I]] (NA, NU, ...)."""
    lanes = A.shape[2:]
    kw = dict(dtype=A.dtype, device=A.device)
    M = torch.cat([torch.cat([A, B], dim=1), torch.zeros((NU, NA) + lanes, **kw)], dim=0)
    M = M * (dt / (2.0 ** VANLOAN_SQUARINGS))
    eye = torch.eye(NA, **kw).reshape((NA, NA) + (1,) * len(lanes))
    E = eye + M / VANLOAN_ORDER
    for j in range(VANLOAN_ORDER - 1, 0, -1):
        E = eye + prec.ein("ij...,jl...->il...", M, E) / j
    for _ in range(VANLOAN_SQUARINGS):
        E = prec.ein("ij...,jl...->il...", E, E)
    Aa = torch.zeros((NA, NA) + lanes, **kw)
    Aa[:NX, :NX] = E[:NX, :NX]
    Ba = torch.cat([E[:NX, NX:], torch.eye(NU, **kw).reshape((NU, NU) + (1,) * len(lanes))
                    .expand((NU, NU) + lanes)], dim=0)
    return Aa, Ba


def f_plant(pv, x, u, kap, tire):
    """The nonlinear Frenet dynamic bicycle dx/dt; x (NX, B), u (NU, B)."""
    vx, vy, wz, epsi, ey = x[0], x[1], x[2], x[3], x[5]
    delta, a = u[0], u[1]
    m, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    vxs = torch.clamp_min(vx, VX_EPS)
    alpha_f = delta - torch.atan2(vy + lf * wz, vxs)
    alpha_r = -torch.atan2(vy - lr * wz, vxs)
    L = lf + lr
    fzf = pv["mu"] * m * pv["g"] * lr / L
    fzr = pv["mu"] * m * pv["g"] * lf / L
    if tire == "pacejka":
        fyf = fzf * torch.sin(PACEJKA_C * torch.atan(pv["Cf"] / (PACEJKA_C * torch.clamp_min(fzf, 1e-6))
                                                     * alpha_f))
        fyr = fzr * torch.sin(PACEJKA_C * torch.atan(pv["Cr"] / (PACEJKA_C * torch.clamp_min(fzr, 1e-6))
                                                     * alpha_r))
    else:
        fyf, fyr = pv["Cf"] * alpha_f, pv["Cr"] * alpha_r
    sd, cd = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    den = torch.clamp_min(1.0 - kap * ey, DENOM_EPS)
    sdot = (vx * ce - vy * se) / den
    return torch.stack([a - fyf * sd / m + wz * vy - (pv["cd0"] + pv["cd1"] * vx) / m,
                        (fyf * cd + fyr) / m - wz * vx,
                        (lf * fyf * cd - lr * fyr) / Iz,
                        wz - kap * sdot, sdot, vx * se + vy * ce])


def plant(S: Setup, pv, kap_at, x, u):
    """``n_sub`` Euler sub-steps of one control period at the plant's tyres."""
    h = S.dt / S.n_sub
    for _ in range(S.n_sub):
        x = x + h * f_plant(pv, x, u, kap_at(x[S_IDX]), S.sim_tire)
    return x


def initial_carry(S: Setup, pv, kap_at, x0, prec: Precision | None = None) -> dict:
    """The carry before a first solve: the schedule is a zero-input Euler
    rollout of the controller's model at the control period; the ADMM split
    and duals start at zero, rho at 0.1. x0 (NX, B). The rollout holds no
    product of matrices: the precision below float32 for it is bfloat16,
    which the control (``prec.mode == "tf32"``) rounds each state to."""
    B = x0.shape[-1]
    u = torch.zeros((NU, B), dtype=torch.float32, device=x0.device)
    low = prec is not None and prec.mode == "tf32"
    xs, x = [x0], x0
    for _ in range(S.N):
        x = x + S.dt * f_plant(pv, x, u, kap_at(x[S_IDX]), S.tire)
        if low:
            x = x.to(torch.bfloat16).to(torch.float32)
        xs.append(x)
    z = torch.zeros((S.N + 1, NC, B), dtype=torch.float32, device=x0.device)
    return {"x": x0, "X_pred": torch.stack(xs), "U_pred": torch.zeros((S.N, NU, B), **_f32(x0)),
            "s": z, "lam": z.clone(), "u_prev": u, "rho": torch.full((B,), 0.1, **_f32(x0))}


def _f32(t):
    return dict(dtype=torch.float32, device=t.device)


# ---- the solve ----

def _inv2(H):
    a, b, c, d = H[0, 0], H[0, 1], H[1, 0], H[1, 1]
    r = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d * r, -b * r]), torch.stack([-c * r, a * r])])


def riccati_factor(k: Consts, A_s, B_s, rho, prec: Precision):
    """Backward Riccati factor of the rho-folded cost over the stages
    A_s (N, NA, NA, B), B_s (N, NA, NU, B): per stage (K, Huu^-1, Hux)."""
    N = A_s.shape[0]
    mm = lambda a, b: prec.ein("ijb,jlb->ilb", a, b)
    mtm = lambda a, b: prec.ein("jib,jlb->ilb", a, b)
    c = lambda a: a[:, :, None]
    Qf = c(k.Qc) + c(k.DxDx) * rho
    V = c(k.Qtc) + c(k.DxDx) * rho
    Rf = c(k.Rc) + c(k.DuDu) * rho
    Mf = c(k.Mc) + c(k.DxDu) * rho
    K_s, Hiv_s, Hux_s = [None] * N, [None] * N, [None] * N
    for i in range(N - 1, -1, -1):
        Ak, Bk = A_s[i], B_s[i]
        VA = mm(V, Ak)
        Huu = Rf + mtm(Bk, mm(V, Bk))
        Hux = Mf.transpose(0, 1) + mtm(Bk, VA)
        Hiv = _inv2(Huu)
        K = -mm(Hiv, Hux)
        K_s[i], Hiv_s[i], Hux_s[i] = K, Hiv, Hux
        Vn = Qf + mtm(Ak, VA) + mtm(Hux, K)
        V = 0.5 * (Vn + Vn.transpose(0, 1))
    return K_s, Hiv_s, Hux_s


def _dual_norm(k: Consts, y, N, prec):
    tx = prec.ein("ci,kcb->kib", k.Dx, y)
    tu = prec.ein("ci,kcb->kib", k.Du, y[:N])
    return torch.maximum(tx.abs().amax(dim=(0, 1)), tu.abs().amax(dim=(0, 1)))


def _residuals(k, N, G, s, lam, sprev, rho, prec):
    red = lambda t: t.abs().amax(dim=(0, 1))
    return (red(G - s), rho * _dual_norm(k, s - sprev, N, prec), red(G), red(s),
            _dual_norm(k, lam, N, prec))


def _groups_done(da):
    B = da.shape[0]
    n_g = -(-B // GROUP)
    done = torch.ones(n_g * GROUP, dtype=torch.bool, device=da.device)
    done[:B] = da >= 0.0
    return done.reshape(n_g, GROUP).all(dim=1).repeat_interleave(GROUP)[:B]


def admm(S: Setup, k: Consts, A_s, B_s, gains, q0, lb, ub, x0a, s, lam, rho, exact_done_at,
         prec: Precision):
    """ADMM from the split s and duals lam with X, U at zero. The
    termination test is recorded after every iteration (``exact_done_at``)
    or at the boundaries of chunks of ``check_termination`` iterations;
    with ``early_exit`` a 128-lane group stops at the first boundary where
    each of its lanes has passed it. Returns the last executed iterate
    (s, lam, X, U, G, s_prev) and each lane's done-at (-1: never)."""
    sv = S.solver
    K_s, Hiv_s, Hux_s = gains
    N, B = A_s.shape[0], x0a.shape[-1]
    sigma, alpha = float(sv["sigma"]), float(sv["alpha"])
    mv = lambda a, x: prec.ein("ijb,jb->ib", a, x)
    mtv = lambda a, x: prec.ein("jib,jb->ib", a, x)
    beta = torch.clamp_max(k.soft, 1e30)[None, :, None]
    hard = torch.isinf(k.soft)[None, :, None]
    rinv = 1.0 / rho
    blend = 1.0 / (beta + rho)

    def iteration(s, lam, X, U):
        v = s - lam * rinv
        qv = q0 - rho * prec.ein("ci,kcb->kib", k.Dx, v) - sigma * X
        rv = -rho * prec.ein("ci,kcb->kib", k.Du, v[:N]) - sigma * U
        vv, d = qv[N], [None] * N
        for i in range(N - 1, -1, -1):
            d[i] = -mv(Hiv_s[i], rv[i] + mtv(B_s[i], vv))
            vv = qv[i] + mtv(A_s[i], vv) + mtv(Hux_s[i], d[i])
        xs, us, x = [x0a], [], x0a
        for i in range(N):
            u = mv(K_s[i], x) + d[i]
            x = mv(A_s[i], x) + mv(B_s[i], u)
            xs.append(x)
            us.append(u)
        Xn, Un = torch.stack(xs), torch.stack(us)
        Gx = prec.ein("ci,kib->kcb", k.Dx, Xn)
        Gu = prec.ein("ci,kib->kcb", k.Du, Un)
        Gn = torch.cat([Gx[:N] + Gu, Gx[N:]], dim=0)
        w = alpha * Gn + (1.0 - alpha) * s
        wl = w + lam * rinv
        clipped = torch.clamp(wl, lb, ub)
        s_new = torch.where(hard, clipped, (beta * clipped + rho * wl) * blend)
        return s_new, lam + rho * (w - s_new), Xn, Un, Gn, s

    def record(st, da, it):
        r_p, r_d, g, sm, dl = _residuals(k, N, st[4], st[0], st[1], st[5], rho, prec)
        conv = ((r_p <= sv["eps_abs"] + sv["eps_rel"] * torch.maximum(g, sm))
                & (r_d <= sv["eps_abs"] + sv["eps_rel"] * dl))
        return torch.where((da < 0.0) & conv, torch.full_like(da, float(it)), da)

    def run(st, da, n, it0, act):
        for j in range(n):
            new = iteration(*st[:4])
            st = new if act is None else tuple(torch.where(act, a, b) for a, b in zip(new, st))
            if exact_done_at:
                da = record(st, da, it0 + j + 1)
        return st, da

    f = _f32(x0a)
    st = (s, lam, torch.zeros((N + 1, NA, B), **f), torch.zeros((N, NU, B), **f),
          torch.zeros((N + 1, NC, B), **f), s)
    da = torch.full((B,), -1.0, **f)
    max_iter, early = int(sv["max_iter"]), bool(sv["early_exit"])
    check = max(1, int(sv["check_termination"]))
    n_chunks, rem = max_iter // check, max_iter % check
    for c in range(n_chunks):
        act = None
        if early:
            act = ~_groups_done(da)
            if not bool(act.any()):
                break
        st, da = run(st, da, check, c * check, act)
        if not exact_done_at:
            da = record(st, da, (c + 1) * check)
    act = ~_groups_done(da) if early else None
    if rem and (act is None or bool(act.any())):
        st, da = run(st, da, rem, n_chunks * check, act)
    return st, da


def tracker_step(S: Setup, pv, kap_at, xref, carry: dict, exact_done_at: bool,
                 prec: Precision) -> dict:
    """One receding-horizon solve from ``carry`` (x (NX, B), X_pred
    (N+1, NX, B), U_pred (N, NU, B), s, lam (N+1, NC, B), u_prev (NU, B),
    rho (B,)) toward ``xref`` (N+1, NX, B). Returns u0, the next carry's
    X_pred, U_pred, s, lam, rho, and r_prim, r_dual, converged, iters
    (the done-at, ``max_iter`` where the test never held)."""
    N, b, sv = S.N, S.bounds, S.solver
    x_now = carry["x"]
    B = x_now.shape[-1]
    f = _f32(x_now)
    k = consts(S, x_now.device)
    rho = carry["rho"]

    Xs = torch.cat([x_now[None], carry["X_pred"][2:], carry["X_pred"][-1:]], dim=0)
    Us = torch.cat([carry["U_pred"][1:], carry["U_pred"][-1:]], dim=0)
    kap = kap_at(Xs[:, S_IDX])                                              # (N+1, B)
    if S.kappa_speed_cap:
        cap = torch.sqrt(S.a_lat_frac * pv["mu"] * pv["g"] / torch.clamp_min(torch.abs(kap), 1e-6))
        cap = torch.clamp(cap, b["vx_min"], b["vx_max"])
    else:
        cap = torch.full((N + 1, B), b["vx_max"], **f)
    lo = torch.tensor([b["vx_min"], -b["ey_max"], -b["delta_max"], b["a_min"], -b["ddelta_max"],
                       -b["da_max"]], **f)
    hi = torch.tensor([b["vx_max"], b["ey_max"], b["delta_max"], b["a_max"], b["ddelta_max"],
                       b["da_max"]], **f)
    lb = lo[None, :, None].expand(N + 1, NC, B).clone()
    ub = hi[None, :, None].expand(N + 1, NC, B).clone()
    ub[:, 0] = cap
    lb[0, :2], ub[0, :2] = -math.inf, math.inf
    lb[N, 2:], ub[N, 2:] = -math.inf, math.inf

    A_c, B_c = lpv_ab(Xs[:N].permute(1, 0, 2), Us.permute(1, 0, 2), kap[:N], pv, S.tire)
    Aa, Ba = discretize_aug(A_c, B_c, S.dt, prec)
    A_s, B_s = Aa.permute(2, 0, 1, 3), Ba.permute(2, 0, 1, 3)              # (N, NA, ., B)
    xr = xref.clone()
    xr[:, 0] = torch.minimum(xr[:, 0], ub[:, 0])
    q0 = torch.cat([-(k.qw[None, :, None] * xr), torch.zeros((N + 1, NU, B), **f)], dim=1)

    s = torch.clamp(torch.cat([carry["s"][1:], carry["s"][-1:]], dim=0), lb, ub)
    lam = torch.cat([carry["lam"][1:], carry["lam"][-1:]], dim=0)
    gains = riccati_factor(k, A_s, B_s, rho, prec)
    x0a = torch.cat([x_now, carry["u_prev"]], dim=0)
    (s_f, lam_f, X, U, G, sprev), da = admm(S, k, A_s, B_s, gains, q0, lb, ub, x0a, s, lam, rho,
                                            exact_done_at, prec)

    r_prim, r_dual, g_max, s_max, d_lam = _residuals(k, N, G, s_f, lam_f, sprev, rho, prec)
    eps_p = sv["eps_abs"] + sv["eps_rel"] * torch.maximum(g_max, s_max)
    eps_d = sv["eps_abs"] + sv["eps_rel"] * d_lam
    converged = (r_prim <= eps_p) & (r_dual <= eps_d)
    ratio = torch.sqrt((r_prim / torch.clamp_min(eps_p, 1e-12))
                       / torch.clamp_min(r_dual / torch.clamp_min(eps_d, 1e-12), 1e-12))
    rho_new = torch.clamp(rho * ratio, RHO_MIN, RHO_MAX)
    rho_next = torch.where((ratio > RHO_TOL) | (ratio < 1.0 / RHO_TOL), rho_new, rho)
    iters = torch.where(da > 0.0, da, torch.full_like(da, float(sv["max_iter"])))

    usable = converged | ((r_prim < sv["eps_fallback"]) & (r_dual < sv["eps_fallback"]))
    delta_ff = (torch.atan(kap_at(x_now[S_IDX]) * (pv["lf"] + pv["lr"]))
                - 0.5 * x_now[EY_IDX] * torch.sign(x_now[0]))
    delta_ff = torch.clamp(delta_ff, -b["delta_max"], b["delta_max"])
    a_fb = torch.where(x_now[0] > 2.0 * b["vx_min"], torch.full_like(rho, -0.5), torch.zeros_like(rho))
    return {"u0": torch.where(usable, U[0], torch.stack([delta_ff, a_fb])),
            "X_pred": torch.where(usable, X[:, :NX], Xs), "U_pred": torch.where(usable, U, Us),
            "s": s_f, "lam": lam_f, "rho": rho_next, "r_prim": r_prim, "r_dual": r_dual,
            "converged": converged, "iters": iters}


def closed_loop_step(S: Setup, pv, kap_at, xref, carry: dict, exact_done_at: bool,
                     prec: Precision) -> dict:
    """:func:`tracker_step` and then the plant over one control period:
    the outputs with the next state ``x``."""
    out = tracker_step(S, pv, kap_at, xref, carry, exact_done_at, prec)
    out["x"] = plant(S, pv, kap_at, carry["x"], out["u0"])
    return out


# ---- the comparison that decides ``correct`` ----

CARRY_KEYS = ("x", "X_pred", "U_pred", "s", "lam", "u_prev", "rho")


def track(config: dict, device) -> dict:
    """The configuration's track table (``reference.track``)."""
    return track_table(config["track"], float(config["track_ds"]), device)


def init_gap(program_carry: dict, ref_carry: dict) -> float:
    return max(float((program_carry[k] - ref_carry[k]).abs().max()) for k in CARRY_KEYS)


def _usable(S, o):
    fb = float(S.solver["eps_fallback"])
    return o["converged"].to(torch.bool) | ((o["r_prim"] < fb) & (o["r_dual"] < fb))


def step_gaps(S, prog: dict, want: dict) -> dict:
    """The numbers of one sampled step over its lanes (whole 128-lane
    groups): ``prog`` the program's outputs, ``want`` the reference's."""
    n = prog["u0"].shape[-1]
    g = n // GROUP
    grp = lambda t: t.reshape(t.shape[:-1] + (g, GROUP))
    exit_p = grp(prog["iters"]).amax(dim=-1)
    exit_r = grp(want["iters"]).amax(dim=-1)
    same_branch = grp(_usable(S, prog) == _usable(S, want)).all(dim=-1)
    agree = (exit_p == exit_r) & same_branch                                   # (g,)
    keep = agree.repeat_interleave(GROUP)
    split = float((prog["iters"] != want["iters"]).float().mean())
    if not bool(keep.any()):
        return {"groups_split": 1.0, "n_compared": 0, "doneat_split": split}
    d = lambda k: (prog[k] - want[k]).abs()[..., keep]
    du0 = d("u0").amax(dim=0)
    return {"groups_split": float(1.0 - agree.float().mean()), "n_compared": int(keep.sum()),
            "doneat_split": split,
            "du0": du0, "x_max": float(d("x").max()),
            "pred_max": max(float(d("X_pred").max()), float(d("U_pred").max())),
            "doneat_gap": float(d("iters").max())}


def reduce(steps: list, init: float) -> dict:
    """The cell's numbers over every sampled step."""
    du0 = [s["du0"] for s in steps if "du0" in s]
    out = {"init_gap": init, "groups_split": max(s["groups_split"] for s in steps),
           "doneat_split": max(s["doneat_split"] for s in steps)}
    if du0:
        du0 = torch.cat(du0).double()
        out.update(u0_p99=float(torch.quantile(du0, 0.99)), u0_max=float(du0.max()),
                   x_max=max(s.get("x_max", 0.0) for s in steps),
                   pred_max=max(s.get("pred_max", 0.0) for s in steps),
                   doneat_gap=max(s.get("doneat_gap", 0.0) for s in steps))
    else:
        out.update(u0_p99=float("inf"), u0_max=float("inf"), x_max=float("inf"),
                   pred_max=float("inf"), doneat_gap=float("inf"))
    out["lane_steps_compared"] = sum(s["n_compared"] for s in steps)
    return out


def compare(ctx, S, table, route, samples, scen, lanes, controls):
    """The cell's numbers over the sampled steps, the reference at float32
    against the program; and for each precision in ``controls``, the same
    numbers with the reference at that precision in the program's place.
    ``info``: the done-at of each sampled 128-lane group's largest, the
    mean over the sampled steps."""
    kap_at = curvature_lookup(table, route.lookup)
    f32 = Precision("f32")
    xref = torch.zeros((S.N + 1, NX, len(lanes)), dtype=torch.float32, device=lanes.device)
    xref[:, 0] = float(ctx.config["vx_ref"])
    steps, init, gmax = [], None, []
    ctl_steps = {c: [] for c in controls}
    for prev, state, sweep in samples:
        pv = vehicle_rows(S, scen[sweep].mu.index_select(0, lanes))
        carry = check.take(route.carry(prev), lanes)
        if init is None:
            x0 = scen[sweep].x0.index_select(0, lanes).T.contiguous()
            kap_div = curvature_lookup(table, "div")
            want0 = initial_carry(S, pv, kap_div, x0, f32)
            init = init_gap(carry, want0)
            ctl_init = {c: init_gap(initial_carry(S, pv, kap_div, x0, Precision(c)), want0)
                        for c in controls}
        out = route.outputs(state)
        it = out["iters"]
        if it.numel() % GROUP == 0:
            gmax.append(float(it.reshape(-1, GROUP).amax(dim=1).mean()))
        prog = check.take(out, lanes)
        want = closed_loop_step(S, pv, kap_at, xref, carry, route.exact_done_at, f32)
        steps.append(step_gaps(S, prog, want))
        for c in controls:
            alt = closed_loop_step(S, pv, kap_at, xref, carry, route.exact_done_at, Precision(c))
            ctl_steps[c].append(step_gaps(S, alt, want))
    info = {"group_max_iters": float(np.mean(gmax)) if gmax else float("nan")}
    return reduce(steps, init), {c: reduce(v, ctl_init[c]) for c, v in ctl_steps.items()}, info

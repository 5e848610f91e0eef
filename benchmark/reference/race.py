"""Plain reference of the composed race step, batch-LAST, float32 with TF32
off: the benchmark's frozen copy of its semantics. It imports nothing of
the program and takes nothing the program made but the carries and the
outputs it judges.

One step, per lane (Alcala, Puig, Quevedo, Rosolia, "Autonomous racing
using LPV-MPC", Control Eng. Practice 95, 2020: the tracker; Alcala, Puig,
Quevedo, "LPV-MP planning for autonomous racing vehicles considering
obstacles", Robotics and Autonomous Systems 124, 2020: the pipeline around
it):

1. measurement: the world-frame pose (X, Y, psi) to Frenet (s, e_y,
   e_psi) by the nearest centerline node among the cells within
   +-``window`` of the cell of the filter's s (ties to the smallest cell
   id), the tangent projection, e_psi against the node's heading advanced
   by the cell's curvature, the lap unwrapped toward the filter's s; the
   speeds pass through; plus the step's sensor noise -> z;
2. EKF at mu-hat: ``n_sub_ekf`` Euler sub-steps of the Frenet dynamic
   bicycle at the controller's tyres, its Jacobian by forward differences
   of step ``fd_eps``, F the product of (I + h J) over the sub-steps,
   P- = F P F' + diag(q), optional per-channel innovation gating, the
   innovation covariance inverted by Gauss-Jordan without pivoting,
   K = P- S^-1, x+ = x- + K (z - x-), P+ = sym((I - K) P-);
3. friction RLS: the axle forces inverted from the filtered state at the
   midpoint of the last and the new estimate, two scalar updates (front,
   then rear) of mu-hat with the magic formula's analytic dFy/dmu, each
   taken only where |dFy/dmu| >= ``min_sensitivity`` fz, mu-hat clipped
   to ``mu_clip``; the result is the next step's mu-hat;
4. references: the shared reference table sampled along the shifted
   schedule (row 0 at the filtered s, row k at X_pred[min(k + 1, N)]'s),
   vx, e_y and the e_psi node channel (the table's heading, a +-``probe``
   central difference evaluated at the nodes) by linear interpolation;
5. the tracker of ``reference/tracker.py`` (``tracker_step``) from the
   filtered state, at the previous step's mu-hat, with Pacejka secant
   stiffnesses;
6. ``n_sub`` Euler sub-steps of the world-frame dynamic bicycle at the
   lane's true mu and the plant's tyres.

Departures from the papers, all of them the deployment's: the friction
estimate is an RLS on the magic formula (the papers take mu as known); the
state estimate is an EKF on the Frenet model with a forward-difference
Jacobian (the papers assume a full-state measurement); the measurement is
a nearest-node search in a window (the papers' car reads its Frenet state
from the track map); the reference is a table sampled along the schedule
(the planner's output, flat here: the table the lap learner starts from).

The comparison that decides ``correct`` (the interface in
``reference/__init__.py``) holds each section from the program's own
inputs to it: the measurement from the carry's world pose and the step's
noise, the EKF from the program's z, the RLS from the program's filtered
state, the tracker from the program's filtered state and the carry's
mu-hat, the plant from the program's u0, so that each number holds one
section, as the tracker's cells hold the tracker from the program's
carry. Its numbers:

- ``init_gap``: the first sweep's initial carry, max |program -
  reference| over the sampled lanes: the world pose from the Frenet start,
  the filter's start and the tracker's (its Euler rollout at mu0);
- ``z_max``: the measurement, max |z program - reference|;
- ``ekx_max``, ``ekP_max``: the EKF's mean (with the RLS's copy of it) and
  covariance;
- ``rls_max``: mu-hat and its RLS covariance, over the lanes whose
  excitation gate no rounding can flip (``rls_at_gate``, in ``info``, the
  lane-steps left out: their |dFy/dmu| within ``GATE_BAND`` fz of the
  gate);
- ``groups_split``, ``doneat_split``, ``u0_p99``, ``u0_max``,
  ``pred_max``: the tracker's (``reference/tracker.py``);
- ``xg_max``: the next world-frame state.

The control (``controls``): the same step with every product of small
matrices at TF32 (``tracker.Precision``) and the results of the sections
that hold none (the world pose, the measurement, the RLS, each plant
sub-step) rounded to bfloat16, as the tracker's control rounds its
rollout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import check
from benchmark.reference import tracker as trk
from benchmark.reference.track import SEGMENTS, curvature_lookup, track_table

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NX = trk.NX
S_IDX = trk.S_IDX
GROUP = trk.GROUP
GATE_BAND = 1e-4       # |dFy/dmu| this close to the RLS gate (in fz) may flip on rounding
CARRY_KEYS = ("xg", "ekx", "ekP", "fr", "x_prev_f") + tuple(k for k in trk.CARRY_KEYS if k != "x")


class Setup(NamedTuple):
    """The numbers of one configuration that the step needs."""

    core: trk.Setup           # the tracker's, and the plant's sub-steps and tyres
    mu0: float                # the controller's friction seed
    sigma: tuple              # sensor noise (the EKF's R is its square)
    ekf_q: tuple
    ekf_p0: float
    n_sub_ekf: int
    fd_eps: float
    rls_p0: float
    forgetting: float
    min_sensitivity: float
    gate_sigma: float
    mu_clip: tuple
    window_m: float
    track_ds: float
    table_ds: float
    table_vx: float
    epsi_probe: float


def setup_from_config(cfg: dict) -> Setup:
    r = cfg["race"]
    return Setup(core=trk.setup_from_config(cfg), mu0=float(r["mu0"]), sigma=tuple(r["sigma"]),
                 ekf_q=tuple(r["ekf_q"]), ekf_p0=float(r["ekf_p0"]), n_sub_ekf=int(r["n_sub_ekf"]),
                 fd_eps=float(r["ekf_fd_eps"]), rls_p0=float(r["rls_p0"]),
                 forgetting=float(r["forgetting"]), min_sensitivity=float(r["min_sensitivity"]),
                 gate_sigma=float(r["gate_sigma"]), mu_clip=tuple(float(v) for v in r["mu_clip"]),
                 window_m=float(r["window_m"]), track_ds=float(cfg["track_ds"]),
                 table_ds=float(r["table_ds"]),
                 table_vx=float(r["table_vx"]), epsi_probe=float(r["epsi_probe"]))


# ---- the tables: the centerline's pose and the reference table ----

def centerline_pose(name: str, ds: float):
    """(X, Y, psi) float64 of the named track's centerline at the n + 1
    uniform nodes s = i L / n: each segment's exact arc (or line) in whole
    cells, then the nodes laid on the uniform grid by linear interpolation
    (the segments' cells are not all of one length)."""
    segments = [(float(L), float(k)) for L, k in SEGMENTS[name]]
    total = sum(L for L, _ in segments)
    cells = [max(1, int(round(L / ds))) for L, _ in segments]
    n = sum(cells)
    X, Y, psi = np.empty(n + 1), np.empty(n + 1), np.empty(n + 1)
    X[0] = Y[0] = psi[0] = 0.0
    i = 0
    for (L, k), nc in zip(segments, cells):
        d = L / nc
        for _ in range(nc):
            if abs(k) < 1e-12:
                X[i + 1] = X[i] + d * np.cos(psi[i])
                Y[i + 1] = Y[i] + d * np.sin(psi[i])
                psi[i + 1] = psi[i]
            else:
                psi[i + 1] = psi[i] + k * d
                X[i + 1] = X[i] + (np.sin(psi[i + 1]) - np.sin(psi[i])) / k
                Y[i + 1] = Y[i] - (np.cos(psi[i + 1]) - np.cos(psi[i])) / k
            i += 1
    s_nodes = np.concatenate([[0.0], np.cumsum(np.concatenate([[L / nc] * nc for (L, _), nc
                                                                in zip(segments, cells)]))])
    s_uni = np.linspace(0.0, total, n + 1)
    return tuple(np.interp(s_uni, s_nodes, a) for a in (X, Y, psi))


def _lookup(ch, tlen, tds, s):
    """Linear interpolation of a uniform table channel ``ch`` (n,) at s."""
    n = ch.shape[0]
    sm = s - tlen * torch.floor(s / tlen)
    f = sm / tds
    i0 = torch.clamp(f.to(torch.int32), 0, n - 1).long()
    t = f - i0.to(torch.float32)
    return ch[i0] * (1.0 - t) + ch[torch.remainder(i0 + 1, n)] * t


def track(config: dict, device) -> dict:
    """The track table (``reference.track``: ``kappa``, ``length``, ``ds``),
    with the centerline's node poses ``X``, ``Y``, ``psi`` (n + 1,) and the
    flat reference table of the configuration: ``ref_vx``, ``ref_ey``,
    ``ref_epsi`` (its nodes), ``ref_length``, ``ref_ds``."""
    S = setup_from_config(config)
    ds = float(config["track_ds"])
    t = track_table(config["track"], ds, device)
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    t.update(zip(("X", "Y", "psi"), (f32(a) for a in centerline_pose(config["track"], ds))))
    # the table over the lap's float32 length, of at least 8 nodes
    L = float(t["length"])
    n = max(int(round(L / S.table_ds)), 8)
    t["ref_length"], t["ref_ds"] = f32(L), f32(L / n)
    t["ref_vx"] = torch.full((n,), S.table_vx, dtype=torch.float32, device=device)
    t["ref_ey"] = torch.zeros((n,), dtype=torch.float32, device=device)
    s_nodes = torch.arange(n, dtype=torch.float32, device=device) * t["ref_ds"]
    look = lambda s: _lookup(t["ref_ey"], t["ref_length"], t["ref_ds"], s)
    ep = torch.atan2(look(s_nodes + S.epsi_probe) - look(s_nodes - S.epsi_probe),
                     torch.full_like(s_nodes, 2.0 * S.epsi_probe))
    t["ref_epsi"] = torch.where(torch.abs(ep) > 0.3, torch.zeros_like(ep), ep)   # a seam, not a heading
    return t


# ---- the sections ----

def _low(x, prec: trk.Precision):
    """A result of a section without matrix products: float32, or for the
    control rounded to bfloat16."""
    return x.to(torch.bfloat16).to(torch.float32) if prec.mode == "tf32" else x


def _wrap(s, length):
    return s - length * torch.floor(s / length)


def _aux(T):
    """The track's length and 1 / ds as the kernel is handed them."""
    return T["length"], (1.0 / T["ds"]).to(torch.float32)


def pose_from_frenet(T, s, ey, epsi):
    """World pose of (s, e_y, e_psi): the centerline pose interpolated
    between the nodes of s's cell (``floor(wrap(s) / ds)``), offset by e_y
    along its normal."""
    n = T["kappa"].shape[0]
    f = _wrap(s, T["length"]) / T["ds"]
    i0 = torch.clamp(f.to(torch.int32), 0, n - 1).long()
    t = f - i0.to(torch.float32)
    lerp = lambda a: a[i0] * (1.0 - t) + a[i0 + 1] * t
    Xc, Yc, pc = lerp(T["X"]), lerp(T["Y"]), lerp(T["psi"])
    return Xc - ey * torch.sin(pc), Yc + ey * torch.cos(pc), pc + epsi


def window_cells(S: Setup, T) -> int:
    return max(2, int(S.window_m / float(T["ds"])))


def measure(S: Setup, T, kap_at, xg, s_hint):
    """Section 1 without the noise: z (NX, B) of the world state xg (NX, B)."""
    length, inv_ds = _aux(T)
    ds = (1.0 / inv_ds).to(torch.float32)
    n, W = T["kappa"].shape[0], window_cells(S, T)
    dev = xg.device
    i_hint = torch.clamp((_wrap(s_hint, length) * inv_ds).to(torch.int32), 0, n - 1).long()
    if 2 * W + 1 >= n:
        cand = torch.arange(n, device=dev)[:, None].expand(n, xg.shape[-1])
    else:
        cand = torch.remainder(i_hint[None] + torch.arange(-W, W + 1, device=dev)[:, None], n)
    Xt, Yt, Pt = T["X"][:n], T["Y"][:n], T["psi"][:n]
    d2 = (xg[3][None] - Xt[cand]) ** 2 + (xg[4][None] - Yt[cand]) ** 2
    i_star = torch.where(d2 <= d2.amin(dim=0)[None], cand, torch.full_like(cand, n)).amin(dim=0)
    Pi = Pt[i_star]
    tx, ty = torch.cos(Pi), torch.sin(Pi)
    ddx, ddy = xg[3] - Xt[i_star], xg[4] - Yt[i_star]
    along = ddx * tx + ddy * ty
    e_y = -ddx * ty + ddy * tx
    s_w = _wrap(i_star.to(torch.float32) * ds + along, length)
    dpsi = xg[5] - (Pi + kap_at(s_w) * along)
    e_psi = torch.atan2(torch.sin(dpsi), torch.cos(dpsi))
    s_unw = s_w + torch.floor((s_hint - s_w) / length + 0.5) * length
    return torch.stack([xg[0], xg[1], xg[2], e_psi, s_unw, e_y])


def _inv_gj(M):
    """(6, 6, B) inverse by Gauss-Jordan without pivoting (an innovation
    covariance: positive diagonal)."""
    nx = M.shape[0]
    Inv = torch.eye(nx, dtype=M.dtype, device=M.device)[:, :, None].expand_as(M)
    for j in range(nx):
        rec = 1.0 / M[j, j]
        Mj, Ij = M[j] * rec, Inv[j] * rec
        fac = M[:, j][:, None, :]
        Mn, In = M - fac * Mj[None], Inv - fac * Ij[None]
        M = torch.cat([Mn[:j], Mj[None], Mn[j + 1:]])
        Inv = torch.cat([In[:j], Ij[None], In[j + 1:]])
    return Inv


def ekf(S: Setup, pv, kap_at, x, P, u_prev, z, prec: trk.Precision):
    """Section 2: (x+, P+) from the carry's mean x (NX, B) and covariance
    P (NX, NX, B), the last control u_prev and the measurement z."""
    dt, tire = S.core.dt, S.core.tire
    B = x.shape[-1]
    mm = lambda a, b: prec.ein("ijb,jlb->ilb", a, b)
    eye = torch.eye(NX, dtype=torch.float32, device=x.device)[:, :, None]
    h = dt / S.n_sub_ekf
    inv_eps = 1.0 / S.fd_eps
    F = eye.expand(NX, NX, B)
    for _ in range(S.n_sub_ekf):
        kap = kap_at(x[S_IDX])
        fx = trk.f_plant(pv, x, u_prev, kap, tire)
        cols = []
        for j in range(NX):
            xp = x.clone()
            xp[j] = xp[j] + S.fd_eps
            cols.append((trk.f_plant(pv, xp, u_prev, kap, tire) - fx) * inv_eps)
        F = mm(eye + h * torch.stack(cols, dim=1), F)
        x = x + h * fx
    q = torch.tensor(S.ekf_q, dtype=torch.float32, device=x.device)
    r = torch.tensor(S.sigma, dtype=torch.float32, device=x.device) ** 2
    Pp = mm(F, prec.ein("ijb,ljb->ilb", P, F)) + eye * q[:, None, None]
    nu = z - x
    Rd = r[:, None].expand(NX, B)
    if S.gate_sigma > 0.0:
        s0 = torch.diagonal(Pp, dim1=0, dim2=1).T + Rd
        Rd = Rd + torch.where(torch.abs(nu) > S.gate_sigma * torch.sqrt(s0), 1e6 * s0, torch.zeros_like(s0))
    K = mm(Pp, _inv_gj(Pp + eye * Rd[:, None, :]))
    xf = x + prec.ein("ijb,jb->ib", K, nu)
    Pn = mm(eye - K, Pp)
    return xf, 0.5 * (Pn + Pn.transpose(0, 1))


def _mu_sensitivity(mu, alpha, stiff, fz):
    """(Fy, dFy/dmu) of Fy = mu fz sin(C atan(B alpha)), B = stiff / (C mu fz)."""
    D = torch.clamp_min(mu * fz, 1e-6)
    t = stiff / (trk.PACEJKA_C * D) * alpha
    th = trk.PACEJKA_C * torch.atan(t)
    return mu * fz * torch.sin(th), fz * (torch.sin(th) - torch.cos(th) * trk.PACEJKA_C * t / (1.0 + t * t))


def rls(S: Setup, pv, x_prev, xf, u_prev, fr):
    """Section 3: the next [mu-hat, P] (2, B) from the last and the new
    filtered state, and the lanes whose gate sits within ``GATE_BAND``."""
    dt = S.core.dt
    vx, vy, wz = (0.5 * (x_prev[i] + xf[i]) for i in range(3))
    delta = u_prev[0]
    m, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    y1 = m * ((xf[1] - x_prev[1]) / dt + wz * vx)
    y2 = Iz * ((xf[2] - x_prev[2]) / dt)
    L = lf + lr
    cd = torch.cos(delta)
    cd = torch.where(torch.abs(cd) < 0.1, torch.full_like(cd, 0.1), cd)
    vxs = torch.clamp_min(vx, trk.VX_EPS)
    mu, Pr = fr[0], fr[1]
    near = torch.zeros_like(mu, dtype=torch.bool)
    for y_m, alpha, stiff, fz in (
        ((lr * y1 + y2) / (L * cd), delta - torch.atan2(vy + lf * wz, vxs), pv["Cf"], m * pv["g"] * lr / L),
        ((lf * y1 - y2) / L, -torch.atan2(vy - lr * wz, vxs), pv["Cr"], m * pv["g"] * lf / L),
    ):
        fy, J = _mu_sensitivity(mu, alpha, stiff, fz)
        margin = torch.abs(J) - S.min_sensitivity * fz
        near |= torch.abs(margin) < GATE_BAND * fz
        K = Pr * J / (S.forgetting + J * Pr * J)
        mu2 = torch.clamp(mu + K * (y_m - fy), *S.mu_clip)
        P2 = (Pr - K * J * Pr) / S.forgetting
        gate = margin >= 0.0
        mu, Pr = torch.where(gate, mu2, mu), torch.where(gate, P2, Pr)
    return torch.stack([mu, Pr]), near


def table_refs(S: Setup, T, s0, X_pred):
    """Section 4: the (N+1, NX, B) reference rows along the shifted
    schedule, row 0 at s0."""
    s_k = torch.cat([s0[None], X_pred[2:, S_IDX], X_pred[-1:, S_IDX]], dim=0)
    inv = (1.0 / T["ref_ds"]).to(torch.float32)
    n = T["ref_vx"].shape[0]
    ff = _wrap(s_k, T["ref_length"]) * inv
    i0 = torch.clamp(ff.to(torch.int32), 0, n - 1).long()
    i1 = torch.remainder(i0 + 1, n)
    t = ff - i0.to(torch.float32)
    at = lambda a: a[i0] * (1.0 - t) + a[i1] * t
    z = torch.zeros_like(t)
    return torch.stack([at(T["ref_vx"]), z, z, at(T["ref_epsi"]), z, at(T["ref_ey"])], dim=1)


def f_world(pv, xg, u, tire):
    """The world-frame dynamic bicycle dxg/dt, xg = (vx, vy, wz, X, Y, psi)."""
    vx, vy, wz, psi = xg[0], xg[1], xg[2], xg[5]
    delta, a = u[0], u[1]
    m, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
    vxs = torch.clamp_min(vx, trk.VX_EPS)
    alpha_f = delta - torch.atan2(vy + lf * wz, vxs)
    alpha_r = -torch.atan2(vy - lr * wz, vxs)
    L = lf + lr
    fzf, fzr = pv["mu"] * m * pv["g"] * lr / L, pv["mu"] * m * pv["g"] * lf / L
    if tire == "pacejka":
        C = trk.PACEJKA_C
        fyf = fzf * torch.sin(C * torch.atan(pv["Cf"] / (C * torch.clamp_min(fzf, 1e-6)) * alpha_f))
        fyr = fzr * torch.sin(C * torch.atan(pv["Cr"] / (C * torch.clamp_min(fzr, 1e-6)) * alpha_r))
    else:
        fyf, fyr = pv["Cf"] * alpha_f, pv["Cr"] * alpha_r
    sd, cd = torch.sin(delta), torch.cos(delta)
    sp, cp = torch.sin(psi), torch.cos(psi)
    return torch.stack([a - fyf * sd / m + wz * vy - (pv["cd0"] + pv["cd1"] * vx) / m,
                        (fyf * cd + fyr) / m - wz * vx, (lf * fyf * cd - lr * fyr) / Iz,
                        vx * cp - vy * sp, vx * sp + vy * cp, wz])


def world_plant(S: Setup, pv, xg, u, prec: trk.Precision):
    """Section 6: ``n_sub`` Euler sub-steps of the world-frame plant."""
    h = S.core.dt / S.core.n_sub
    for _ in range(S.core.n_sub):
        xg = _low(xg + h * f_world(pv, xg, u, S.core.sim_tire), prec)
    return xg


def initial_carry(S: Setup, T, x0, prec: trk.Precision) -> dict:
    """The carry of a sweep's start from Frenet states x0 (NX, B): the
    world pose of (s, e_y, e_psi), the speeds as they are; the filter at
    x0 with P = ``ekf_p0`` I; mu-hat ``mu0`` with P ``rls_p0``; the
    tracker's start at mu0 (``tracker.initial_carry``)."""
    B = x0.shape[-1]
    f32 = dict(dtype=torch.float32, device=x0.device)
    pv0 = trk.vehicle_rows(S.core, torch.full((B,), S.mu0, **f32))
    c = trk.initial_carry(S.core, pv0, curvature_lookup(T, "div"), x0, prec)
    Xw, Yw, pw = pose_from_frenet(T, x0[S_IDX], x0[trk.EY_IDX], x0[3])
    c.pop("x")
    c.update(xg=_low(torch.stack([x0[0], x0[1], x0[2], Xw, Yw, pw]), prec), ekx=x0, x_prev_f=x0,
             ekP=(S.ekf_p0 * torch.eye(NX, **f32))[:, :, None].expand(NX, NX, B).contiguous(),
             fr=torch.stack([torch.full((B,), S.mu0, **f32), torch.full((B,), S.rls_p0, **f32)]))
    return c


def race_step(S: Setup, T, kap_at, carry: dict, prog: dict, mu_true, prec: trk.Precision) -> dict:
    """Each section of one step from the program's own inputs to it
    (``carry``: the program's carry before the step; ``prog``: its outputs:
    the noise drawn, z, the filtered state ``ekx``, u0), as the program's
    outputs are named; ``near_gate``: the lanes whose RLS gate rounding may
    flip."""
    pv_hat = trk.vehicle_rows(S.core, carry["fr"][0])
    z = _low(measure(S, T, kap_at, carry["xg"], carry["ekx"][S_IDX]) + prog["noise"], prec)
    ekx, ekP = ekf(S, pv_hat, kap_at, carry["ekx"], carry["ekP"], carry["u_prev"], prog["z"], prec)
    fr, near = rls(S, pv_hat, carry["x_prev_f"], prog["ekx"], carry["u_prev"], carry["fr"])
    xref = table_refs(S, T, prog["ekx"][S_IDX], carry["X_pred"])
    tc = dict(carry, x=prog["ekx"])
    out = trk.tracker_step(S.core, pv_hat, kap_at, xref, tc, False, prec)
    pv_true = trk.vehicle_rows(S.core, mu_true)
    out.update(z=z, ekx=ekx, x_prev_f=ekx, ekP=ekP, fr=_low(fr, prec), near_gate=near,
               xg=world_plant(S, pv_true, carry["xg"], prog["u0"], prec))
    return out


# ---- the comparison that decides ``correct`` ----

def init_gap(program_carry: dict, ref_carry: dict) -> float:
    return max(float((program_carry[k] - ref_carry[k]).abs().max()) for k in CARRY_KEYS)


def _usable(S: Setup, o):
    fb = float(S.core.solver["eps_fallback"])
    return o["converged"].to(torch.bool) | ((o["r_prim"] < fb) & (o["r_dual"] < fb))


def step_gaps(S: Setup, prog: dict, want: dict) -> dict:
    """The numbers of one sampled step over its lanes (whole 128-lane
    groups): ``prog`` the program's outputs (or the control's), ``want``
    the reference's."""
    d = lambda k, m=None: (prog[k] - want[k]).abs() if m is None else (prog[k] - want[k]).abs()[..., m]
    off_gate = ~want["near_gate"]
    out = {"z_max": float(d("z").max()),
           "ekx_max": max(float(d("ekx").max()), float(d("x_prev_f").max())),
           "ekP_max": float(d("ekP").max()),
           "rls_max": float(d("fr", off_gate).max()) if bool(off_gate.any()) else 0.0,
           "xg_max": float(d("xg").max()), "at_gate": int(want["near_gate"].sum())}
    n = prog["u0"].shape[-1]
    g = n // GROUP
    grp = lambda t: t.reshape(t.shape[:-1] + (g, GROUP))
    agree = ((grp(prog["iters"]).amax(dim=-1) == grp(want["iters"]).amax(dim=-1))
             & grp(_usable(S, prog) == _usable(S, want)).all(dim=-1))
    keep = agree.repeat_interleave(GROUP)
    out["doneat_split"] = float((prog["iters"] != want["iters"]).float().mean())
    out["groups_split"] = float(1.0 - agree.float().mean())
    out["n_compared"] = int(keep.sum())
    if bool(keep.any()):
        out.update(du0=d("u0", keep).amax(dim=0),
                   pred_max=max(float(d("X_pred", keep).max()), float(d("U_pred", keep).max())),
                   doneat_gap=float(d("iters", keep).max()))
    return out


SECTION_KEYS = ("z_max", "ekx_max", "ekP_max", "rls_max", "xg_max")


def reduce(steps: list, init: float) -> dict:
    """The cell's numbers over every sampled step."""
    out = {"init_gap": init, "groups_split": max(s["groups_split"] for s in steps),
           "doneat_split": max(s["doneat_split"] for s in steps)}
    out.update({k: max(s[k] for s in steps) for k in SECTION_KEYS})
    du0 = [s["du0"] for s in steps if "du0" in s]
    if du0:
        du0 = torch.cat(du0).double()
        out.update(u0_p99=float(torch.quantile(du0, 0.99)), u0_max=float(du0.max()),
                   pred_max=max(s.get("pred_max", 0.0) for s in steps),
                   doneat_gap=max(s.get("doneat_gap", 0.0) for s in steps))
    else:
        out.update(u0_p99=math.inf, u0_max=math.inf, pred_max=math.inf, doneat_gap=math.inf)
    out["lane_steps_compared"] = sum(s["n_compared"] for s in steps)
    return out


def compare(ctx, S, table, route, samples, scen, lanes, controls):
    """The cell's numbers over the sampled steps, the reference at float32
    against the program; for each precision in ``controls`` the same
    numbers with the reference at that precision in the program's place.
    ``info``: the lane-steps left out of ``rls_max`` at the gate, and the
    done-at of each sampled 128-lane group's largest, the mean over the
    sampled steps."""
    kap_at = curvature_lookup(table, route.lookup)
    f32 = trk.Precision("f32")
    steps, init, ctl_init, gmax = [], None, {}, []
    ctl_steps = {c: [] for c in controls}
    for prev, state, sweep in samples:
        mu_true = scen[sweep].mu.index_select(0, lanes).to(torch.float32)
        carry = check.take(route.carry(prev), lanes)
        if init is None:
            x0 = scen[sweep].x0.index_select(0, lanes).T.contiguous()
            want0 = initial_carry(S, table, x0, f32)
            init = init_gap(carry, want0)
            ctl_init = {c: init_gap(initial_carry(S, table, x0, trk.Precision(c)), want0) for c in controls}
        out = route.outputs(state)
        it = out["iters"]
        if it.numel() % GROUP == 0:
            gmax.append(float(it.reshape(-1, GROUP).amax(dim=1).mean()))
        prog = check.take(out, lanes)
        want = race_step(S, table, kap_at, carry, prog, mu_true, f32)
        steps.append(step_gaps(S, prog, want))
        for c in controls:
            alt = race_step(S, table, kap_at, carry, prog, mu_true, trk.Precision(c))
            ctl_steps[c].append(step_gaps(S, alt, want))
    info = {"rls_at_gate": sum(s["at_gate"] for s in steps),
            "group_max_iters": float(np.mean(gmax)) if gmax else float("nan")}
    return reduce(steps, init), {c: reduce(v, ctl_init[c]) for c, v in ctl_steps.items()}, info

"""Racestep: the composed deployment step for every lane in one kernel
launch (kernel 3; CUDA source ``csrc/racestep_kernel.cu``).

Replaces the JAX package's ``ops/racestep_kernel.py::_racestep_kernel``
(Pallas, launched by ``racestep``). Per lane, in order:

    1 measurement: hint-windowed global -> Frenet (nearest centerline node
      within +-``win_cells`` of the EKF's s, ties to the smallest cell id;
      tangent projection; lap unwrap) + pre-scaled sensor noise
    2 EKF at mu-hat: ``n_sub_ekf`` Euler sub-steps of the Frenet model, a
      forward-difference Jacobian, optional per-channel innovation gating,
      the 6x6 innovation inverse by unpivoted Gauss-Jordan
    3 friction RLS: axle-force inversion, two excitation-gated scalar
      updates with the analytic dFy/dmu (the result is the NEXT step's
      mu-hat; the EKF and the tracker run at the previous one)
    4 references: a :class:`RefTable` sampled along the shifted schedule
      (vx, e_y and a precomputed e_psi node channel, linear interpolation),
      shared by every lane or one per lane (channels (B, n)), or tensor
      references passed through
    5 tracker: the megastep's sections 1-8 (``mpc_core_plain`` / the CUDA
      ``mpc_core_g``) at mu-hat, with an optional (N+1, 2, B) e_y corridor
      ``eyb`` in place of row 1's box (obstacles)
    6 plant: ``n_sub`` Euler sub-steps of the world-frame bicycle at each
      lane's true mu

The XLA-twin composition of the same step is ``loop.race.batched_race_sweep``
(``estimate_frenet`` -> ``ekf_step`` -> ``friction_step`` -> ``mpc_step`` ->
``global_plant_step``); the two differ by the twin's exact Jacobian and
slope probes where the kernel uses forward differences and a node table.

The measurement searches the +-``win_cells`` window that
``track.global_to_frenet_windowed`` claims; the TPU kernel searched a
two-chunk window of +-64 cells, and neither has the dense fallback for a
wrong hint. Dropped TPU layouts: the 128-cell chunked pose tables with a
replicated head, the chunked reference tables, the one-hot fetches and the
windowed curvature lookup — a GPU thread loads the cell it needs.

:func:`racestep_plain` is the plain PyTorch version (batch-last); the
wrapper :func:`racestep` takes it for CPU tensors and launches the kernel
for CUDA tensors.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..planner.reftable import RefTable
from ..track.track import Track, frenet_to_global
from . import _cuda
from .fused_kernel import TIRES, core_floats, core_workspace, launch_shape
from .megastep_kernel import (
    _check_supported,
    _kap_lookup,
    _make_consts,
    megastep_refs,
    mpc_core_plain,
)
from .stage_math import (
    NC,
    NU,
    NX,
    PARAM_ROWS,
    VX_EPS,
    _inv6,
    f_dynamic_bl,
    f_global_bl,
    pacejka_mu_sensitivity,
    unpack_params,
)

MU_MIN, MU_MAX = 0.1, 1.5       # loop/friction.py clip range
FD_EPS = 3e-3                   # forward-difference step of the EKF Jacobian
EPSI_PROBE = 0.15               # refs_from_table's slope probe [m]


class RaceMegaCarry(NamedTuple):
    """Batch-last closed-loop carry of the composed racestep."""

    xg: torch.Tensor        # (6, B) world-frame plant truth
    ekx: torch.Tensor       # (6, B) EKF mean (unwrapped s at row 4)
    ekP: torch.Tensor       # (6, 6, B) EKF covariance
    fr: torch.Tensor        # (2, B): [mu_hat, P_rls]
    x_prev_f: torch.Tensor  # (6, B) previous filtered state (RLS residual)
    X_pred: torch.Tensor    # (N+1, NX, B) tracker warm start
    U_pred: torch.Tensor    # (N, NU, B)
    s: torch.Tensor         # (N+1, NC, B)
    lam: torch.Tensor       # (N+1, NC, B)
    u_prev: torch.Tensor    # (NU, B)
    rho: torch.Tensor       # (B,)


def racestep_init(p: VehicleParams, cfg: MPCConfig, track: Track, x0_b: torch.Tensor,
                  mu0: float, p0_ekf: float = 0.1, p0_rls: float = 0.25) -> RaceMegaCarry:
    """Batch-last composed carry from (B, 6) Frenet initial states."""
    from ..loop.mpc import mpc_init

    x0_b = x0_b.to(torch.float32)
    B = x0_b.shape[0]
    kw = dict(dtype=torch.float32, device=x0_b.device)
    c = mpc_init(p.replace(mu=float(mu0)), cfg, track, x0_b)
    bl = lambda t: t.movedim(0, -1).contiguous()
    Xw, Yw, psiw = frenet_to_global(track, x0_b[:, 4], x0_b[:, 5], x0_b[:, 3])
    return RaceMegaCarry(
        xg=torch.stack([x0_b[:, 0], x0_b[:, 1], x0_b[:, 2], Xw, Yw, psiw]),
        ekx=bl(x0_b),
        ekP=(p0_ekf * torch.eye(6, **kw))[:, :, None].expand(6, 6, B).contiguous(),
        fr=torch.stack([torch.full((B,), mu0, **kw), torch.full((B,), p0_rls, **kw)]),
        x_prev_f=bl(x0_b),
        X_pred=bl(c.X_pred), U_pred=bl(c.U_pred), s=bl(c.s), lam=bl(c.lam),
        u_prev=bl(c.u_prev), rho=c.rho.contiguous(),
    )


def _ref_epsi_nodes(table: RefTable, probe: float = EPSI_PROBE) -> torch.Tensor:
    """The racing line's heading at the table nodes: ``refs_from_table``'s
    +-probe slope (atan, seam guard) evaluated once, so the step samples
    one channel instead of two probes per stage. (n,), or (B, n) for
    per-lane tables, at lane 0's node spacing (the JAX package vmaps this
    over the lanes)."""
    n = table.vx.shape[-1]
    s_nodes = torch.arange(n, dtype=torch.float32, device=table.vx.device) * table.ds.reshape(-1)[0]
    s_nodes = s_nodes.expand(table.vx.shape)
    eyp = table.lookup(s_nodes + probe)[1]
    eym = table.lookup(s_nodes - probe)[1]
    ep = torch.atan2(eyp - eym, torch.full_like(eyp, 2.0 * probe))
    return torch.where(torch.abs(ep) > 0.3, torch.zeros_like(ep), ep)


def _aux(length, ds, device) -> torch.Tensor:
    """[length, 1/ds] of a uniform table, float32; per-lane tables share
    lane 0's grid (one track)."""
    return torch.stack([length.reshape(-1)[0], 1.0 / ds.reshape(-1)[0]]).to(dtype=torch.float32,
                                                                             device=device)


_TABLE_INPUTS = weakref.WeakKeyDictionary()   # RefTable -> {device: inputs}


def _ref_table_inputs(table: RefTable, device):
    """(vx, ey, e_psi nodes, [length, 1/ds]) of a reference table, the
    channels (n,) shared or (B, n) per lane, prepared once per table and
    device (a table is immutable: a new plan is a new RefTable)."""
    per_dev = _TABLE_INPUTS.setdefault(table, {})
    key = torch.device(device)
    if key not in per_dev:
        t = table.to(device)
        per_dev[key] = (t.vx.contiguous(), t.ey.contiguous(), _ref_epsi_nodes(t).contiguous(),
                        _aux(t.length, t.ds, device))
    return per_dev[key]


def _pose_tables(track: Track, device):
    """Centerline node poses X, Y, psi at the n_cells cell starts: the
    candidate set of ``global_to_frenet``."""
    n = track.n_cells
    return tuple(a[:n].to(device=device, dtype=torch.float32).contiguous()
                 for a in (track.X, track.Y, track.psi))


def _check_race_supported(cfg: MPCConfig, scfg: SolverConfig, x_ref, eyb, B: int):
    if cfg.model != "dynamic":
        raise NotImplementedError("the composed step needs the dynamic model")
    if isinstance(x_ref, RefTable) and x_ref.vx.dim() == 2 and x_ref.vx.shape[0] != B:
        raise ValueError(f"racestep: per-lane tables have {x_ref.vx.shape[0]} lanes, the carry {B}")
    if scfg.cache_build:
        raise NotImplementedError("the racestep builds every stage: it has no discretization cache "
                                  "(cache_build is the megastep's)")
    _check_supported(cfg, scfg, None, eyb, B)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] of a shared (n,) channel, or lane b's a[b, i[:, b]] of a
    per-lane (B, n) one; i (K, B)."""
    return a[i] if a.dim() == 1 else torch.gather(a, 1, i.T).T


def _win_cells(track: Track, window_m: float) -> int:
    return max(2, int(window_m / track.ds_host))


def racestep_plain(cfg: MPCConfig, scfg: SolverConfig, track: Track, prm: torch.Tensor, x_ref,
                   carry: RaceMegaCarry, noise: torch.Tensor, mu_true: torch.Tensor, ekf_q, ekf_r,
                   n_sub: int = 10, n_sub_ekf: int = 4, sim_tire: str | None = None,
                   use_ekf: bool = True, adapt_mu: bool = True, gate_sigma: float = 0.0,
                   forgetting: float = 0.995, min_sensitivity: float = 0.05,
                   window_m: float = 3.0, eyb=None):
    """Plain PyTorch version of the racestep kernel (any device).

    Returns (new_carry, u0 (NU, B), diag (6, B): r_prim, r_dual, converged,
    rho_next, iters, mu_hat, z (6, B) the raw measurement)."""
    N, dt = cfg.N, float(cfg.dt)
    dev = carry.xg.device
    f32 = dict(dtype=torch.float32, device=dev)
    B = carry.xg.shape[-1]
    _check_race_supported(cfg, scfg, x_ref, eyb, B)
    pv = unpack_params(prm)
    kap_at = _kap_lookup(track, dev)
    taux = _aux(track.length, track.ds, dev)
    length, inv_ds = taux[0], taux[1]
    ds = 1.0 / inv_ds
    xg, ekx, u_prev = carry.xg, carry.ekx, carry.u_prev
    mu_ctrl = carry.fr[0] if adapt_mu else pv["mu"]
    pv_hat = dict(pv, mu=mu_ctrl)
    I6 = torch.eye(6, **f32)[:, :, None]

    # 1. measurement: nearest node within +-win_cells of the hint cell
    Xt, Yt, Pt = _pose_tables(track, dev)
    n = track.n_cells
    W = _win_cells(track, window_m)
    Xw, Yw, psiw = xg[3], xg[4], xg[5]
    s_hint = ekx[4]
    sm_h = s_hint - length * torch.floor(s_hint / length)
    i_hint = torch.clamp((sm_h * inv_ds).to(torch.int32), 0, n - 1).long()
    if 2 * W + 1 >= n:
        cand = torch.arange(n, device=dev)[:, None].expand(n, B)
    else:
        cand = torch.remainder(i_hint[None] + torch.arange(-W, W + 1, device=dev)[:, None], n)
    d2 = (Xw[None] - Xt[cand]) ** 2 + (Yw[None] - Yt[cand]) ** 2
    m = d2.amin(dim=0)
    i_star = torch.where(d2 <= m[None], cand, torch.full_like(cand, n)).amin(dim=0)
    Xi, Yi, Pi = Xt[i_star], Yt[i_star], Pt[i_star]
    tx, ty = torch.cos(Pi), torch.sin(Pi)
    ddx, ddy = Xw - Xi, Yw - Yi
    along = ddx * tx + ddy * ty
    e_y = -ddx * ty + ddy * tx
    s_raw = i_star.to(torch.float32) * ds + along
    s_w = s_raw - length * torch.floor(s_raw / length)
    dpsi = psiw - (Pi + kap_at(s_w) * along)
    e_psi = torch.atan2(torch.sin(dpsi), torch.cos(dpsi))
    s_unw = s_w + torch.floor((s_hint - s_w) / length + 0.5) * length
    z = torch.stack([xg[0], xg[1], xg[2], e_psi, s_unw, e_y]) + noise

    # 2. EKF at mu-hat
    if use_ekf:
        h = dt / n_sub_ekf
        x_e, F = ekx, I6
        for _ in range(n_sub_ekf):
            kapv = kap_at(x_e[4])
            fx = f_dynamic_bl(pv_hat, x_e, u_prev, kapv, cfg.tire)
            cols = []
            for j in range(NX):
                xp = x_e.clone()
                xp[j] = xp[j] + FD_EPS
                cols.append((f_dynamic_bl(pv_hat, xp, u_prev, kapv, cfg.tire) - fx) * (1.0 / FD_EPS))
            J = torch.stack(cols, dim=1)
            F = torch.einsum("ijb,jlb->ilb", I6 + h * J, F)
            x_e = x_e + h * fx
        q = torch.as_tensor(ekf_q, **f32).reshape(6)
        r = torch.as_tensor(ekf_r, **f32).reshape(6)
        Pp = torch.einsum("ijb,jlb->ilb", F, torch.einsum("ijb,ljb->ilb", carry.ekP, F))
        Pp = Pp + I6 * q[:, None, None]
        nu = z - x_e
        Rd = r[:, None].expand(6, B)
        if gate_sigma > 0.0:
            S0d = torch.diagonal(Pp, dim1=0, dim2=1).T + Rd
            Rd = Rd + torch.where(torch.abs(nu) > gate_sigma * torch.sqrt(S0d), 1e6 * S0d,
                                  torch.zeros_like(S0d))
        K = torch.einsum("ijb,jlb->ilb", Pp, _inv6(Pp + I6 * Rd[:, None, :]))
        xf = x_e + torch.einsum("ijb,jb->ib", K, nu)
        Pn = torch.einsum("ijb,jlb->ilb", I6 - K, Pp)
        ekP = 0.5 * (Pn + Pn.transpose(0, 1))
    else:
        xf, ekP = z, carry.ekP

    # 3. friction RLS: the next step's mu-hat
    if adapt_mu:
        xp = carry.x_prev_f
        x_mid = 0.5 * (xp + xf)
        vx, vy, wz = x_mid[0], x_mid[1], x_mid[2]
        delta = u_prev[0]
        m_, Iz, lf, lr = pv["m"], pv["Iz"], pv["lf"], pv["lr"]
        y1 = m_ * ((xf[1] - xp[1]) / dt + wz * vx)
        y2 = Iz * ((xf[2] - xp[2]) / dt)
        L = lf + lr
        cd = torch.cos(delta)
        cdg = torch.where(torch.abs(cd) < 0.1, torch.full_like(cd, 0.1), cd)
        vx_safe = torch.clamp_min(vx, VX_EPS)
        mu, Pr = carry.fr[0], carry.fr[1]
        for y_m, a_x, stiff, fz in (
            ((lr * y1 + y2) / (L * cdg), delta - torch.atan2(vy + lf * wz, vx_safe), pv["Cf"],
             m_ * pv["g"] * lr / L),
            ((lf * y1 - y2) / L, -torch.atan2(vy - lr * wz, vx_safe), pv["Cr"], m_ * pv["g"] * lf / L),
        ):
            hval, Jg = pacejka_mu_sensitivity(mu, a_x, stiff, fz)
            gate = torch.abs(Jg) >= min_sensitivity * fz
            Krls = Pr * Jg / (forgetting + Jg * Pr * Jg)
            mu2 = torch.clamp(mu + Krls * (y_m - hval), MU_MIN, MU_MAX)
            P2 = (Pr - Krls * Jg * Pr) / forgetting
            mu, Pr = torch.where(gate, mu2, mu), torch.where(gate, P2, Pr)
        fr = torch.stack([mu, Pr])
    else:
        mu, fr = carry.fr[0], carry.fr

    # 4. references along the shifted schedule
    if isinstance(x_ref, RefTable):
        rvx, rey, rep, rtaux = _ref_table_inputs(x_ref, dev)
        n_ref = rvx.shape[-1]
        s_k = torch.cat([xf[4][None], carry.X_pred[2:, 4], carry.X_pred[-1:, 4]], dim=0)
        smt = s_k - rtaux[0] * torch.floor(s_k / rtaux[0])
        ff = smt * rtaux[1]
        i0 = torch.clamp(ff.to(torch.int32), 0, n_ref - 1).long()
        i1 = torch.remainder(i0 + 1, n_ref)
        tt = ff - i0.to(torch.float32)
        at = lambda a: _take(a, i0) * (1.0 - tt) + _take(a, i1) * tt
        zr = torch.zeros_like(tt)
        xref = torch.stack([at(rvx), zr, zr, at(rep), zr, at(rey)], dim=1)
    else:
        xref = megastep_refs(cfg, x_ref, _RefView(x=ekx, X_pred=carry.X_pred))

    # 5. tracker at mu-hat
    X_pred, U_pred, s_f, lam_f, u0, diag = mpc_core_plain(
        cfg, scfg, xf, pv_hat, kap_at, carry, xref, _make_consts(cfg, scfg, dev), eyb)

    # 6. plant: world-frame Euler sub-steps at the true mu
    pv_plant = dict(pv, mu=mu_true.reshape(B).to(**f32))
    hp = dt / n_sub
    xg_n = xg
    for _ in range(n_sub):
        xg_n = xg_n + hp * f_global_bl(pv_plant, xg_n, u0, sim_tire or cfg.tire)

    new = RaceMegaCarry(xg=xg_n, ekx=xf, ekP=ekP, fr=fr, x_prev_f=xf, X_pred=X_pred,
                        U_pred=U_pred, s=s_f, lam=lam_f, u_prev=u0, rho=diag[3])
    return new, u0, torch.cat([diag, mu[None]]), z


class _RefView(NamedTuple):
    """What ``megastep_refs`` reads of a carry (row 0 from the EKF mean)."""

    x: torch.Tensor
    X_pred: torch.Tensor


def racestep(cfg: MPCConfig, scfg: SolverConfig, track: Track, prm: torch.Tensor, x_ref,
             carry: RaceMegaCarry, noise: torch.Tensor, mu_true: torch.Tensor, ekf_q, ekf_r,
             n_sub: int = 10, n_sub_ekf: int = 4, sim_tire: str | None = None,
             use_ekf: bool = True, adapt_mu: bool = True, gate_sigma: float = 0.0,
             forgetting: float = 0.995, min_sensitivity: float = 0.05,
             window_m: float = 3.0, eyb=None):
    """One composed deployment step for every lane: the plain version for
    CPU tensors, one CUDA kernel launch for CUDA tensors.

    ``prm`` (10, B) holds the NOMINAL parameters (mu row = the controller
    seed mu0), ``x_ref`` a shared (N+1, NX) array, a batch-last
    (N+1, NX, B) one or a :class:`RefTable`, shared or per lane (channels
    (B, n)), ``noise`` (6, B) the pre-scaled sensor noise of this step,
    ``mu_true`` (B,) each lane's plant friction, ``ekf_q``/``ekf_r`` (6,) the
    EKF's diagonal Q and R, ``eyb`` an optional (N+1, 2, B) e_y corridor.
    Returns (new_carry, u0 (NU, B), diag (6, B): r_prim, r_dual,
    converged, rho_next, iters, mu_hat, z (6, B))."""
    dev = carry.xg.device
    args = (cfg, scfg, track, prm, x_ref, carry, noise, mu_true, ekf_q, ekf_r, n_sub, n_sub_ekf,
            sim_tire, use_ekf, adapt_mu, gate_sigma, forgetting, min_sensitivity, window_m, eyb)
    if dev.type == "cpu":
        return racestep_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"racestep: carry on {dev}; expected cpu or cuda")
    return _racestep_cuda(*args)


racestep.launches = 0   # kernel launches (CPU calls never count)


def racestep_workspace(N: int) -> int:
    """Per-lane float32 workspace of the CUDA racestep: the megastep's plus
    the (N+1, NX) reference rows sampled from a table."""
    return core_workspace(N) + (N + 1) * NX


def _check_race_operands(carry: RaceMegaCarry, prm, noise, mu_true, N: int):
    B = carry.xg.shape[-1]
    want = {"xg": (6, B), "ekx": (6, B), "ekP": (6, 6, B), "fr": (2, B), "x_prev_f": (6, B),
            "X_pred": (N + 1, NX, B), "U_pred": (N, NU, B), "s": (N + 1, NC, B),
            "lam": (N + 1, NC, B), "u_prev": (NU, B), "rho": (B,)}
    for name, shape in want.items():
        t = getattr(carry, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"racestep: carry.{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t, shape in (("prm", prm, (len(PARAM_ROWS), B)), ("noise", noise, (6, B)),
                           ("mu_true", mu_true, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"racestep: {name} has shape {tuple(t.shape)}, expected {shape}")


def _racestep_cuda(cfg, scfg, track, prm, x_ref, carry, noise, mu_true, ekf_q, ekf_r, n_sub,
                   n_sub_ekf, sim_tire, use_ekf, adapt_mu, gate_sigma, forgetting,
                   min_sensitivity, window_m, eyb):
    """Launch the kernel on the carry's device (one launch per step)."""
    dev = carry.xg.device
    N = cfg.N
    B = carry.xg.shape[-1]
    _check_race_supported(cfg, scfg, x_ref, eyb, B)
    _check_race_operands(carry, prm, noise, mu_true, N)
    sim_tire = sim_tire or cfg.tire
    if cfg.tire not in TIRES or sim_tire not in TIRES:
        raise ValueError(f"racestep: unknown tire {cfg.tire!r} / {sim_tire!r}")
    kw = dict(dtype=torch.float32, device=dev)
    use_table = isinstance(x_ref, RefTable)
    if use_table:
        rvx, rey, rep, rtaux = _ref_table_inputs(x_ref, dev)
        xref = torch.zeros((1,), **kw)
        # a per-lane table is (B, n_ref), lane-major: lane b's row starts at
        # b * n_ref; a shared one has stride 0
        ref_stride = rvx.shape[-1] if rvx.dim() == 2 else 0
    else:
        xref = megastep_refs(cfg, x_ref, _RefView(x=carry.ekx, X_pred=carry.X_pred))
        rvx = rey = rep = torch.zeros((1,), **kw)
        rtaux = torch.ones((2,), **kw)
        ref_stride = 0
    Xt, Yt, Pt = _pose_tables(track, dev)
    ins = [carry.xg, carry.ekx, carry.ekP, carry.fr, carry.x_prev_f, noise, mu_true,
           carry.X_pred, carry.U_pred, carry.s, carry.lam, carry.u_prev, carry.rho, xref, prm,
           track.kappa.to(**kw), _aux(track.length, track.ds, dev), Xt, Yt, Pt,
           torch.as_tensor(ekf_q, **kw).reshape(6), torch.as_tensor(ekf_r, **kw).reshape(6),
           rvx, rey, rep, rtaux, eyb]
    new = RaceMegaCarry(
        xg=torch.empty((6, B), **kw), ekx=torch.empty((6, B), **kw),
        ekP=torch.empty((6, 6, B), **kw), fr=torch.empty((2, B), **kw),
        x_prev_f=torch.empty((6, B), **kw), X_pred=torch.empty((N + 1, NX, B), **kw),
        U_pred=torch.empty((N, NU, B), **kw), s=torch.empty((N + 1, NC, B), **kw),
        lam=torch.empty((N + 1, NC, B), **kw), u_prev=torch.empty((NU, B), **kw), rho=None,
    )
    z = torch.empty((6, B), **kw)
    stats = torch.empty((8, B), **kw)
    ws = torch.empty((racestep_workspace(N), B), **kw)
    _cuda.launch(
        "arl_racestep",
        [t if t is None else t.contiguous() for t in ins]
        + [new.xg, new.ekx, new.ekP, new.fr, new.x_prev_f, z, new.X_pred, new.U_pred, new.s, new.lam,
           new.u_prev, stats, ws],
        list(core_floats(cfg, scfg)) + [gate_sigma, forgetting, min_sensitivity, FD_EPS, 1.0 / FD_EPS],
        [B, N, track.n_cells, n_sub, scfg.max_iter, max(1, scfg.check_termination),
         int(scfg.early_exit), TIRES[cfg.tire], TIRES[sim_tire], int(cfg.kappa_speed_cap),
         racestep_workspace(N), n_sub_ekf, int(use_ekf), int(adapt_mu), int(use_table),
         rvx.shape[-1] if use_table else 0, ref_stride, _win_cells(track, window_m),
         *launch_shape(N).ints()],
    )
    racestep.launches += 1
    _cuda.check_outputs("arl_racestep", *(t for t in new if t is not None), z, stats[:6])
    return new._replace(rho=stats[3]), new.u_prev, stats[:6], z

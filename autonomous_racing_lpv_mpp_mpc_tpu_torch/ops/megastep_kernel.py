"""Megastep: the whole receding-horizon control step for every scenario in
one kernel launch (kernel 2; CUDA source ``csrc/megastep_kernel.cu``).

Replaces the JAX package's ``ops/megastep_kernel.py::_megastep_kernel``
(Pallas, launched by ``megastep``). Per lane, in the kernel's sections:

    1 shift schedule -> 2 curvature + friction-cap bounds -> 3 LPV + Van
    Loan + augmentation + linear cost -> 4 warm-start shift -> 5 folded
    cost + Riccati factor -> 6 ADMM in chunks of ``check`` iterations ->
    7 residuals / rho -> 8 accept or limp-home -> 9 ``n_sub`` Euler plant
    sub-steps

Semantics are ``loop.mpc.mpc_step_batched`` followed by
``loop.closed_loop.plant_step``. With ``SolverConfig.early_exit`` the ADMM
loop of a 128-lane group stops at the first chunk boundary where every
lane of the group has passed the OSQP termination check (the grouping of
the JAX kernel's 128-lane block). Curvature is a plain indexed load with
the cell index ``floor(wrap(s) * inv_ds)`` — the kernel's form, which can
differ by one cell from ``track.curvature_at``'s ``wrap(s) / ds`` exactly
at a cell boundary.

:func:`megastep_plain` is the plain PyTorch version (batch-last); the
wrapper :func:`megastep` takes it for CPU tensors and launches the kernel
for CUDA tensors. The carry stays batch-last across steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..planner.reftable import RefTable, refs_from_table
from ..solver.admm import _RHO_MAX, _RHO_MIN, _RHO_TOL
from ..track.track import Track
from . import _cuda
from .stage_math import NA, NC, NU, NX, PARAM_ROWS, f_dynamic_bl, stage_aug_ab, unpack_params

GROUP = 128   # lanes that exit the ADMM loop together (the CUDA block)


class MegaCarry(NamedTuple):
    """Closed-loop carry, batch-LAST."""

    x: torch.Tensor        # (NX, B) plant state
    X_pred: torch.Tensor   # (N+1, NX, B)
    U_pred: torch.Tensor   # (N, NU, B)
    s: torch.Tensor        # (N+1, NC, B) ADMM split warm start
    lam: torch.Tensor      # (N+1, NC, B)
    u_prev: torch.Tensor   # (NU, B)
    rho: torch.Tensor      # (B,)


class MegaConsts(NamedTuple):
    """Host-side constant operands (the JAX fused kernel's ``_make_consts``)."""

    Dx: torch.Tensor     # (NC, NA)
    Du: torch.Tensor     # (NC, NU)
    soft: torch.Tensor   # (NC,)
    Qc: torch.Tensor     # (NA, NA) stage cost + sigma I
    Qtc: torch.Tensor    # (NA, NA) terminal cost + sigma I
    Rc: torch.Tensor     # (NU, NU)
    Mc: torch.Tensor     # (NA, NU)
    DxDx: torch.Tensor
    DuDu: torch.Tensor
    DxDu: torch.Tensor
    qw: torch.Tensor     # (NX,)


def _make_consts(cfg: MPCConfig, scfg: SolverConfig, device=None) -> MegaConsts:
    """Constraint rows, soft weights and the sigma-shifted cost blocks."""
    w = cfg.weights
    sigma = float(scfg.sigma)
    nx, na = NX, NA
    Dx = np.zeros((NC, na), np.float32)
    Du = np.zeros((NC, NU), np.float32)
    Dx[0, 0] = 1.0
    Dx[1, 5] = 1.0
    Du[2, 0] = 1.0
    Du[3, 1] = 1.0
    Dx[4, nx] = -1.0
    Du[4, 0] = 1.0
    Dx[5, nx + 1] = -1.0
    Du[5, 1] = 1.0
    soft = np.full((NC,), np.inf, np.float32)
    soft[1] = float(cfg.bounds.ey_soft)
    q_w = np.asarray(w.q, np.float32)
    if q_w.shape[0] != nx:
        raise ValueError(f"MPCWeights.q has {q_w.shape[0]} entries, the dynamic model {nx}")
    r_w = np.asarray(w.r, np.float32)
    dr_w = np.asarray(w.dr, np.float32)
    Qc = np.diag(np.concatenate([q_w, dr_w])) + sigma * np.eye(na, dtype=np.float32)
    Qtc = np.diag(np.concatenate([q_w, np.zeros(NU, np.float32)])) + sigma * np.eye(na, dtype=np.float32)
    Rc = np.diag(r_w + dr_w) + sigma * np.eye(NU, dtype=np.float32)
    Mc = np.zeros((na, NU), np.float32)
    Mc[nx:, :] = -np.diag(dr_w)
    arrs = (Dx, Du, soft, Qc, Qtc, Rc, Mc, Dx.T @ Dx, Du.T @ Du, Dx.T @ Du, q_w)
    return MegaConsts(*(torch.tensor(np.asarray(a, np.float32), device=device) for a in arrs))


def _check_supported(cfg: MPCConfig, scfg: SolverConfig, eyb, cache):
    if cfg.model != "dynamic":
        raise NotImplementedError("the megastep is ported for the dynamic model only")
    if cfg.linearization != "lpv" or cfg.discretization != "expm":
        raise NotImplementedError("the megastep builds LPV stages with the Van Loan expm")
    if eyb is not None:
        raise NotImplementedError("per-stage e_y corridors (eyb) are not ported yet")
    if cache is not None or scfg.cache_build:
        raise NotImplementedError("discretization caching (cache_build) is not ported")
    if scfg.max_iter < 1:
        raise ValueError("megastep: max_iter must be >= 1")


def megastep_init(p_b: VehicleParams, cfg: MPCConfig, track: Track, x0_b: torch.Tensor) -> MegaCarry:
    """Batch-last carry from the batch-first ``mpc_init``; x0_b (B, NX)."""
    from ..loop.mpc import mpc_init

    c = mpc_init(p_b, cfg, track, x0_b)
    bl = lambda t: t.movedim(0, -1).contiguous()
    return MegaCarry(x=bl(x0_b), X_pred=bl(c.X_pred), U_pred=bl(c.U_pred), s=bl(c.s),
                     lam=bl(c.lam), u_prev=bl(c.u_prev), rho=c.rho.contiguous())


def megastep_params(p_b: VehicleParams, B: int, device=None) -> torch.Tensor:
    """(10, B) stacked vehicle-parameter rows (compute once per sweep)."""
    rows = [torch.as_tensor(getattr(p_b, n), dtype=torch.float32, device=device).reshape(-1)
            for n in PARAM_ROWS]
    return torch.stack([r.expand(B) for r in rows]).contiguous()


def megastep_refs(cfg: MPCConfig, x_ref, carry: MegaCarry) -> torch.Tensor:
    """(N+1, NX, B) batch-last reference from a shared (N+1, NX) array, an
    already batch-last one, or a :class:`RefTable` sampled along the
    scheduled s ``[x, X_pred[2:], X_pred[N]]`` (``mpc_prepare``'s)."""
    B = carry.x.shape[-1]
    if isinstance(x_ref, RefTable):
        if x_ref.vx.dim() != 1:
            raise NotImplementedError("per-lane reference tables are not ported yet")
        s_sched = torch.cat([carry.x[4][None], carry.X_pred[2:, 4], carry.X_pred[-1:, 4]], dim=0)
        return refs_from_table(cfg, x_ref.to(carry.x.device), s_sched.T).permute(1, 2, 0).contiguous()
    x_ref = x_ref.to(device=carry.x.device, dtype=torch.float32)
    if x_ref.dim() == 2:
        x_ref = x_ref[:, :, None].expand(x_ref.shape + (B,))
    return x_ref.contiguous()


def _kap_lookup(track: Track, device):
    """Curvature at s by the kernel's cell index: clamp(int(wrap(s) * inv_ds))."""
    kappa = track.kappa.to(device)
    length = track.length.to(device)
    inv_ds = (1.0 / track.ds).to(device)
    n = kappa.shape[0]

    def kap_at(s):
        sm = s - length * torch.floor(s / length)
        idx = torch.clamp((sm * inv_ds).to(torch.int32), 0, n - 1)
        return kappa[idx.long()]

    return kap_at


# ---- batch-last small-matrix helpers (matrix dims lead, batch last) ----

def _mm(a, b):
    return torch.einsum("ijb,jlb->ilb", a, b)


def _mtm(a, b):
    return torch.einsum("jib,jlb->ilb", a, b)


def _mv(a, x):
    return torch.einsum("ijb,jb->ib", a, x)


def _mtv(a, x):
    return torch.einsum("jib,jb->ib", a, x)


def _inv2(H):
    a, b, c, d = H[0, 0], H[0, 1], H[1, 0], H[1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d * inv_det, -b * inv_det]),
                        torch.stack([-c * inv_det, a * inv_det])])


def _dual_norm(k: MegaConsts, y, N):
    """inf-norm of D' y over the stages; y (N+1, NC, B) -> (B,)."""
    tx = torch.einsum("ci,kcb->kib", k.Dx, y)
    tu = torch.einsum("ci,kcb->kib", k.Du, y[:N])
    return torch.maximum(tx.abs().amax(dim=(0, 1)), tu.abs().amax(dim=(0, 1)))


def _groups_done(da):
    """(B,) lane mask: the lane's 128-lane group has a done-at everywhere
    (lanes past B count as done)."""
    B = da.shape[0]
    n_g = -(-B // GROUP)
    done = torch.ones(n_g * GROUP, dtype=torch.bool, device=da.device)
    done[:B] = da >= 0.0
    return done.reshape(n_g, GROUP).all(dim=1).repeat_interleave(GROUP)[:B]


def mpc_core_plain(cfg: MPCConfig, scfg: SolverConfig, x_now: torch.Tensor, pv: dict, kap_at,
                   carry, xref: torch.Tensor, k: MegaConsts):
    """The tracker step of the kernels, sections 1-8, in plain PyTorch:
    schedule shift, curvature + bounds, LPV + Van Loan, warm start, Riccati
    factor, ADMM (with the 128-lane early exit), residuals / rho, accept or
    limp-home (the JAX package's ``_mpc_core``, shared by the megastep and
    the racestep).

    ``x_now`` (NX, B) is the state the step starts from, ``pv`` the
    per-lane parameter rows (mu may be an estimate), ``carry`` anything
    with the warm-start fields of :class:`MegaCarry`, ``xref`` (N+1, NX, B).
    Returns (X_pred, U_pred, s, lam, u0 (NU, B), diag (5, B): r_prim,
    r_dual, converged, rho_next, iters)."""
    N, dt = cfg.N, float(cfg.dt)
    dev = x_now.device
    f32 = dict(dtype=torch.float32, device=dev)
    B = x_now.shape[-1]
    b = cfg.bounds
    rho = carry.rho
    sigma, alpha = float(scfg.sigma), float(scfg.alpha)

    # 1. shift schedule
    Xs = torch.cat([x_now[None], carry.X_pred[2:], carry.X_pred[-1:]], dim=0)   # (N+1, NX, B)
    Us = torch.cat([carry.U_pred[1:], carry.U_pred[-1:]], dim=0)              # (N, NU, B)

    # 2. curvature + bounds per stage
    kap = kap_at(Xs[:, 4])                                                     # (N+1, B)
    if cfg.kappa_speed_cap:
        cap = torch.sqrt(cfg.a_lat_frac * pv["mu"] * pv["g"] / torch.clamp_min(torch.abs(kap), 1e-6))
        cap = torch.clamp(cap, b.vx_min, b.vx_max)
    else:
        cap = torch.full((N + 1, B), b.vx_max, **f32)
    lo = torch.tensor([b.vx_min, -b.ey_max, -b.delta_max, b.a_min, -b.ddelta_max, -b.da_max], **f32)
    hi = torch.tensor([b.vx_max, b.ey_max, b.delta_max, b.a_max, b.ddelta_max, b.da_max], **f32)
    lb = lo[None, :, None].expand(N + 1, NC, B).clone()
    ub = hi[None, :, None].expand(N + 1, NC, B).clone()
    ub[:, 0] = cap
    inf = float("inf")
    lb[0, :2], ub[0, :2] = -inf, inf
    lb[N, 2:], ub[N, 2:] = -inf, inf

    # 3. stage matrices (all N at once) + linear cost, vx-ref clamped to the cap
    Aa, Ba = stage_aug_ab(Xs[:N].permute(1, 0, 2), Us.permute(1, 0, 2), kap[:N], pv,
                          dt=dt, tire=cfg.tire)
    A_s = Aa.permute(2, 0, 1, 3)                                               # (N, NA, NA, B)
    B_s = Ba.permute(2, 0, 1, 3)                                               # (N, NA, NU, B)
    xr = xref.clone()
    xr[:, 0] = torch.minimum(xr[:, 0], ub[:, 0])
    q0 = torch.cat([-(k.qw[None, :, None] * xr), torch.zeros((N + 1, NU, B), **f32)], dim=1)

    # 4. warm start: shift the previous ADMM variables one stage
    s = torch.clamp(torch.cat([carry.s[1:], carry.s[-1:]], dim=0), lb, ub)
    lam = torch.cat([carry.lam[1:], carry.lam[-1:]], dim=0)

    # 5. folded cost + Riccati factorization
    c1 = lambda a: a[:, :, None]
    Qf = c1(k.Qc) + c1(k.DxDx) * rho
    V = c1(k.Qtc) + c1(k.DxDx) * rho
    Rf = c1(k.Rc) + c1(k.DuDu) * rho
    Mf = c1(k.Mc) + c1(k.DxDu) * rho
    K_s, Hiv_s, Hux_s = [None] * N, [None] * N, [None] * N
    for i in range(N - 1, -1, -1):
        Ak, Bk = A_s[i], B_s[i]
        VB = _mm(V, Bk)
        Huu = Rf + _mtm(Bk, VB)
        VA = _mm(V, Ak)
        Hux = Mf.transpose(0, 1) + _mtm(Bk, VA)
        Hiv = _inv2(Huu)
        K = -_mm(Hiv, Hux)
        K_s[i], Hiv_s[i], Hux_s[i] = K, Hiv, Hux
        Vn = Qf + _mtm(Ak, VA) + _mtm(Hux, K)
        V = 0.5 * (Vn + Vn.transpose(0, 1))

    # 6. ADMM iterations
    x0a = torch.cat([x_now, carry.u_prev], dim=0)                             # (NA, B)
    Xsol = torch.zeros((N + 1, NA, B), **f32)
    Usol = torch.zeros((N, NU, B), **f32)
    G = torch.zeros((N + 1, NC, B), **f32)
    sprev = s
    beta = torch.clamp_max(k.soft, 1e30)[None, :, None]
    hard = torch.isinf(k.soft)[None, :, None]
    rinv = 1.0 / rho
    soft_blend_inv = 1.0 / (beta + rho)

    def iteration(s, lam, Xsol, Usol):
        v = s - lam * rinv
        qv = q0 - rho * torch.einsum("ci,kcb->kib", k.Dx, v) - sigma * Xsol
        rv = -rho * torch.einsum("ci,kcb->kib", k.Du, v[:N]) - sigma * Usol
        vvec = qv[N]
        d = [None] * N
        for i in range(N - 1, -1, -1):
            h_u = rv[i] + _mtv(B_s[i], vvec)
            d[i] = -_mv(Hiv_s[i], h_u)
            vvec = qv[i] + _mtv(A_s[i], vvec) + _mtv(Hux_s[i], d[i])
        xs, us = [x0a], []
        x = x0a
        for i in range(N):
            u = _mv(K_s[i], x) + d[i]
            x = _mv(A_s[i], x) + _mv(B_s[i], u)
            xs.append(x)
            us.append(u)
        Xn, Un = torch.stack(xs), torch.stack(us)
        Gx = torch.einsum("ci,kib->kcb", k.Dx, Xn)
        Gu = torch.einsum("ci,kib->kcb", k.Du, Un)
        Gn = torch.cat([Gx[:N] + Gu, Gx[N:]], dim=0)
        w_rel = alpha * Gn + (1.0 - alpha) * s
        wl = w_rel + lam * rinv
        clipped = torch.clamp(wl, lb, ub)
        soft_s = (beta * clipped + rho * wl) * soft_blend_inv
        s_new = torch.where(hard, clipped, soft_s)
        return s_new, lam + rho * (w_rel - s_new), Xn, Un, Gn, s

    def residuals(G, s, lam, sprev):
        red = lambda t: t.abs().amax(dim=(0, 1))
        r_p = red(G - s)
        r_d = rho * _dual_norm(k, s - sprev, N)
        e_p = scfg.eps_abs + scfg.eps_rel * torch.maximum(red(G), red(s))
        e_d = scfg.eps_abs + scfg.eps_rel * _dual_norm(k, lam, N)
        return r_p, r_d, e_p, e_d

    da = torch.full((B,), -1.0, **f32)
    state = (s, lam, Xsol, Usol, G, sprev)

    def run(state, n_it, act=None):
        for _ in range(n_it):
            new = iteration(*state[:4])
            if act is None:
                state = new
            else:
                state = tuple(torch.where(act, n, o) for n, o in zip(new, state))
        return state

    def record(state, da, it1):
        r_p, r_d, e_p, e_d = residuals(state[4], state[0], state[1], state[5])
        conv = (r_p <= e_p) & (r_d <= e_d)
        return torch.where((da < 0.0) & conv, torch.full_like(da, float(it1)), da)

    check = max(1, scfg.check_termination)
    n_chunks = scfg.max_iter // check
    rem = scfg.max_iter - n_chunks * check
    if scfg.early_exit:
        for c in range(n_chunks):
            act = ~_groups_done(da)
            if not bool(act.any()):
                break
            state = run(state, check, act)
            da = record(state, da, (c + 1) * check)
        act = ~_groups_done(da)
        if rem and bool(act.any()):
            state = run(state, rem, act)
    else:
        for c in range(n_chunks):
            state = run(state, check)
            da = record(state, da, (c + 1) * check)
        state = run(state, rem)
    s_f, lam_f, Xsol, Usol, G, sprev = state

    # 7. residuals / convergence / rho adaptation
    r_prim, r_dual, eps_prim, eps_dual = residuals(G, s_f, lam_f, sprev)
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    ratio = torch.sqrt((r_prim / torch.clamp_min(eps_prim, 1e-12))
                       / torch.clamp_min(r_dual / torch.clamp_min(eps_dual, 1e-12), 1e-12))
    rho_new = torch.clamp(rho * ratio, _RHO_MIN, _RHO_MAX)
    rho_next = torch.where((ratio > _RHO_TOL) | (ratio < 1.0 / _RHO_TOL), rho_new, rho)
    iters = torch.where(da > 0.0, da, torch.full_like(da, float(scfg.max_iter)))

    # 8. accept or limp-home
    usable = converged | ((r_prim < scfg.eps_fallback) & (r_dual < scfg.eps_fallback))
    kap_now = kap_at(x_now[4])
    L = pv["lf"] + pv["lr"]
    delta_ff = torch.atan(kap_now * L) - 0.5 * x_now[5] * torch.sign(x_now[0])
    delta_ff = torch.clamp(delta_ff, -b.delta_max, b.delta_max)
    a_fb = torch.where(x_now[0] > 2.0 * b.vx_min, torch.full_like(rho, -0.5), torch.zeros_like(rho))
    u0 = torch.where(usable, Usol[0], torch.stack([delta_ff, a_fb]))
    X_pred = torch.where(usable, Xsol[:, :NX], Xs)
    U_pred = torch.where(usable, Usol, Us)
    diag = torch.stack([r_prim, r_dual, converged.to(torch.float32), rho_next, iters])
    return X_pred, U_pred, s_f, lam_f, u0, diag


def megastep_plain(cfg: MPCConfig, scfg: SolverConfig, track: Track, prm: torch.Tensor,
                   x_ref, carry: MegaCarry, n_sub: int = 4, sim_tire: str | None = None,
                   eyb=None, cache=None):
    """Plain PyTorch version of the megastep kernel (any device): the
    shared tracker core, then ``n_sub`` Euler sub-steps of the Frenet plant.

    Returns (new_carry, u0 (NU, B), diag (5, B): r_prim, r_dual, converged,
    rho_next, iters)."""
    _check_supported(cfg, scfg, eyb, cache)
    dev = carry.x.device
    pv = unpack_params(prm)
    kap_at = _kap_lookup(track, dev)
    X_pred, U_pred, s_f, lam_f, u0, diag = mpc_core_plain(
        cfg, scfg, carry.x, pv, kap_at, carry, megastep_refs(cfg, x_ref, carry),
        _make_consts(cfg, scfg, dev))

    # 9. plant: fine Euler sub-steps
    h = float(cfg.dt) / n_sub
    x = carry.x
    for _ in range(n_sub):
        x = x + h * f_dynamic_bl(pv, x, u0, kap_at(x[4]), sim_tire or cfg.tire)

    new = MegaCarry(x=x, X_pred=X_pred, U_pred=U_pred, s=s_f, lam=lam_f, u_prev=u0, rho=diag[3])
    return new, u0, diag


def _check_cuda_operands(carry: MegaCarry, prm, N: int):
    B = carry.x.shape[-1]
    want = {"x": (NX, B), "X_pred": (N + 1, NX, B), "U_pred": (N, NU, B), "s": (N + 1, NC, B),
            "lam": (N + 1, NC, B), "u_prev": (NU, B), "rho": (B,)}
    for name, shape in want.items():
        t = getattr(carry, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"megastep: carry.{name} has shape {tuple(t.shape)}, expected {shape}")
    if tuple(prm.shape) != (len(PARAM_ROWS), B):
        raise ValueError(f"megastep: prm has shape {tuple(prm.shape)}, expected (10, {B})")


def megastep(cfg: MPCConfig, scfg: SolverConfig, track: Track, prm: torch.Tensor, x_ref,
             carry: MegaCarry, n_sub: int = 4, sim_tire: str | None = None, eyb=None,
             cache=None):
    """One closed-loop step for every scenario: the plain version for CPU
    tensors, one CUDA kernel launch for CUDA tensors.

    Returns (new_carry, u0 (NU, B), diag (5, B): r_prim, r_dual,
    converged, rho_next, iters — the done-at iteration)."""
    dev = carry.x.device
    if dev.type == "cpu":
        return megastep_plain(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache)
    if dev.type != "cuda":
        raise ValueError(f"megastep: carry on {dev}; expected cpu or cuda")
    return _megastep_cuda(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache)


def _megastep_cuda(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache):
    """Launch the kernel on the carry's device (one launch per step)."""
    _check_supported(cfg, scfg, eyb, cache)
    dev = carry.x.device
    N = cfg.N
    B = carry.x.shape[-1]
    _check_cuda_operands(carry, prm, N)
    tires = {"linear": 0, "pacejka": 1}
    sim_tire = sim_tire or cfg.tire
    if cfg.tire not in tires or sim_tire not in tires:
        raise ValueError(f"megastep: unknown tire {cfg.tire!r} / {sim_tire!r}")
    kw = dict(dtype=torch.float32, device=dev)
    xref = megastep_refs(cfg, x_ref, carry)
    taux = torch.stack([track.length, 1.0 / track.ds]).to(**kw)
    kappa = track.kappa.to(**kw).contiguous()
    ins = [carry.x, carry.X_pred, carry.U_pred, carry.s, carry.lam, carry.u_prev,
           carry.rho, xref, prm, kappa, taux]
    out = MegaCarry(
        x=torch.empty((NX, B), **kw), X_pred=torch.empty((N + 1, NX, B), **kw),
        U_pred=torch.empty((N, NU, B), **kw), s=torch.empty((N + 1, NC, B), **kw),
        lam=torch.empty((N + 1, NC, B), **kw), u_prev=torch.empty((NU, B), **kw),
        rho=None,
    )
    stats = torch.empty((8, B), **kw)
    ws = torch.empty((megastep_workspace(N), B), **kw)
    k = _make_consts(cfg, scfg)
    consts = torch.cat([t.reshape(-1) for t in k]).tolist()
    b = cfg.bounds
    _cuda.launch(
        "arl_megastep",
        [t.contiguous() for t in ins] + [out.x, out.X_pred, out.U_pred, out.s, out.lam,
                                         out.u_prev, stats, ws],
        [cfg.dt, scfg.sigma, scfg.alpha, scfg.eps_abs, scfg.eps_rel, scfg.eps_fallback,
         b.vx_min, b.vx_max, b.ey_max, b.delta_max, b.a_min, b.a_max, b.ddelta_max, b.da_max,
         cfg.a_lat_frac] + consts,
        [B, N, track.n_cells, n_sub, scfg.max_iter, max(1, scfg.check_termination),
         int(scfg.early_exit), tires[cfg.tire], tires[sim_tire], int(cfg.kappa_speed_cap),
         megastep_workspace(N)],
    )
    megastep.launches += 1
    new = out._replace(rho=stats[3])
    return new, out.u_prev, stats[:5]


megastep.launches = 0   # kernel launches (CPU calls never count)


def megastep_workspace(N: int) -> int:
    """Per-lane float32 workspace of the CUDA megastep (see the source)."""
    return ((N + 1) * NX + N * NU + (N + 1) + 2 * (N + 1) * NC + N * NX * NX
            + N * NX * NU + (N + 1) * NX + N * NU * NA + N * NU * NU + N * NU * NA
            + N * NU + (N + 1) * NA + N * NU)

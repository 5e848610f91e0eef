"""Megastep: the whole receding-horizon control step for every scenario in
one kernel launch (kernel 2; CUDA source ``csrc/megastep_kernel.cu``, whose
cached instantiations ``csrc/megastep_cache_kernel.cu`` builds).

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

Both the dynamic (nx=6) and the kinematic (nx=4, BASELINE config 1)
bicycle; ``cfg.model`` selects the LPV stages, the plant and the carry's
state width. An optional ``eyb`` (N+1, 2, B) per-stage e_y corridor (lo,
hi), ``engine.assembly.corridor_from_blocks`` evaluated along the
scheduled s, replaces row 1's +-ey_max bounds before the stage-0 and
terminal disables: obstacles on the fast path. On the card the kernel runs
the group-cooperative tracker core of the fused kernel and the racestep, in
their launch shape (``fused_kernel.launch_shape``).

Discretization cache (``SolverConfig.cache_build``, the JAX kernel's
shift-reuse branch): the schedule shifts one stage per step, so stage k's
matrices can be last step's stage k+1 and only stage N-1 is built anew. A
:class:`MegaCache` (``megacache_init``) holds the stages, the schedule
each was built at and the steps since the last full build; a 128-lane
group rebuilds all N stages when the drift of its new schedule from the
cached one (:func:`cache_drift_plain`) exceeds ``cache_drift_tol`` or its
age reaches ``cache_max_age``, and shifts otherwise. The decision takes
the maxima over the group's lanes below B only; the JAX kernel's last
block also sees lane 0 through its padding copies, so at a B that is no
multiple of 128 and above it, the two can decide the last group
differently.

:func:`megastep_plain` is the plain PyTorch version (batch-last); the
wrapper :func:`megastep` takes it for CPU tensors and launches the kernel
for CUDA tensors. The carry stays batch-last across steps.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..core.device import resolve_device
from ..planner.reftable import RefTable, refs_from_table
from ..solver.admm import _RHO_MAX, _RHO_MIN, _RHO_TOL
from ..track.track import Track
from ..utils import profiling
from . import _cuda
from .fused_kernel import (
    GROUP,
    MODELS,
    TIRES,
    MegaConsts,
    _make_consts,
    admm_plain,
    core_floats,
    core_workspace,
    launch_shape,
    residual_rows,
    riccati_factor_plain,
)
from .stage_math import (
    NC,
    NU,
    PARAM_ROWS,
    f_model_bl,
    model_dims,
    model_s_ey,
    stack_params,
    stage_aug_ab,
    unpack_params,
)


class MegaCarry(NamedTuple):
    """Closed-loop carry, batch-LAST (nx = 6 dynamic, 4 kinematic)."""

    x: torch.Tensor        # (nx, B) plant state
    X_pred: torch.Tensor   # (N+1, nx, B)
    U_pred: torch.Tensor   # (N, NU, B)
    s: torch.Tensor        # (N+1, NC, B) ADMM split warm start
    lam: torch.Tensor      # (N+1, NC, B)
    u_prev: torch.Tensor   # (NU, B)
    rho: torch.Tensor      # (B,)


class MegaCache(NamedTuple):
    """Discretization cache (``SolverConfig.cache_build``), batch-last: the
    discrete stage matrices, the schedule each stage was built at, and the
    steps since the group's last full build. The JAX package's cache holds
    the augmented stages (N, na, na, B) and (N, na, NU, B); their (nx, nx)
    and (nx, NU) top blocks are these (``convert.mega_cache``)."""

    A: torch.Tensor      # (N, nx, nx, B) Ad of each stage
    B: torch.Tensor      # (N, nx, NU, B) Bd
    Xs: torch.Tensor     # (N, nx, B) the scheduled states each stage was built at
    Us: torch.Tensor     # (N, NU, B)
    kap: torch.Tensor    # (N, B)
    age: torch.Tensor    # (1, B) steps since the last full build


# drift scales of the cache signature (the JAX kernel's x_scl / u_scl):
# one per state channel, None for s (the stages see s only through kappa,
# which has its own term), then the inputs and kappa
_CACHE_X_SCALE = {"dynamic": (1.0, 0.5, 2.0, 0.5, None, 0.5), "kinematic": (1.0, 0.5, None, 0.5)}
_CACHE_U_SCALE = (0.3, 2.0)
_CACHE_KAP_SCALE = 0.5


def megacache_init(cfg: MPCConfig, scfg: SolverConfig, B: int, device=None) -> MegaCache:
    """Empty cache on ``device`` (``None``: the CUDA card): the zero
    signature and the saturated age make the first step build every stage."""
    kw = dict(dtype=torch.float32, device=resolve_device(device))
    nx, _ = model_dims(cfg.model)
    N = cfg.N
    return MegaCache(A=torch.zeros((N, nx, nx, B), **kw), B=torch.zeros((N, nx, NU, B), **kw),
                     Xs=torch.zeros((N, nx, B), **kw), Us=torch.zeros((N, NU, B), **kw),
                     kap=torch.zeros((N, B), **kw),
                     age=torch.full((1, B), float(scfg.cache_max_age), **kw))


def _group_max(v: torch.Tensor) -> torch.Tensor:
    """(B,) of non-negative values -> each lane's maximum over its 128-lane
    group (lanes past B take no part)."""
    B = v.shape[0]
    n_g = -(-B // GROUP)
    pad = v.new_zeros(n_g * GROUP)
    pad[:B] = v
    return pad.reshape(n_g, GROUP).amax(dim=1).repeat_interleave(GROUP)[:B]


def cache_drift_plain(cfg: MPCConfig, Xs: torch.Tensor, Us: torch.Tensor, kap: torch.Tensor,
                      cache: MegaCache) -> torch.Tensor:
    """(B,) drift of each lane's 128-lane group: over the stages k < N-1,
    the largest |Xs[k] - cache.Xs[k+1]|, |Us[k] - cache.Us[k+1]| and
    |kap[k] - cache.kap[k+1]|, each channel divided by its scale.
    Xs (>= N, nx, B), Us (N, NU, B), kap (>= N, B): this step's schedule."""
    N = cfg.N
    xc = [c for c, sc in enumerate(_CACHE_X_SCALE[cfg.model]) if sc is not None]
    diff = torch.cat([(Xs[:N - 1, xc] - cache.Xs[1:, xc]).abs(), (Us[:N - 1] - cache.Us[1:]).abs(),
                      (kap[:N - 1] - cache.kap[1:]).abs()[:, None]], dim=1)     # (N-1, terms, B)
    # a true division by a tensor: a Python-scalar divisor may become a
    # product with its reciprocal on the card, one rounding off the kernel's
    scale = torch.tensor([_CACHE_X_SCALE[cfg.model][c] for c in xc] + list(_CACHE_U_SCALE)
                         + [_CACHE_KAP_SCALE], dtype=torch.float32, device=Xs.device)
    lane = (diff / scale[:, None]).amax(dim=(0, 1)) if N > 1 else torch.zeros_like(kap[0])
    return _group_max(lane)


def _shifted_schedule(x_now: torch.Tensor, carry):
    """This step's schedule: Xs = [x, X_pred[2:N], X_pred[N]] (N+1, nx, B),
    Us = [U_pred[1:N-1], U_pred[N-1]] (N, NU, B)."""
    Xs = torch.cat([x_now[None], carry.X_pred[2:], carry.X_pred[-1:]], dim=0)
    Us = torch.cat([carry.U_pred[1:], carry.U_pred[-1:]], dim=0)
    return Xs, Us


def _megacache_drift(cfg: MPCConfig, track: Track, carry: MegaCarry, cache: MegaCache) -> torch.Tensor:
    """(B,) the drift that the megastep's next step from ``carry`` sees in
    each lane's 128-lane group (:func:`cache_drift_plain` on its schedule):
    the group rebuilds where it exceeds ``cache_drift_tol``."""
    Xs, Us = _shifted_schedule(carry.x, carry)
    s_idx, _ = model_s_ey(cfg.model)
    return cache_drift_plain(cfg, Xs, Us, _kap_lookup(track, carry.x.device)(Xs[:, s_idx]), cache)


def _cache_stages(cfg: MPCConfig, scfg: SolverConfig, Xs, Us, kap, Ad, Bd, cache: MegaCache):
    """The cache's branch per 128-lane group: every stage from this step's
    build (Ad, Bd (N, nx, ., B)) where the group rebuilds, else the cached
    stages shifted one back with stage N-1 from the build. Returns (Ad, Bd,
    new_cache)."""
    N = cfg.N
    drift = cache_drift_plain(cfg, Xs, Us, kap, cache)
    rebuild = (drift > scfg.cache_drift_tol) | (_group_max(cache.age[0]) >= float(scfg.cache_max_age))
    shift = lambda old, new: torch.cat([old[1:], new[N - 1:N]], dim=0)
    pick = lambda old, new: torch.where(rebuild, new, shift(old, new))
    sig = (Ad, Bd, Xs[:N], Us, kap[:N])
    Ad, Bd, Xc, Uc, kc = (pick(o, n) for o, n in zip(cache[:5], sig))
    age = torch.where(rebuild, torch.zeros_like(cache.age), cache.age + 1.0)
    return Ad, Bd, MegaCache(A=Ad, B=Bd, Xs=Xc, Us=Uc, kap=kc, age=age)


def _check_supported(cfg: MPCConfig, scfg: SolverConfig, cache, eyb=None, B: int = 0):
    if eyb is not None and tuple(eyb.shape) != (cfg.N + 1, 2, B):
        raise ValueError(f"eyb has shape {tuple(eyb.shape)}, expected ({cfg.N + 1}, 2, {B})")
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.linearization != "lpv" or cfg.discretization != "expm":
        raise NotImplementedError("the megastep builds LPV stages with the Van Loan expm")
    if bool(scfg.cache_build) != (cache is not None):
        raise ValueError("megastep: scfg.cache_build needs a MegaCache (megacache_init) threaded "
                         "through the steps, and a MegaCache needs scfg.cache_build")
    if cache is not None:
        nx, _ = model_dims(cfg.model)
        N = cfg.N
        want = {"A": (N, nx, nx, B), "B": (N, nx, NU, B), "Xs": (N, nx, B), "Us": (N, NU, B),
                "kap": (N, B), "age": (1, B)}
        for name, shape in want.items():
            if tuple(getattr(cache, name).shape) != shape:
                raise ValueError(f"megastep: cache.{name} has shape "
                                 f"{tuple(getattr(cache, name).shape)}, expected {shape}")
    if scfg.max_iter < 1:
        raise ValueError("megastep: max_iter must be >= 1")


def megastep_init(p_b: VehicleParams, cfg: MPCConfig, track: Track, x0_b: torch.Tensor) -> MegaCarry:
    """Batch-last carry from the batch-first ``mpc_init``; x0_b (B, nx).
    While a profiler records, in the span ``megastep.init``."""
    from ..loop.mpc import mpc_init

    with profiling.span("megastep.init", profiling.tracing()):
        c = mpc_init(p_b, cfg, track, x0_b)
        bl = lambda t: t.movedim(0, -1).contiguous()
        return MegaCarry(x=bl(x0_b), X_pred=bl(c.X_pred), U_pred=bl(c.U_pred), s=bl(c.s),
                         lam=bl(c.lam), u_prev=bl(c.u_prev), rho=c.rho.contiguous())


def megastep_params(p_b: VehicleParams, B: int, device=None) -> torch.Tensor:
    """(10, B) stacked vehicle-parameter rows (compute once per sweep), on
    ``device`` (``None``: the CUDA card)."""
    return stack_params(p_b, B, resolve_device(device))


def megastep_refs(cfg: MPCConfig, x_ref, carry: MegaCarry) -> torch.Tensor:
    """(N+1, nx, B) batch-last reference from a shared (N+1, nx) array, an
    already batch-last one, or a :class:`RefTable` sampled along the
    scheduled s ``[x, X_pred[2:], X_pred[N]]`` (``mpc_prepare``'s)."""
    B = carry.x.shape[-1]
    if isinstance(x_ref, RefTable):
        if x_ref.vx.dim() != 1:
            raise NotImplementedError("the megastep samples one shared table, as the JAX "
                                      "megastep_refs does; per-lane tables run on the racestep")
        s_idx, _ = model_s_ey(cfg.model)
        s_sched = torch.cat([carry.x[s_idx][None], carry.X_pred[2:, s_idx], carry.X_pred[-1:, s_idx]],
                            dim=0)
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


def mpc_core_plain(cfg: MPCConfig, scfg: SolverConfig, x_now: torch.Tensor, pv: dict, kap_at,
                   carry, xref: torch.Tensor, k: MegaConsts, eyb=None, cache=None):
    """The tracker step of the kernels, sections 1-8, in plain PyTorch:
    schedule shift, curvature + bounds, LPV + Van Loan, warm start, Riccati
    factor, ADMM (with the 128-lane early exit), residuals / rho, accept or
    limp-home (the JAX package's ``_mpc_core``, shared by the megastep and
    the racestep).

    ``x_now`` (nx, B) is the state the step starts from, ``pv`` the
    per-lane parameter rows (mu may be an estimate), ``carry`` anything
    with the warm-start fields of :class:`MegaCarry`, ``xref`` (N+1, nx, B),
    ``eyb`` an optional (N+1, 2, B) e_y corridor for row 1, ``cache`` a
    :class:`MegaCache` (then section 3 takes the cache's branch). Returns
    (X_pred, U_pred, s, lam, u0 (NU, B), diag (5, B): r_prim, r_dual,
    converged, rho_next, iters), and the new cache after them when one is
    given."""
    N, dt = cfg.N, float(cfg.dt)
    nx, _ = model_dims(cfg.model)
    s_idx, ey_idx = model_s_ey(cfg.model)
    dev = x_now.device
    f32 = dict(dtype=torch.float32, device=dev)
    B = x_now.shape[-1]
    b = cfg.bounds
    rho = carry.rho

    # 1. shift schedule
    Xs, Us = _shifted_schedule(x_now, carry)                                   # (N+1, nx, B), (N, NU, B)

    # 2. curvature + bounds per stage
    kap = kap_at(Xs[:, s_idx])                                                 # (N+1, B)
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
    if eyb is not None:
        # the corridor replaces row 1 before the disables, so the warm-start
        # clip below sees it too
        lb[:, 1], ub[:, 1] = eyb[:, 0], eyb[:, 1]
    inf = float("inf")
    lb[0, :2], ub[0, :2] = -inf, inf
    lb[N, 2:], ub[N, 2:] = -inf, inf

    # 3. stage matrices (all N at once) + linear cost, vx-ref clamped to the cap
    Aa, Ba = stage_aug_ab(Xs[:N].permute(1, 0, 2), Us.permute(1, 0, 2), kap[:N], pv,
                          dt=dt, tire=cfg.tire, model=cfg.model)
    A_s = Aa.permute(2, 0, 1, 3)                                               # (N, na, na, B)
    B_s = Ba.permute(2, 0, 1, 3)                                               # (N, na, NU, B)
    if cache is not None:
        Ad, Bd, new_cache = _cache_stages(cfg, scfg, Xs, Us, kap, A_s[:, :nx, :nx], B_s[:, :nx],
                                          cache)
        A_s = torch.zeros_like(A_s)
        A_s[:, :nx, :nx] = Ad
        B_s = torch.cat([Bd, B_s[:, nx:]], dim=1)
    xr = xref.clone()
    xr[:, 0] = torch.minimum(xr[:, 0], ub[:, 0])
    q0 = torch.cat([-(k.qw[None, :, None] * xr), torch.zeros((N + 1, NU, B), **f32)], dim=1)

    # 4. warm start: shift the previous ADMM variables one stage
    s = torch.clamp(torch.cat([carry.s[1:], carry.s[-1:]], dim=0), lb, ub)
    lam = torch.cat([carry.lam[1:], carry.lam[-1:]], dim=0)

    # 5. folded cost + Riccati factorization
    gains = riccati_factor_plain(k, A_s, B_s, rho)

    # 6. ADMM iterations, done-at recorded at chunk boundaries
    x0a = torch.cat([x_now, carry.u_prev], dim=0)                             # (na, B)
    s_f, lam_f, Xsol, Usol, G, sprev, da = admm_plain(scfg, k, A_s, B_s, gains, q0, lb, ub, x0a,
                                                      s, lam, rho, exact_done_at=False)

    # 7. residuals / convergence / rho adaptation
    r_prim, r_dual, g_max, s_max, d_lam = residual_rows(k, N, G, s_f, lam_f, sprev, rho)
    eps_prim = scfg.eps_abs + scfg.eps_rel * torch.maximum(g_max, s_max)
    eps_dual = scfg.eps_abs + scfg.eps_rel * d_lam
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    ratio = torch.sqrt((r_prim / torch.clamp_min(eps_prim, 1e-12))
                       / torch.clamp_min(r_dual / torch.clamp_min(eps_dual, 1e-12), 1e-12))
    rho_new = torch.clamp(rho * ratio, _RHO_MIN, _RHO_MAX)
    rho_next = torch.where((ratio > _RHO_TOL) | (ratio < 1.0 / _RHO_TOL), rho_new, rho)
    iters = torch.where(da > 0.0, da, torch.full_like(da, float(scfg.max_iter)))

    # 8. accept or limp-home
    usable = converged | ((r_prim < scfg.eps_fallback) & (r_dual < scfg.eps_fallback))
    kap_now = kap_at(x_now[s_idx])
    L = pv["lf"] + pv["lr"]
    delta_ff = torch.atan(kap_now * L) - 0.5 * x_now[ey_idx] * torch.sign(x_now[0])
    delta_ff = torch.clamp(delta_ff, -b.delta_max, b.delta_max)
    a_fb = torch.where(x_now[0] > 2.0 * b.vx_min, torch.full_like(rho, -0.5), torch.zeros_like(rho))
    u0 = torch.where(usable, Usol[0], torch.stack([delta_ff, a_fb]))
    X_pred = torch.where(usable, Xsol[:, :nx], Xs)
    U_pred = torch.where(usable, Usol, Us)
    diag = torch.stack([r_prim, r_dual, converged.to(torch.float32), rho_next, iters])
    if cache is not None:
        return X_pred, U_pred, s_f, lam_f, u0, diag, new_cache
    return X_pred, U_pred, s_f, lam_f, u0, diag


def megastep_plain(cfg: MPCConfig, scfg: SolverConfig, track: Track, prm: torch.Tensor,
                   x_ref, carry: MegaCarry, n_sub: int = 4, sim_tire: str | None = None,
                   eyb=None, cache=None):
    """Plain PyTorch version of the megastep kernel (any device): the
    shared tracker core, then ``n_sub`` Euler sub-steps of the Frenet plant
    of ``cfg.model``; ``eyb`` an optional (N+1, 2, B) e_y corridor,
    ``cache`` the :class:`MegaCache` that ``scfg.cache_build`` needs.

    Returns (new_carry, u0 (NU, B), diag (5, B): r_prim, r_dual, converged,
    rho_next, iters), and the new cache after them with ``cache_build``."""
    _check_supported(cfg, scfg, cache, eyb, carry.x.shape[-1])
    dev = carry.x.device
    pv = unpack_params(prm)
    kap_at = _kap_lookup(track, dev)
    core = mpc_core_plain(cfg, scfg, carry.x, pv, kap_at, carry, megastep_refs(cfg, x_ref, carry),
                          _make_consts(cfg, scfg, dev), eyb, cache)
    X_pred, U_pred, s_f, lam_f, u0, diag = core[:6]

    # 9. plant: fine Euler sub-steps
    s_idx, _ = model_s_ey(cfg.model)
    h = float(cfg.dt) / n_sub
    x = carry.x
    for _ in range(n_sub):
        x = x + h * f_model_bl(cfg.model, pv, x, u0, kap_at(x[s_idx]), sim_tire or cfg.tire)

    new = MegaCarry(x=x, X_pred=X_pred, U_pred=U_pred, s=s_f, lam=lam_f, u_prev=u0, rho=diag[3])
    return (new, u0, diag) + core[6:]


_TRACK_INPUTS = weakref.WeakKeyDictionary()   # Track -> {device: (kappa, [length, 1/ds])}


def _track_inputs(track: Track, device):
    """The kernel's curvature table and [length, 1/ds], prepared once per
    track and device (a track is immutable), so a step spends no host work
    on them."""
    per_dev = _TRACK_INPUTS.setdefault(track, {})
    key = torch.device(device)
    if key not in per_dev:
        per_dev[key] = (track.kappa.to(dtype=torch.float32, device=device).contiguous(),
                        torch.stack([track.length, 1.0 / track.ds]).to(dtype=torch.float32, device=device))
    return per_dev[key]


def _check_cuda_operands(carry: MegaCarry, prm, N: int, nx: int):
    B = carry.x.shape[-1]
    want = {"x": (nx, B), "X_pred": (N + 1, nx, B), "U_pred": (N, NU, B), "s": (N + 1, NC, B),
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

    ``eyb`` (N+1, 2, B), optional, replaces the e_y row's bounds per stage.
    With ``scfg.cache_build`` pass (and thread) a :class:`MegaCache`.
    Returns (new_carry, u0 (NU, B), diag (5, B): r_prim, r_dual,
    converged, rho_next, iters — the done-at iteration), and the new cache
    after them with ``cache_build``."""
    dev = carry.x.device
    if dev.type == "cpu":
        return megastep_plain(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache)
    if dev.type != "cuda":
        raise ValueError(f"megastep: carry on {dev}; expected cpu or cuda")
    return _megastep_cuda(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache)


def _megastep_cuda(cfg, scfg, track, prm, x_ref, carry, n_sub, sim_tire, eyb, cache):
    """Launch the kernel on the carry's device (one launch per step). While
    a profiler records: the spans ``megastep.check``, ``.refs`` and
    ``.alloc``, and the traced instantiation (without a cache) adds into the
    section counters."""
    on = profiling.tracing()
    dev = carry.x.device
    N = cfg.N
    nx, _ = model_dims(cfg.model)
    B = carry.x.shape[-1]
    with profiling.span("megastep.check", on):
        _check_supported(cfg, scfg, cache, eyb, B)
        _check_cuda_operands(carry, prm, N, nx)
        sim_tire = sim_tire or cfg.tire
        if cfg.tire not in TIRES or sim_tire not in TIRES:
            raise ValueError(f"megastep: unknown tire {cfg.tire!r} / {sim_tire!r}")
    kw = dict(dtype=torch.float32, device=dev)
    with profiling.span("megastep.refs", on):
        xref = megastep_refs(cfg, x_ref, carry)
        kappa, taux = _track_inputs(track, dev)
        # the corridor pointer is null without one: the kernel then keeps the box
        ins = [carry.x, carry.X_pred, carry.U_pred, carry.s, carry.lam, carry.u_prev,
               carry.rho, xref, prm, kappa, taux, eyb]
    with profiling.span("megastep.alloc", on):
        out = MegaCarry(
            x=torch.empty((nx, B), **kw), X_pred=torch.empty((N + 1, nx, B), **kw),
            U_pred=torch.empty((N, NU, B), **kw), s=torch.empty((N + 1, NC, B), **kw),
            lam=torch.empty((N + 1, NC, B), **kw), u_prev=torch.empty((NU, B), **kw),
            rho=None,
        )
        stats = torch.empty((8, B), **kw)
        ws_rows = core_workspace(N, cfg.model)
        ws = torch.empty((ws_rows, B), **kw)
        # the cache's pointers are null without one; with one the kernel reads
        # the old cache and writes a new one (the shift reads stage k+1 where
        # another thread writes stage k, so the two never alias)
        cache_out = None if cache is None else MegaCache(*(torch.empty(t.shape, **kw) for t in cache))
        cache_ptrs = [None] * 12 if cache is None else [t.contiguous() for t in cache] + list(cache_out)
        # the cached instantiation keeps no section counters
        sec = profiling.section_buffer("megastep_kernel", dev, on and cache is None)
    _cuda.launch(
        "arl_megastep",
        [t if t is None else t.contiguous() for t in ins]
        + [out.x, out.X_pred, out.U_pred, out.s, out.lam, out.u_prev, stats, ws] + cache_ptrs,
        core_floats(cfg, scfg) + (float(scfg.cache_drift_tol),),
        [B, N, track.n_cells, n_sub, scfg.max_iter, max(1, scfg.check_termination),
         int(scfg.early_exit), TIRES[cfg.tire], TIRES[sim_tire], int(cfg.kappa_speed_cap),
         ws_rows, *launch_shape(N, cfg.model).ints(), int(scfg.cache_max_age), MODELS[cfg.model]],
        counters=(sec,), trace=on,
    )
    if cache is None:
        megastep.launches += 1
    else:
        megastep.cached_launches += 1
    _cuda.check_outputs("arl_megastep", *(t for t in out if t is not None), stats[:5], *(cache_out or ()))
    new = out._replace(rho=stats[3])
    return (new, out.u_prev, stats[:5]) + (() if cache is None else (cache_out,))


megastep.launches = 0          # kernel launches without a cache (CPU calls never count)
megastep.cached_launches = 0   # launches of the cached instantiation

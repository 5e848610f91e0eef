"""Lap-over-lap reference learning (the JAX package's
``loop/lap_learning.py``): after a lap, the realized trajectory is binned
onto the reference table's s-grid and the velocity profile, racing line and
steering feed-forward are updated by an iterative-learning rule, so lap
time drops lap over lap toward the friction limit.

Update rule per grid node i visited by the lap:

- clean (binned |a_lat| within the friction budget, the car near the
  commanded line, the solver converging): vx_i <- realized vx + gain *
  headroom to the curvature speed limit sqrt(a_frac mu g / |kappa_i|);
- violated: vx_i <- shrink * realized vx;
- unvisited: keep the previous reference.

The raw profile is then made longitudinally consistent with circular
forward (accel-limited) and backward (braking-limited) v^2 sweeps and a
small circular smoothing stencil.

:func:`learn_from_lap` is written for a batch of lanes: a per-lane table
(channels (B, n)), X (B, T, nx), U (B, T, nu), converged (B, T) and a mu
per lane update B tables in one call (the JAX package ``vmap``s the
single-car function); an unbatched table with X (T, nx) is the single-car
form. The binning is a ``scatter_add_`` along the node axis (JAX's
``segment_sum``), with JAX's cell expression ``(sm / ds)`` truncated and
clipped. Each circular sweep of the accel filter, the recurrence
``v_i <- min(v_i, sqrt(v_{i-1}^2 + 2 a ds))``, is min-plus linear in v^2
and is evaluated in closed form with one ``torch.cummin`` per wrap (in
float64, then rounded to float32) instead of n dependent steps.

Rollouts: :func:`iterative_lap_learning` (one car, ``closed_loop``),
:func:`batched_lap_learning` (``backend="plain"``: the batched
``closed_loop``; ``"mega"``: :func:`mega_lap_rollout`, one megastep launch
per step, the kernel on CUDA tensors, with per-lane references sampled from
per-lane tables).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import FIELDS, MPCConfig, SolverConfig, VehicleParams, _Replace, broadcast_params
from ..planner.reftable import RefTable, refs_from_table
from ..track.track import Track, curvature_at
from .closed_loop import ClosedLoopLog, closed_loop


@dataclasses.dataclass(frozen=True)
class LapLearnConfig(_Replace):
    """Knobs of the lap-over-lap reference update."""

    gain: float = 0.6        # fraction of the speed headroom added when clean
    shrink: float = 0.92     # vx backoff factor where limits were violated
    dv_max: float = 0.6      # max vx increase per node per lap [m/s]
    a_lat_frac: float = 0.85  # usable fraction of the friction circle
    ey_tol: float = 0.10     # |e_y - ey_ref| above this counts as a violation
    beta_line: float = 0.35  # racing-line / delta_ff learning rate
    v_floor: float = 0.5     # never command below this [m/s]
    # obstacle memorization: the learned line is projected clear of every
    # obstacle band by obs_margin, ramped in over obs_lead metres before and
    # after the block so that the car pre-positions outside the tracker's
    # short preview
    obs_margin: float = 0.06
    obs_lead: float = 1.5


class LapLearnLog(NamedTuple):
    lap_steps: torch.Tensor  # (n_laps,) or (n_laps, B) steps per lap (T+1 if DNF), int64, host
    tables_vx: torch.Tensor  # (n_laps + 1, n) or (n_laps + 1, B, n) vx profile before each lap
    table: RefTable          # final learned table (per lane for the batched form)
    last_log: NamedTuple     # the final lap's rollout log


class LapRollout(NamedTuple):
    """A lap of :func:`mega_lap_rollout`, batch-first."""

    X: torch.Tensor          # (B, T, nx) states after each step
    U: torch.Tensor          # (B, T, nu) applied controls
    converged: torch.Tensor  # (B, T)


def initial_table(track: Track, ds: float = 0.05, vx0: float = 1.0) -> RefTable:
    """Conservative flat-speed centerline table to seed the learner."""
    L = float(track.length)
    n = max(int(round(L / ds)), 8)
    kw = dict(dtype=torch.float32, device=track.kappa.device)
    return RefTable(
        ds=torch.tensor(L / n, **kw),
        length=torch.tensor(L, **kw),
        vx=torch.full((n,), vx0, **kw),
        ey=torch.zeros((n,), **kw),
        delta=torch.zeros((n,), **kw),
    )


def per_lane_table(table: RefTable, B: int) -> RefTable:
    """A shared table as B per-lane copies: every channel (B, n), ds and
    length (B,)."""
    return RefTable(*(getattr(table, f.name).expand((B,) + tuple(getattr(table, f.name).shape)).contiguous()
                      for f in dataclasses.fields(RefTable)))


def _wraps_needed(v_max: float, a: float, L: float) -> int:
    """Circular sweeps for the accel filter to reach its fixed point:
    braking between 0 and ``v_max`` spans at most v_max^2 / (2 a) metres,
    and each wrap propagates one track length (minimum 2)."""
    span = v_max * v_max / (2.0 * max(a, 1e-6))
    return max(2, int(np.ceil(span / max(L, 1e-6))))


def _filter_wraps(cfg: MPCConfig, track: Track) -> int:
    b = cfg.bounds
    return _wraps_needed(float(b.vx_max), min(float(b.a_max), -float(b.a_min)), float(track.length))


def _curv_stencil(table: RefTable) -> int:
    """Line-curvature stencil half-width: ~0.25 m of grid (min 1 node)."""
    return max(1, int(round(0.25 / float(table.ds.reshape(-1)[0]))))


def _col(v):
    """A per-lane (B,) tensor as (B, 1); a float or 0-d tensor as it is."""
    return v.reshape(-1, 1) if isinstance(v, torch.Tensor) and v.dim() >= 1 else v


def _sweep(v: torch.Tensor, k: torch.Tensor, wraps: int) -> torch.Tensor:
    """``wraps`` circular passes of v_i <- min(v_i, sqrt(v_{i-1}^2 + k)),
    each pass starting from the profile's last node. In w = v^2 one pass is
    w_i = min(u_i, w_{i-1} + k) with w_{-1} = u_{n-1}, whose solution is
    w_i = i k + min(u_{n-1} + k, min_{j<=i}(u_j - j k))."""
    i = torch.arange(v.shape[-1], dtype=torch.float64, device=v.device)
    k = k.to(torch.float64)
    for _ in range(wraps):
        u = v.to(torch.float64) ** 2
        run = torch.cummin(u - i * k, dim=-1).values
        w = i * k + torch.minimum(u[..., -1:] + k, run)
        v = torch.sqrt(w).to(torch.float32)
    return v


def _accel_limit_circular(v, ds, a_acc, a_brake, wraps: int = 2):
    """Longitudinal-consistency filter on circular v(s) profiles (..., n):
    the forward pass caps acceleration (v_{i+1}^2 <= v_i^2 + 2 a_acc ds),
    the backward pass braking (v_i^2 <= v_{i+1}^2 + 2 a_brake ds), each run
    ``wraps`` times around the loop (:func:`_wraps_needed`). ``ds`` is a
    float, a 0-d tensor or one per lane, (B, 1)."""
    ds = torch.as_tensor(ds, dtype=torch.float32, device=v.device)
    v = _sweep(v, (2.0 * a_acc) * ds, wraps)
    return _sweep(v.flip(-1), (2.0 * a_brake) * ds, wraps).flip(-1)


def _memorize_obstacles(p: VehicleParams, cfg: MPCConfig, llcfg: LapLearnConfig, track: Track,
                        table: RefTable, ey: torch.Tensor, blocks, ey_room):
    """Project the learned racing line (..., n) clear of every obstacle band.

    The line converges to the realized pass, which hugs the block edge; the
    commanded line must clear the band by ``obs_margin``, ramped in over
    ``obs_lead`` metres before the block and out after it. The side is the
    tracker corridor's (``engine.assembly.corridor_from_blocks``: the
    widest usable side, the inside of a corner counted only out to the
    steerable offset). Blocks apply one after another; padding rows (s0 >
    s1) never match."""
    from ..engine.assembly import block_curvatures, steerable_curvature

    blocks = torch.as_tensor(blocks, dtype=torch.float32, device=ey.device)
    ey_room = torch.as_tensor(ey_room, dtype=torch.float32, device=ey.device)
    n = ey.shape[-1]
    ds, L = _col(table.ds), _col(table.length)
    grid_s = torch.arange(n, dtype=torch.float32, device=ey.device) * ds
    lead = max(float(np.float32(llcfg.obs_lead)), 1e-3)
    margin = llcfg.obs_margin
    kap_blk = block_curvatures(track, blocks)
    kap_cap = steerable_curvature(broadcast_params(p, 2), cfg.bounds.delta_max)
    for i in range(blocks.shape[0]):
        s0, s1, o_lo, o_hi = (blocks[i, j] for j in range(4))
        span = s1 - s0                       # negative for padding rows
        a = s0 - lead
        sm = grid_s - a - L * torch.floor((grid_s - a) / L)
        inside = (span >= 0.0) & (sm <= span + 2.0 * lead)
        # a bounded-slope ramp 0 -> 1 over the lead-in, 1 through the
        # block, 1 -> 0 over the lead-out: a step would become a heading
        # reference spike through refs_from_table's slope term
        ramp = torch.clamp(torch.minimum(sm, span + 2.0 * lead - sm) / lead, 0.0, 1.0)
        k = kap_blk[i]
        ak = torch.clamp_min(torch.abs(k), 1e-6)
        ey_in = torch.clamp((1.0 - ak / kap_cap) / ak, -ey_room, ey_room)
        up_lim = torch.where(k > 1e-3, torch.minimum(ey_room, ey_in), ey_room)
        dn_lim = torch.where(k < -1e-3, torch.minimum(ey_room, ey_in), ey_room)
        up_w = up_lim - (o_hi + margin)
        dn_w = (o_lo - margin) + dn_lim
        up = up_w >= dn_w
        target = torch.where(up, o_hi + margin, o_lo - margin)
        # interpolate from the learned line to the full-clearance projection
        pushed = torch.where(up, torch.maximum(ey, target), torch.minimum(ey, target))
        ey = torch.where(inside, ey + ramp * (pushed - ey), ey)
    return torch.clamp(ey, -ey_room, ey_room)


def _smooth(a):
    return 0.25 * torch.roll(a, 1, -1) + 0.5 * a + 0.25 * torch.roll(a, -1, -1)


def learn_from_lap(p: VehicleParams, cfg: MPCConfig, llcfg: LapLearnConfig, track: Track,
                   table: RefTable, X: torch.Tensor, U: torch.Tensor, wraps: int = 2,
                   obstacles=None, curv_k: int = 1, converged=None) -> RefTable:
    """One ILC update of the reference table from a realized lap.

    Single car: ``table`` with (n,) channels, X (T, nx), U (T, nu),
    ``converged`` (T,). Batched: channels (B, n) (ds and length (B,) or
    0-d), X (B, T, nx), U (B, T, nu), ``converged`` (B, T), and ``p.mu`` a
    float or (B,): lane b is updated at its own friction. ``obstacles``
    (n_obs, 4) corridor blocks are shared by the lanes; ``wraps`` and
    ``curv_k`` are the accel filter's passes and the line-curvature stencil
    half-width (:func:`_wraps_needed`, :func:`_curv_stencil`)."""
    if table.vx.dim() == 1:
        lane = lambda a: None if a is None else a[None]
        out = learn_from_lap(p, cfg, llcfg, track, RefTable(table.ds, table.length, table.vx[None],
                                                            table.ey[None], table.delta[None]),
                             X[None], U[None], wraps, obstacles, curv_k, lane(converged))
        return table.replace(vx=out.vx[0], ey=out.ey[0], delta=out.delta[0])
    Bn, n = table.vx.shape
    dyn = cfg.model == "dynamic"
    s_idx, ey_i = (4, 5) if dyn else (2, 3)
    s, vx, ey = X[..., s_idx], X[..., 0], X[..., ey_i]
    # lateral accel: measured vx*wz for the dynamic model, kinematic
    # steady-state vx^2 kappa otherwise
    a_lat = vx * X[..., 2] if dyn else vx * vx * curvature_at(track, s)
    ds, L = _col(table.ds), _col(table.length)

    # bin every sample onto its node: all channels in one scatter
    sm = s - L * torch.floor(s / L)
    idx = torch.clamp((sm / ds).to(torch.int32), 0, n - 1).long()
    chans = [torch.ones_like(vx), vx, ey, torch.abs(a_lat), U[..., 0]]
    if converged is not None:
        chans.append(torch.as_tensor(converged).to(vx.dtype))
    vals = torch.stack(chans, dim=1)                                   # (B, C, T)
    sums = vals.new_zeros((Bn, len(chans), n)).scatter_add_(2, idx[:, None].expand_as(vals), vals)
    cnt = sums[:, 0]
    means = sums[:, 1:] / torch.clamp_min(cnt, 1.0)[:, None]
    vx_m, ey_m, al_m, de_m = means[:, 0], means[:, 1], means[:, 2], means[:, 3]
    visited = cnt > 0.0

    # ---- racing line first (the speed limit below reads its curvature)
    ey_room = track.width / 2.0 - 0.05
    beta = llcfg.beta_line
    blend = lambda old, new: torch.where(visited, (1.0 - beta) * old + beta * new, old)
    ey_new = torch.clamp(_smooth(blend(table.ey, ey_m)), -ey_room, ey_room)
    if obstacles is not None:
        ey_new = _memorize_obstacles(p, cfg, llcfg, track, table, ey_new, obstacles, ey_room)
    dmax = cfg.bounds.delta_max
    de_new = torch.clamp(_smooth(blend(table.delta, de_m)), -dmax, dmax)

    # node-local friction speed limit from the commanded path's curvature:
    # the track's at the node positions s = i*ds plus |e_y''| of the line
    # over a ~0.25 m stencil, a conservative bound that only tightens
    grid_s = torch.arange(n, dtype=torch.float32, device=vx.device) * ds
    kap = curvature_at(track, grid_s)
    k = max(1, curv_k)
    ey2 = (torch.roll(ey_new, -k, -1) - 2.0 * ey_new + torch.roll(ey_new, k, -1)) / ((k * ds) ** 2)
    kap_eff = torch.abs(kap) + torch.abs(ey2)
    pb = broadcast_params(p, 2)
    a_cap = llcfg.a_lat_frac * pb.mu * pb.g
    kap_floor = a_cap / cfg.bounds.vx_max ** 2
    v_lim = torch.sqrt(a_cap / (torch.maximum(kap_eff, kap_floor) if isinstance(kap_floor, torch.Tensor)
                                else torch.clamp_min(kap_eff, kap_floor)))

    viol = (al_m > a_cap) | (torch.abs(ey_m - table.ey) > llcfg.ey_tol) | (torch.abs(ey_m) > ey_room)
    if converged is not None:
        # solver stress counts as a violation: where the tracker's QP
        # stopped converging the commanded profile has outrun feasibility
        viol = viol | (means[:, 4] < 0.8)
    headroom = torch.clamp(v_lim - vx_m, 0.0, llcfg.dv_max)
    v_cand = torch.where(viol, llcfg.shrink * vx_m, vx_m + llcfg.gain * headroom)
    v_new = torch.where(visited, v_cand, table.vx)
    v_new = torch.minimum(v_new, v_lim)     # the cap binds even off-policy
    v_new = _smooth(torch.clamp(v_new, llcfg.v_floor, cfg.bounds.vx_max))
    # consistency last, so the emitted profile respects the accel limits
    v_new = _accel_limit_circular(v_new, ds, cfg.bounds.a_max, -cfg.bounds.a_min, wraps=wraps)
    return table.replace(vx=v_new, ey=ey_new, delta=de_new)


def lap_steps(cfg: MPCConfig, track: Track, X: torch.Tensor, T: int, s0=None) -> torch.Tensor:
    """Steps until the arc length has crossed one track length from the lap
    start, for X (..., T, nx): X[..., k, :] is the state after control step
    k+1, so with the start state's arc length ``s0`` (a float or (...,))
    the count includes the first step's progress (without ``s0``: measured
    from X[..., 0, :]). A lap not completed returns ``T + 1``."""
    s_idx = 4 if cfg.model == "dynamic" else 2
    s = X[..., s_idx]
    start = s[..., :1] if s0 is None else torch.as_tensor(s0, dtype=s.dtype, device=s.device)[..., None]
    done = (s - start) >= track.length
    first = torch.argmax(done.to(torch.int32), dim=-1) + 1
    return torch.where(done.any(dim=-1), first, torch.full_like(first, T + 1))


def iterative_lap_learning(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                           x0: torch.Tensor, n_laps: int, T_lap: int,
                           llcfg: Optional[LapLearnConfig] = None, table0: Optional[RefTable] = None,
                           sim_tire: Optional[str] = None, obstacles=None) -> LapLearnLog:
    """Run ``n_laps`` laps of one car, updating the table after each.

    Every lap restarts from ``x0`` (nx,) and follows the current table
    through ``closed_loop``; the update between laps is
    :func:`learn_from_lap`. With static ``obstacles`` (corridor blocks) the
    line learning memorizes the avoidance line into the table."""
    llcfg = llcfg or LapLearnConfig()
    table = table0 if table0 is not None else initial_table(track)
    wraps, curv_k = _filter_wraps(cfg, track), _curv_stencil(table)
    s_idx = 4 if cfg.model == "dynamic" else 2
    laps, vx_hist, log = [], [table.vx], None
    for _ in range(n_laps):
        log_b = closed_loop(p, cfg, scfg, track, x0[None], table, T=T_lap, sim_tire=sim_tire,
                            obstacles=obstacles)
        log = ClosedLoopLog(*(a[:, 0] for a in log_b))
        laps.append(lap_steps(cfg, track, log.X, T_lap, s0=x0[s_idx]))
        table = learn_from_lap(p, cfg, llcfg, track, table, log.X, log.U, wraps=wraps,
                               obstacles=obstacles, curv_k=curv_k, converged=log.converged)
        vx_hist.append(table.vx)
    return LapLearnLog(lap_steps=torch.stack(laps).cpu(), tables_vx=torch.stack(vx_hist), table=table,
                       last_log=log)


def batched_refs_from_tables(cfg: MPCConfig, table_b: RefTable, s_sched: torch.Tensor) -> torch.Tensor:
    """(N+1, nx, B) batch-last references for the megastep from per-lane
    tables (channels (B, n)) along the (N+1, B) scheduled arc length."""
    return refs_from_table(cfg, table_b, s_sched.T).permute(1, 2, 0).contiguous()


def _first_lane(p: VehicleParams) -> VehicleParams:
    """The first lane's parameters (0-d tensors where a leaf is per lane)."""
    pick = lambda v: v.reshape(-1)[0] if isinstance(v, torch.Tensor) else v
    return VehicleParams(**{f: pick(getattr(p, f)) for f in FIELDS})


def mega_lap_rollout(p_b: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track, T_lap: int,
                     sim_tire: Optional[str] = None, n_sub: int = 10, obstacles=None):
    """``run(x0_b, table_b) -> LapRollout``: a whole lap of B cars on the
    megastep, one launch per step (the kernel on CUDA tensors), each lane
    following its own table (channels (B, n)).

    Per step the host samples each lane's (N+1, nx) reference along its
    scheduled s ``[x, X_pred[2:], X_pred[N]]`` (:func:`batched_refs_from_tables`)
    and, with static ``obstacles`` ((n_obs, 4) corridor blocks), the kernel's
    (N+1, 2, B) e_y corridor ``eyb`` along the same s
    (``loop.race.corridor_eyb``, the first lane's steerable curvature).
    Outputs are batch-first, as the learner consumes them."""
    from ..ops.megastep_kernel import megastep, megastep_init, megastep_params
    from .race import corridor_eyb

    s_idx = 4 if cfg.model == "dynamic" else 2
    eyb_of = None
    if obstacles is not None:
        eyb_of = corridor_eyb(_first_lane(p_b), cfg, track, obstacles, device=track.kappa.device)

    def run(x0_b: torch.Tensor, table_b: RefTable) -> LapRollout:
        x0_b = x0_b.to(torch.float32)
        B = x0_b.shape[0]
        prm = megastep_params(p_b, B, device=x0_b.device)
        car = megastep_init(p_b, cfg, track, x0_b)
        xs, us, cs = [], [], []
        for _ in range(T_lap):
            s_sched = torch.cat([car.x[s_idx][None], car.X_pred[2:, s_idx], car.X_pred[-1:, s_idx]])
            xref = batched_refs_from_tables(cfg, table_b, s_sched)
            eyb = None if eyb_of is None else eyb_of(car.x[s_idx], car.X_pred[:, s_idx])
            car, u0, diag = megastep(cfg, scfg, track, prm, xref, car, n_sub=n_sub, sim_tire=sim_tire,
                                     eyb=eyb)
            xs.append(car.x)
            us.append(u0)
            cs.append(diag[2])
        bf = lambda a: a.movedim(-1, 0)          # (T, ., B) -> (B, T, .)
        return LapRollout(X=bf(torch.stack(xs)), U=bf(torch.stack(us)), converged=bf(torch.stack(cs)))

    return run


def batched_lap_learning(p_b: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                         x0_b: torch.Tensor, n_laps: int, T_lap: int,
                         llcfg: Optional[LapLearnConfig] = None, table0: Optional[RefTable] = None,
                         sim_tire: Optional[str] = None, obstacles=None,
                         backend: str = "plain") -> LapLearnLog:
    """Learn B cars' profiles in parallel: each lane (``p_b`` leaves floats
    or (B,), e.g. a friction sweep) starts every lap from its row of
    ``x0_b`` (B, nx) and learns its own table from the shared seed
    ``table0``.

    ``backend``: "plain" (the JAX "xla") rolls each lap through the batched
    ``closed_loop``; "mega" through :func:`mega_lap_rollout` (one megastep
    launch per step, the kernel on CUDA tensors). Static ``obstacles``
    behave as in :func:`iterative_lap_learning`. ``lap_steps`` is (n_laps,
    B), ``tables_vx`` (n_laps + 1, B, n)."""
    if backend not in ("plain", "mega"):
        raise ValueError(f"batched_lap_learning backend {backend!r}: expected 'plain' or 'mega'")
    llcfg = llcfg or LapLearnConfig()
    x0_b = x0_b.to(torch.float32)
    B = x0_b.shape[0]
    one = table0 if table0 is not None else initial_table(track)
    table = per_lane_table(one, B)
    wraps, curv_k = _filter_wraps(cfg, track), _curv_stencil(one)
    s_idx = 4 if cfg.model == "dynamic" else 2
    if backend == "mega":
        rollout = mega_lap_rollout(p_b, cfg, scfg, track, T_lap, sim_tire=sim_tire, obstacles=obstacles)
        run_lap = lambda tbl: rollout(x0_b, tbl)
    else:
        def run_lap(tbl):
            log = closed_loop(p_b, cfg, scfg, track, x0_b, tbl, T=T_lap, sim_tire=sim_tire,
                              obstacles=obstacles)
            return ClosedLoopLog(*(a.movedim(0, 1) for a in log))
    laps, vx_hist, log = [], [table.vx], None
    for _ in range(n_laps):
        log = run_lap(table)
        laps.append(lap_steps(cfg, track, log.X, T_lap, s0=x0_b[:, s_idx]))
        table = learn_from_lap(p_b, cfg, llcfg, track, table, log.X, log.U, wraps=wraps,
                               obstacles=obstacles, curv_k=curv_k, converged=log.converged)
        vx_hist.append(table.vx)
    return LapLearnLog(lap_steps=torch.stack(laps).cpu(), tables_vx=torch.stack(vx_hist), table=table,
                       last_log=log)

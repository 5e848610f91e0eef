"""The composed race loop (the JAX package's ``loop/race.py``): every
deployment subsystem in one closed loop, per control period

    world-frame truth -> windowed global->Frenet measurement + sensor noise
    -> EKF at mu-hat -> friction RLS -> warm-started tracker at mu-hat
    -> world-frame plant at each lane's true mu.

Two forms of the same step:

- :func:`batched_race_sweep` composes the modules (``estimate_frenet``,
  ``ekf_step``, ``friction_step``, ``mpc_step_batched``,
  ``global_plant_step``) with the batch as the leading dim, where the JAX
  version ``vmap``s a ``lax.scan`` segment;
- :func:`make_racestep_scan` / :func:`mega_race_sweep` run every step as
  one racestep launch (``ops.racestep``: the CUDA kernel for CUDA tensors,
  its plain version for CPU tensors), batch-last.

:func:`race_loop` is the flagship program: a single car racing T steps
with the MPP planner re-planning a receding horizon every ``replan_every``
steps from the EKF's state at the live mu-hat, its segments on either form.

Obstacle corridor blocks ((n_obs, 4), ``planner.opponents``) reach the
tracker's e_y row in both: through ``tracker_bounds`` in the module
composition, and as the racestep's per-stage ``eyb`` operand, evaluated by
``engine.assembly.corridor_from_blocks`` along each step's scheduled s.

Randomness: the JAX ``key=`` becomes ``seed=`` (a ``torch.Generator`` on the
carry's device seeded with it) or ``generator=``. The streams differ from
``jax.random``'s, so noisy runs agree with the JAX package in distribution,
not sample for sample; tests hand both sides the same numpy noise.

Not ported yet: ``race_loop``'s lap-learning mode (``ilc_every > 0``) and
its ``obs_tracker_lead``, ``mega_race_learn`` (lap learning),
``checkpointed_race_sweep`` (orbax).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, MPPConfig, SolverConfig, VehicleParams
from ..engine.assembly import block_curvatures, corridor_from_blocks, steerable_curvature
from ..planner.mpp import plan_mpp
from ..planner.opponents import pad_blocks
from ..planner.reftable import RefTable
from ..track.track import Track, frenet_to_global, wrap_s
from .estimator import DEFAULT_EKF_Q, EKFState, ekf_init, ekf_step
from .friction import FrictionState, friction_init, friction_step
from .global_loop import estimate_frenet, global_plant_step
from .mpc import MPCCarry, mpc_init, mpc_step_batched


class RaceCarry(NamedTuple):
    """Cross-step state of the composed loop, batch-first."""

    xg: torch.Tensor         # (B, 6) world-frame plant state (truth)
    mpc: MPCCarry            # tracker warm start + scheduling trajectory
    ekf: EKFState            # estimator mean/covariance (Frenet, unwrapped s)
    fric: FrictionState      # mu-hat RLS state, (B,) leaves
    x_prev_f: torch.Tensor   # (B, 6) previous filtered state (friction residual)
    u_prev: torch.Tensor     # (B, 2) last applied control (EKF predict input)
    generator: Optional[torch.Generator]   # sensor-noise stream (None: clean)


class BatchedRaceLog(NamedTuple):
    Xg: torch.Tensor         # (B, T, 6) true world states
    Xf: torch.Tensor         # (B, T, 6) filtered states fed to the MPC
    U: torch.Tensor          # (B, T, 2)
    mu_hat: torch.Tensor     # (B, T)
    converged: torch.Tensor  # (B, T)


def _ekf_r(noise_sigma) -> np.ndarray:
    sig = np.zeros(6, np.float32) if noise_sigma is None else np.asarray(noise_sigma, np.float32)
    return np.where(sig > 0, sig ** 2, 1e-4).astype(np.float32)


def _make_segment(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track, T_seg: int,
                  mu_true: float, mu0: float, sim_tire: str, n_sub: int, noise_sigma,
                  use_ekf: bool, adapt_mu: bool, ekf_q):
    """``run(carry, table, obstacles=None, mu_plant=None)``: ``T_seg``
    composed steps of the module composition. ``obstacles`` ((n_obs, 4)
    corridor blocks) reach the tracker's e_y row; ``mu_plant`` (B,)
    overrides the plant friction per lane. Returns (carry, outs) with outs =
    (Xg, Xf, Z, U, mu_hat, converged, iters, r_prim), each stacked (T_seg,
    B, ...).

    The EKF's R is the JAX composition's: diag(noise_sigma^2) whenever
    ``noise_sigma`` is given, zero channels included, and 1e-4 I only
    without it (the racestep's kernel form floors zero channels at 1e-4
    instead, as in the JAX package). The tracker's infeasibility
    certificate is a diagnostic this log does not carry, so it is switched
    off here."""
    scfg = scfg.replace(certify_infeasibility=False)
    Rn_diag = (np.asarray(noise_sigma, np.float32) ** 2 if noise_sigma is not None
               else np.full(6, 1e-4, np.float32))
    if noise_sigma is not None and not np.any(np.asarray(noise_sigma) > 0):
        noise_sigma = None             # nothing to draw

    def run(carry: RaceCarry, table: RefTable, obstacles=None, mu_plant=None):
        dev = carry.xg.device
        f32 = dict(dtype=torch.float32, device=dev)
        B = carry.xg.shape[0]
        Qn = torch.diag(torch.as_tensor(np.asarray(ekf_q, np.float32), **f32))
        Rn = torch.diag(torch.as_tensor(Rn_diag, **f32))
        mu_p = mu_true if mu_plant is None else mu_plant
        p_plant = p.replace(mu=torch.as_tensor(mu_p, **f32).expand(B))
        sig = None if noise_sigma is None else torch.as_tensor(np.asarray(noise_sigma, np.float32), **f32)
        blocks = None if obstacles is None else torch.as_tensor(obstacles, **f32)
        c, outs = carry, []
        for _ in range(T_seg):
            z = estimate_frenet(track, c.xg, s_hint=c.ekf.x[:, 4])
            if sig is not None:
                z = z + sig * torch.randn(z.shape, generator=c.generator, **f32)
            mu_ctrl = c.fric.mu if adapt_mu else torch.full((B,), mu0, **f32)
            p_hat = p.replace(mu=mu_ctrl)
            if use_ekf:
                ekf2 = ekf_step(p_hat, cfg, track, c.ekf, c.u_prev, z, Qn, Rn)
                xf = ekf2.x
            else:
                ekf2, xf = EKFState(x=z, P=c.ekf.P), z
            fric2 = friction_step(p, c.fric, c.x_prev_f, xf, c.u_prev, cfg.dt) if adapt_mu else c.fric
            u, mpc2, diag = mpc_step_batched(p_hat, cfg, scfg, track, xf, table, c.mpc, blocks)
            xg2 = global_plant_step(p_plant, cfg, c.xg, u, n_sub=n_sub, sim_tire=sim_tire)
            c = RaceCarry(xg=xg2, mpc=mpc2, ekf=ekf2, fric=fric2, x_prev_f=xf, u_prev=u,
                          generator=c.generator)
            outs.append((xg2, xf, z, u, fric2.mu, diag.converged.to(torch.float32),
                         diag.iters.to(torch.float32), diag.r_prim))
        return c, tuple(torch.stack(col) for col in zip(*outs))

    return run


def _generator(device, seed: int, generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a new one on ``device`` seeded with ``seed`` (the
    JAX ``key=jax.random.PRNGKey(seed)``)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(int(seed))


def batched_race_sweep(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                       table: RefTable, x0_b: torch.Tensor, T: int, mu_true_b, mu0: float = 1.0,
                       noise_sigma=None, seed: int = 0, generator: Optional[torch.Generator] = None,
                       use_ekf: bool = True, adapt_mu: bool = True, sim_tire: str = "pacejka",
                       n_sub: int = 10, ekf_q=None) -> BatchedRaceLog:
    """Monte-Carlo of the composed stack by module composition: B cars,
    each with its own plant friction ``mu_true_b`` (B,), sensor noise, EKF,
    friction RLS and warm-started tracker, following a shared table.
    ``x0_b`` (B, 6) are the initial true Frenet states."""
    if cfg.model != "dynamic":
        raise ValueError("the composed sweep needs the dynamic model")
    x0_b = x0_b.to(torch.float32)
    dev = x0_b.device
    B = x0_b.shape[0]
    if ekf_q is None:
        ekf_q = np.asarray(DEFAULT_EKF_Q, np.float32)
    segment = _make_segment(p, cfg, scfg, track, T, mu0, mu0, sim_tire, n_sub, noise_sigma,
                            use_ekf, adapt_mu, ekf_q)
    Xw, Yw, psiw = frenet_to_global(track, x0_b[:, 4], x0_b[:, 5], x0_b[:, 3])
    carry = RaceCarry(
        xg=torch.stack([x0_b[:, 0], x0_b[:, 1], x0_b[:, 2], Xw, Yw, psiw], dim=-1),
        mpc=mpc_init(p.replace(mu=float(mu0)), cfg, track, x0_b),
        ekf=ekf_init(x0_b), fric=friction_init(mu0, batch=(B,), device=dev),
        x_prev_f=x0_b, u_prev=torch.zeros((B, 2), dtype=torch.float32, device=dev),
        generator=_generator(dev, seed, generator),
    )
    _, (Xg, Xf, _Z, U, mu_hat, conv, _it, _r) = segment(carry, table, None, mu_true_b)
    bf = lambda a: a.movedim(0, 1)             # (T, B, ...) -> (B, T, ...)
    return BatchedRaceLog(Xg=bf(Xg), Xf=bf(Xf), U=bf(U), mu_hat=bf(mu_hat), converged=bf(conv))


def corridor_eyb(p: VehicleParams, cfg: MPCConfig, track: Track, blocks, device=None):
    """``eyb(s0, s_pred)``: the (N+1, 2, B) e_y corridor operand of the
    megastep and racestep kernels for corridor ``blocks`` (n_rows, 4), the
    JAX package's ``eyb_from_sched``. ``s0`` (B,) is the step's starting s,
    ``s_pred`` (N+1, B) the carry's predicted s; the corridor is
    ``corridor_from_blocks`` (margin 0, half-width ``ey_max``) along the
    shifted schedule ``[s0, s_pred[2:], s_pred[N]]``. The block curvatures
    are evaluated once, here."""
    blk = torch.as_tensor(blocks, dtype=torch.float32, device=device)
    kb = block_curvatures(track, blk)
    kc = steerable_curvature(p, cfg.bounds.delta_max).to(blk.device)
    half = float(cfg.bounds.ey_max)

    def eyb(s0: torch.Tensor, s_pred: torch.Tensor) -> torch.Tensor:
        sm = wrap_s(track, torch.cat([s0[None], s_pred[2:], s_pred[-1:]]))
        lo, hi = corridor_from_blocks(sm, torch.full_like(sm, -half), torch.full_like(sm, half),
                                      blk, 0.0, half, kappa_blk=kb, kappa_cap=kc)
        return torch.stack([lo, hi], dim=1)

    return eyb


def make_racestep_scan(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                       table, T: int, mu_true_b: torch.Tensor, sigma, use_ekf: bool = True,
                       adapt_mu: bool = True, sim_tire: str = "pacejka", n_sub: int = 10,
                       ekf_q=None, obstacles=None, gate_sigma: float = 0.0, n_sub_ekf: int = 4,
                       table_arg: bool = False, obstacles_arg: bool = False):
    """Build the T-step composed runner ``run(carry0, generator)`` on the
    racestep once.

    ``p``'s mu is the controller seed mu0; ``mu_true_b`` (B,) the plant
    friction per lane, on the carry's device; ``sigma`` (6,) the sensor
    noise (zeros: clean, no draw). Each step draws its (6, B) noise from
    ``generator`` on the device. ``run`` returns (carry, outs) with outs =
    (Xg, Xf, U, mu_hat, converged, Z, iters, r_prim), each stacked
    (T, ., B).

    ``table_arg=True`` returns ``run(carry0, generator, table)``: the
    reference table (shared, or per lane with (B, n) channels) comes with
    each call. ``obstacles_arg=True``, with ``table_arg``, returns
    ``run(carry0, generator, table, blocks)``: padded (n_rows, 4) corridor
    blocks per call, so that moving obstacles change between segments.
    Static ``obstacles`` apply to every call otherwise. With blocks, each
    step's e_y corridor is ``corridor_from_blocks`` (margin 0, half-width
    ``ey_max``) along the pre-step carry's scheduled s, ``[ekx[4],
    X_pred[2:, 4], X_pred[N, 4]]``, handed to the kernel as ``eyb``."""
    from ..ops.megastep_kernel import megastep_params
    from ..ops.racestep_kernel import racestep

    if obstacles_arg and not table_arg:
        raise ValueError("obstacles_arg needs table_arg: the runner is run(carry, generator, table, blocks)")
    B = mu_true_b.shape[0]
    sig_np = np.asarray(sigma, np.float32)
    ekf_r = _ekf_r(sig_np)
    if ekf_q is None:
        ekf_q = np.asarray(DEFAULT_EKF_Q, np.float32)
    noisy = bool(np.any(sig_np > 0))

    def run(carry, generator, tbl, blocks=None):
        dev = carry.xg.device
        f32 = dict(dtype=torch.float32, device=dev)
        prm = megastep_params(p, B, device=dev)
        mu_b = mu_true_b.to(**f32)
        sig = torch.as_tensor(sig_np, **f32)[:, None]
        q = torch.as_tensor(ekf_q, **f32)
        r = torch.as_tensor(ekf_r, **f32)
        zeros = torch.zeros((6, B), **f32)
        blocks = obstacles if blocks is None else blocks
        eyb_of = None if blocks is None else corridor_eyb(p, cfg, track, blocks, device=dev)
        outs = []
        for _ in range(T):
            noise = sig * torch.randn((6, B), generator=generator, **f32) if noisy else zeros
            eyb = None if eyb_of is None else eyb_of(carry.ekx[4], carry.X_pred[:, 4])
            carry, u0, diag, z = racestep(cfg, scfg, track, prm, tbl, carry, noise, mu_b, q, r,
                                          n_sub=n_sub, n_sub_ekf=n_sub_ekf, sim_tire=sim_tire,
                                          use_ekf=use_ekf, adapt_mu=adapt_mu,
                                          gate_sigma=gate_sigma, eyb=eyb)
            outs.append((carry.xg, carry.x_prev_f, u0, diag[5], diag[2], z, diag[4], diag[0]))
        return carry, tuple(torch.stack(col) for col in zip(*outs))

    if obstacles_arg:
        return run
    if table_arg:
        return lambda carry, generator, tbl: run(carry, generator, tbl)
    return lambda carry, generator: run(carry, generator, table)


def mega_race_sweep(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                    table, x0_b: torch.Tensor, T: int, mu_true_b, mu0: float = 1.0,
                    noise_sigma=None, seed: int = 0, generator: Optional[torch.Generator] = None,
                    use_ekf: bool = True, adapt_mu: bool = True, sim_tire: str = "pacejka",
                    n_sub: int = 10, ekf_q=None, obstacles=None) -> BatchedRaceLog:
    """The contract of :func:`batched_race_sweep` with every step one
    racestep launch (the kernel on CUDA tensors). The noise stream is drawn
    per step from ``generator`` (or a new one seeded with ``seed``).
    ``obstacles`` (n_obs, 4) static corridor blocks reach the kernel as its
    per-step ``eyb`` corridor."""
    from ..ops.racestep_kernel import racestep_init

    if cfg.model != "dynamic":
        raise ValueError("the composed sweep needs the dynamic model")
    x0_b = x0_b.to(torch.float32)
    dev = x0_b.device
    sig = np.zeros(6, np.float32) if noise_sigma is None else np.asarray(noise_sigma, np.float32)
    mu_b = torch.as_tensor(mu_true_b, dtype=torch.float32, device=dev)
    carry0 = racestep_init(p, cfg, track, x0_b, mu0)
    run = make_racestep_scan(p.replace(mu=float(mu0)), cfg, scfg, track, table, T, mu_b, sig,
                             use_ekf=use_ekf, adapt_mu=adapt_mu, sim_tire=sim_tire, n_sub=n_sub,
                             ekf_q=ekf_q, obstacles=obstacles)
    _, (Xg, Xf, U, mu_hat, conv, _z, _it, _r) = run(carry0, _generator(dev, seed, generator))
    bf = lambda a: a.movedim(-1, 0)            # (T, ., B) -> (B, T, .)
    return BatchedRaceLog(Xg=bf(Xg), Xf=bf(Xf), U=bf(U), mu_hat=bf(mu_hat), converged=bf(conv))


class RaceLog(NamedTuple):
    Xg: torch.Tensor           # (T, 6) true world states
    Xf: torch.Tensor           # (T, 6) filtered Frenet states fed to the MPC
    Z: torch.Tensor            # (T, 6) raw (noisy) measurements
    U: torch.Tensor            # (T, 2)
    mu_hat: torch.Tensor       # (T,)
    converged: torch.Tensor    # (T,)
    iters: torch.Tensor        # (T,)
    r_prim: torch.Tensor       # (T,) solver primal residual
    replan_steps: torch.Tensor # step index of each table update (int64, host)
    tables_vx: torch.Tensor    # (n_tables, n) vx profile after each update
    tables_ey: torch.Tensor    # (n_tables, n) racing line after each update
    lap_steps: torch.Tensor    # (n_laps,) step at which each lap completed (int64, host)


def _obstacles_at(obstacles_fn, t: int, max_rows: int, device=None):
    """The blocks visible at step t, padded to ``max_rows``, or None."""
    if obstacles_fn is None:
        return None
    obs = obstacles_fn(t)
    if obs is None:
        return None
    return torch.as_tensor(pad_blocks(obs, max_rows), device=device)


def race_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    pcfg: MPPConfig,
    track: Track,
    x0,                           # (6,) initial TRUE state, Frenet (to the track's device)
    T: int,
    mu_true: float,
    mu0: float = 1.0,
    replan_every: int = 60,
    noise_sigma=None,             # (6,) per-state sensor sigma, or None
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    use_ekf: bool = True,
    adapt_mu: bool = True,
    obstacles_fn: Optional[Callable[[int], Optional[np.ndarray]]] = None,
    max_obstacle_rows: int = 8,
    obs_tracker_lead: float = 0.0,
    mu_plan0: Optional[float] = None,   # friction for the FIRST plan only
    ilc_every: int = 0,
    sim_tire: str = "pacejka",
    n_sub: int = 10,
    plan_scfg: Optional[SolverConfig] = None,
    table0: Optional[RefTable] = None,
    ekf_q=None,
    backend: str = "plain",
) -> RaceLog:
    """Race ``T`` control steps of one car with the full stack composed:
    world-frame truth at ``mu_true`` -> noisy measurement -> EKF at mu-hat
    -> friction RLS -> tracker at mu-hat on the current table -> plant.

    Replanning mode: the MPP plans first at ``mu_plan0`` (default: the
    live mu-hat, mu0 at the start) from x0, then re-plans a receding
    horizon every ``replan_every`` steps from the EKF's state (the raw
    filtered state without the EKF) at the car's current mu-hat, so the
    estimator's friction flows into the planner's speed caps;
    ``obstacles_fn(step)`` corridors reach the planner and the tracker. A
    caller's ``table0`` replaces the first plan.

    ``backend``: "plain" (the JAX "xla") runs each segment as the module
    composition (``mpc_step`` per step); "mega" runs it on the racestep,
    one launch per step (the CUDA kernel for CUDA tensors, its plain
    version on the CPU) at B=1, with moving blocks per segment. The noise
    stream is drawn from ``generator`` (or one seeded with ``seed``); the
    two backends draw differently, so noisy runs agree in distribution.

    Lap learning (``ilc_every > 0``) and the ramped line lead-in
    (``obs_tracker_lead > 0``) need the lap learner, which is not ported:
    both raise ``NotImplementedError``.
    """
    if ilc_every > 0:
        raise NotImplementedError("race_loop's lap-learning mode (ilc_every > 0) needs "
                                  "loop/lap_learning.learn_from_lap, which is not ported yet")
    if obs_tracker_lead > 0.0:
        raise NotImplementedError("obs_tracker_lead needs the lap learner's obstacle memory "
                                  "(loop/lap_learning.py), which is not ported yet")
    if cfg.model != "dynamic":
        raise ValueError("race_loop composes the friction estimator; it needs the dynamic model")
    if cfg.model != pcfg.model:
        raise ValueError(f"tracker model {cfg.model!r} and planner model {pcfg.model!r} differ")
    if backend not in ("plain", "mega"):
        raise ValueError(f"race_loop backend {backend!r}: expected 'plain' or 'mega'")
    dev = track.kappa.device
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if ekf_q is None:
        ekf_q = np.asarray(DEFAULT_EKF_Q, np.float32)
    gen = _generator(dev, seed, generator)
    p_mu0 = p.replace(mu=float(np.float32(mu0)))
    use_mega = backend == "mega"
    x0_b = x0[None]
    if use_mega:
        from ..ops.racestep_kernel import racestep_init

        sig = np.zeros(6, np.float32) if noise_sigma is None else np.asarray(noise_sigma, np.float32)
        runner = make_racestep_scan(p_mu0, cfg, scfg, track, None, replan_every,
                                    torch.full((1,), float(mu_true), **f32), sig, use_ekf=use_ekf,
                                    adapt_mu=adapt_mu, sim_tire=sim_tire, n_sub=n_sub, ekf_q=ekf_q,
                                    table_arg=True, obstacles_arg=obstacles_fn is not None)
        mcarry = racestep_init(p, cfg, track, x0_b, mu0)
    else:
        segment = _make_segment(p, cfg, scfg, track, replan_every, mu_true, mu0, sim_tire, n_sub,
                                noise_sigma, use_ekf, adapt_mu, ekf_q)
        Xw, Yw, psiw = frenet_to_global(track, x0[4], x0[5], x0[3])
        carry = RaceCarry(
            xg=torch.stack([x0[0], x0[1], x0[2], Xw, Yw, psiw])[None],
            mpc=mpc_init(p_mu0, cfg, track, x0_b), ekf=ekf_init(x0_b),
            fric=friction_init(mu0, batch=(1,), device=dev), x_prev_f=x0_b,
            u_prev=torch.zeros((1, 2), **f32), generator=gen)

    def current_mu() -> float:
        if not adapt_mu:
            return float(mu0)
        return float(mcarry.fr[0, 0]) if use_mega else float(carry.fric.mu[0])

    # the first plan's friction is consumed once (and only when race_loop
    # itself plans it: a caller's table0 is that caller's first plan, so
    # the first REPLAN already takes the live mu-hat)
    first_plan_mu = [mu_plan0 if table0 is None else None]

    def plan_now(t: int, x_state) -> RefTable:
        mu_p = first_plan_mu[0] if first_plan_mu[0] is not None else current_mu()
        first_plan_mu[0] = None
        table, _ = plan_mpp(p.replace(mu=float(np.float32(mu_p))), pcfg, track, scfg=plan_scfg,
                            obstacles=_obstacles_at(obstacles_fn, t, max_obstacle_rows, dev),
                            x0_state=x_state)
        return table

    table = table0 if table0 is not None else plan_now(0, x0)
    replan_steps, tables_vx, tables_ey, segs = [0], [table.vx], [table.ey], []
    for i in range(-(-T // replan_every)):
        t = i * replan_every
        if use_mega:
            args = (mcarry, gen, table)
            if obstacles_fn is not None:
                args += (torch.as_tensor(pad_blocks(obstacles_fn(t), max_obstacle_rows), **f32),)
            mcarry, (xg_b, xf_b, u_b, mu_b, conv_b, z_b, it_b, rp_b) = runner(*args)
            lane = lambda a: a[..., 0]                      # (T_seg, ., 1) -> (T_seg, .)
            outs = (lane(xg_b), lane(xf_b), lane(z_b), lane(u_b), lane(mu_b), lane(conv_b),
                    lane(it_b), lane(rp_b))
        else:
            carry, outs_b = segment(carry, table, _obstacles_at(obstacles_fn, t, max_obstacle_rows, dev))
            outs = tuple(a[:, 0] for a in outs_b)
        segs.append(outs)
        t_next = t + replan_every
        if t_next >= T:
            break
        # replan from the current ESTIMATED state at the current mu-hat
        if use_mega:
            x_state = mcarry.ekx[:, 0] if use_ekf else mcarry.x_prev_f[:, 0]
        else:
            x_state = carry.ekf.x[0] if use_ekf else carry.x_prev_f[0]
        table = plan_now(t_next, x_state)
        replan_steps.append(t_next)
        tables_vx.append(table.vx)
        tables_ey.append(table.ey)     # in lockstep with replan_steps

    Xg, Xf, Z, U, mu_hat, conv, iters, r_prim = (torch.cat(col, dim=0)[:T] for col in zip(*segs))
    # lap completions from the estimator's unwrapped s (the shared contract)
    s_traj = Xf[:, 4].cpu().numpy()
    L = float(track.length)
    s0 = float(x0[4])
    n_laps = int((s_traj[-1] - s0) // L)
    lap_steps = [int(np.argmax(s_traj - s0 >= (k + 1) * L)) + 1 for k in range(n_laps)]
    return RaceLog(Xg=Xg, Xf=Xf, Z=Z, U=U, mu_hat=mu_hat, converged=conv, iters=iters, r_prim=r_prim,
                   replan_steps=torch.tensor(replan_steps), tables_vx=torch.stack(tables_vx),
                   tables_ey=torch.stack(tables_ey), lap_steps=torch.tensor(lap_steps, dtype=torch.int64))

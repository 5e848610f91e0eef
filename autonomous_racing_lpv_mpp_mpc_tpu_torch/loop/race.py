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

Randomness: the JAX ``key=`` becomes ``seed=`` (a ``torch.Generator`` on the
carry's device seeded with it) or ``generator=``. The streams differ from
``jax.random``'s, so noisy runs agree with the JAX package in distribution,
not sample for sample; tests hand both sides the same numpy noise.

Not ported yet: ``race_loop`` (needs the planner), ``mega_race_learn``
(lap learning), ``checkpointed_race_sweep`` (orbax), obstacle corridors
(raise ``NotImplementedError``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..planner.reftable import RefTable
from ..track.track import Track, frenet_to_global
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


def _no_obstacles(obstacles):
    if obstacles is not None:
        raise NotImplementedError("obstacle corridors (corridor_from_blocks) are not ported yet")


def _ekf_r(noise_sigma) -> np.ndarray:
    sig = np.zeros(6, np.float32) if noise_sigma is None else np.asarray(noise_sigma, np.float32)
    return np.where(sig > 0, sig ** 2, 1e-4).astype(np.float32)


def _make_segment(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track, T_seg: int,
                  mu_true: float, mu0: float, sim_tire: str, n_sub: int, noise_sigma,
                  use_ekf: bool, adapt_mu: bool, ekf_q):
    """``run(carry, table, obstacles=None, mu_plant=None)``: ``T_seg``
    composed steps of the module composition. ``mu_plant`` (B,) overrides
    the plant friction per lane. Returns (carry, outs) with outs = (Xg, Xf,
    Z, U, mu_hat, converged, iters, r_prim), each stacked (T_seg, B, ...).

    The tracker's infeasibility certificate is a diagnostic this log does
    not carry, so it is switched off here."""
    if noise_sigma is not None and not np.any(np.asarray(noise_sigma) > 0):
        noise_sigma = None
    scfg = scfg.replace(certify_infeasibility=False)
    Rn_diag = (np.asarray(noise_sigma, np.float32) ** 2 if noise_sigma is not None
               else np.full(6, 1e-4, np.float32))

    def run(carry: RaceCarry, table: RefTable, obstacles=None, mu_plant=None):
        _no_obstacles(obstacles)
        dev = carry.xg.device
        f32 = dict(dtype=torch.float32, device=dev)
        B = carry.xg.shape[0]
        Qn = torch.diag(torch.as_tensor(np.asarray(ekf_q, np.float32), **f32))
        Rn = torch.diag(torch.as_tensor(Rn_diag, **f32))
        mu_p = mu_true if mu_plant is None else mu_plant
        p_plant = p.replace(mu=torch.as_tensor(mu_p, **f32).expand(B))
        sig = None if noise_sigma is None else torch.as_tensor(np.asarray(noise_sigma, np.float32), **f32)
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
            u, mpc2, diag = mpc_step_batched(p_hat, cfg, scfg, track, xf, table, c.mpc)
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


def make_racestep_scan(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                       table, T: int, mu_true_b: torch.Tensor, sigma, use_ekf: bool = True,
                       adapt_mu: bool = True, sim_tire: str = "pacejka", n_sub: int = 10,
                       ekf_q=None, obstacles=None, gate_sigma: float = 0.0, n_sub_ekf: int = 4):
    """Build the T-step composed runner ``run(carry0, generator)`` on the
    racestep once.

    ``p``'s mu is the controller seed mu0; ``mu_true_b`` (B,) the plant
    friction per lane, on the carry's device; ``sigma`` (6,) the sensor
    noise (zeros: clean, no draw). Each step draws its (6, B) noise from
    ``generator`` on the device. ``run`` returns (carry, outs) with outs =
    (Xg, Xf, U, mu_hat, converged, Z, iters, r_prim), each stacked
    (T, ., B)."""
    from ..ops.megastep_kernel import megastep_params
    from ..ops.racestep_kernel import racestep

    _no_obstacles(obstacles)
    B = mu_true_b.shape[0]
    sig_np = np.asarray(sigma, np.float32)
    ekf_r = _ekf_r(sig_np)
    if ekf_q is None:
        ekf_q = np.asarray(DEFAULT_EKF_Q, np.float32)
    noisy = bool(np.any(sig_np > 0))

    def run(carry, generator):
        dev = carry.xg.device
        f32 = dict(dtype=torch.float32, device=dev)
        prm = megastep_params(p, B, device=dev)
        mu_b = mu_true_b.to(**f32)
        sig = torch.as_tensor(sig_np, **f32)[:, None]
        q = torch.as_tensor(ekf_q, **f32)
        r = torch.as_tensor(ekf_r, **f32)
        zeros = torch.zeros((6, B), **f32)
        outs = []
        for _ in range(T):
            noise = sig * torch.randn((6, B), generator=generator, **f32) if noisy else zeros
            carry, u0, diag, z = racestep(cfg, scfg, track, prm, table, carry, noise, mu_b, q, r,
                                          n_sub=n_sub, n_sub_ekf=n_sub_ekf, sim_tire=sim_tire,
                                          use_ekf=use_ekf, adapt_mu=adapt_mu,
                                          gate_sigma=gate_sigma)
            outs.append((carry.xg, carry.x_prev_f, u0, diag[5], diag[2], z, diag[4], diag[0]))
        return carry, tuple(torch.stack(col) for col in zip(*outs))

    return run


def mega_race_sweep(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                    table, x0_b: torch.Tensor, T: int, mu_true_b, mu0: float = 1.0,
                    noise_sigma=None, seed: int = 0, generator: Optional[torch.Generator] = None,
                    use_ekf: bool = True, adapt_mu: bool = True, sim_tire: str = "pacejka",
                    n_sub: int = 10, ekf_q=None, obstacles=None) -> BatchedRaceLog:
    """The contract of :func:`batched_race_sweep` with every step one
    racestep launch (the kernel on CUDA tensors). The noise stream is drawn
    per step from ``generator`` (or a new one seeded with ``seed``)."""
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

"""The composed race step: ``ops.racestep_kernel.racestep``, one launch per
step (the measurement of the world-frame pose with sensor noise, the EKF
and the friction RLS at mu-hat, the reference table sampled along the
schedule, the tracker at mu-hat, the world-frame plant at each lane's true
mu), as ``loop.race.make_racestep_scan`` drives it; the carry kept
batch-last on the card between steps. The sensor noise is drawn on the
device from a generator of the route's own, seeded from the run's seed,
``NOISE_BLOCK`` steps' (6, B) draws at a time (one launch, not one a step);
each step's outputs hand its draw to the reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, trace

NOISE_STREAM = 0x6E6F697365   # the noise generator's seed: the run's seed and this, mixed
NOISE_BLOCK = 64              # steps of noise drawn at a time


def noise_seed(seed: int) -> int:
    """The noise generator's seed, a stream apart from the scenario
    stream's (which takes the run's seed as it is)."""
    return int(np.random.SeedSequence([seed % 2**64, NOISE_STREAM]).generate_state(1, np.uint64)[0])


class RaceRoute:
    kernel = "racestep_kernel"
    lookup = "mul"             # the kernel's cell index: floor(wrap(s) * (1 / ds))
    exact_done_at = False      # done-at recorded at chunk boundaries

    def __init__(self, ctx):
        import importlib

        pkg = program.PACKAGE
        self.rk = importlib.import_module(f"{pkg}.ops.racestep_kernel")
        mk = importlib.import_module(f"{pkg}.ops.megastep_kernel")
        lap = importlib.import_module(f"{pkg}.loop.lap_learning")
        c, r = ctx.config, ctx.config["race"]
        self.p, self.cfg, self.scfg = program.configs(c)
        # numbers of the step that the racestep keeps as constants
        fixed = {"ekf_fd_eps": (float(r["ekf_fd_eps"]), self.rk.FD_EPS),
                 "mu_clip": (tuple(r["mu_clip"]), (self.rk.MU_MIN, self.rk.MU_MAX)),
                 "epsi_probe": (float(r["epsi_probe"]), self.rk.EPSI_PROBE)}
        for key, (want, have) in fixed.items():
            if want != have:
                raise ValueError(f"the configuration's {key} {want} is not the racestep's {have}")
        dev = ctx.device
        self.track = program.track(c, dev)
        self.table = lap.initial_table(self.track, ds=float(r["table_ds"]), vx0=float(r["table_vx"]))
        self.mu0 = float(r["mu0"])
        B = int(c["batch"])
        f32 = dict(dtype=torch.float32, device=dev)
        # the controller's nominal parameters, its friction the seed mu0 (the
        # kernel runs at each lane's mu-hat)
        self.prm = mk.megastep_params(self.p.replace(mu=self.mu0), B, device=dev)
        sigma = np.asarray(r["sigma"], np.float32)
        self.sigma = torch.as_tensor(sigma, **f32)[:, None]
        self.q = torch.as_tensor(np.asarray(r["ekf_q"], np.float32), **f32)
        self.r = torch.as_tensor(sigma ** 2, **f32)
        self.kw = dict(n_sub=int(c["n_sub"]), n_sub_ekf=int(r["n_sub_ekf"]), sim_tire=c["sim_tire"],
                       gate_sigma=float(r["gate_sigma"]), forgetting=float(r["forgetting"]),
                       min_sensitivity=float(r["min_sensitivity"]), window_m=float(r["window_m"]))
        self.p0 = dict(p0_ekf=float(r["ekf_p0"]), p0_rls=float(r["rls_p0"]))
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(noise_seed(int(ctx.seed)))
        self.block, self.k = torch.empty((0, 6, B), **f32), 0
        self.B, self.ctx = B, ctx

    def start(self, scen):
        with trace.span(self.ctx, "race.racestep_init"):
            carry = self.rk.racestep_init(self.p, self.cfg, self.track, scen.x0, self.mu0, **self.p0)
        return carry, scen.mu, None, None, None, None

    def _noise(self, mu):
        """The next step's (6, B) draw, a view into the current block."""
        if self.k == self.block.shape[0]:
            with trace.span(self.ctx, "race.noise"):
                self.block = self.sigma * torch.randn((NOISE_BLOCK, 6, self.B), generator=self.gen,
                                                      dtype=torch.float32, device=mu.device)
            self.k = 0
        self.k += 1
        return self.block[self.k - 1]

    def step(self, state):
        carry, mu = state[0], state[1]
        noise = self._noise(mu)
        with trace.span(self.ctx, "race.racestep"):
            new, u0, diag, z = self.rk.racestep(self.cfg, self.scfg, self.track, self.prm, self.table,
                                                carry, noise, mu, self.q, self.r, **self.kw)
        return new, mu, u0, diag, z, noise

    def accumulate(self, acc, state):
        acc.add_(state[3][2::2])          # diag rows 2 (converged) and 4 (done-at)

    def carry(self, state):
        return state[0]._asdict()

    def outputs(self, state):
        new, _, u0, diag, z, noise = state
        out = new._asdict()
        out.update(x=new.xg, u0=u0, r_prim=diag[0], r_dual=diag[1], converged=diag[2] > 0.5,
                   iters=diag[4], z=z, noise=noise)
        return out

    def launches(self):
        return self.rk.racestep.launches


def make(ctx):
    return RaceRoute(ctx)

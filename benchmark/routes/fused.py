"""The fused route: ``loop.mpc.mpc_step_batched`` with the fused backend
(``mpc_prepare_light``, one ``ops.fused_kernel`` launch, ``_post_solve``)
and then ``loop.closed_loop.plant_step``: what ``loop.closed_loop.
closed_loop`` runs per step, the carry batch-first."""

from __future__ import annotations

import torch

from benchmark import program, trace


class FusedRoute:
    kernel = "fused_kernel"
    lookup = "div"             # curvature_at's cell index: floor(wrap(s) / ds)
    exact_done_at = True       # the fused kernel tests termination after every iteration

    def __init__(self, ctx):
        import importlib

        pkg = program.PACKAGE
        self.mpc = importlib.import_module(f"{pkg}.loop.mpc")
        self.cl = importlib.import_module(f"{pkg}.loop.closed_loop")
        self.fk = importlib.import_module(f"{pkg}.ops.fused_kernel")
        c = ctx.config
        self.p, self.cfg, self.scfg = program.configs(c, backend="fused")
        self.track = program.track(c, ctx.device)
        self.x_ref = program.constant_refs(self.cfg, float(c["vx_ref"]), ctx.device)
        self.n_sub, self.sim_tire = int(c["n_sub"]), c["sim_tire"]
        self.ctx = ctx

    def start(self, scen):
        with trace.span(self.ctx, "fused.mpc_init"):
            p_b = self.p.replace(mu=scen.mu)
            carry = self.mpc.mpc_init(p_b, self.cfg, self.track, scen.x0)
        return scen.x0, carry, p_b, None, None

    def step(self, state):
        x, carry, p_b = state[:3]
        with trace.span(self.ctx, "fused.mpc_step_batched"):
            u, new, diag = self.mpc.mpc_step_batched(p_b, self.cfg, self.scfg, self.track, x, self.x_ref,
                                                     carry)
        with trace.span(self.ctx, "fused.plant_step"):
            x_next = self.cl.plant_step(p_b, self.cfg, self.track, x, u, n_sub=self.n_sub,
                                        sim_tire=self.sim_tire)
        return x_next, new, p_b, u, diag

    def accumulate(self, acc, state):
        diag = state[4]
        acc[0].add_(diag.converged)
        acc[1].add_(diag.iters)

    def carry(self, state):
        x, c = state[0], state[1]
        bl = lambda t: t.movedim(0, -1)
        return {"x": bl(x), "X_pred": bl(c.X_pred), "U_pred": bl(c.U_pred), "s": bl(c.s),
                "lam": bl(c.lam), "u_prev": bl(c.u_prev), "rho": c.rho}

    def outputs(self, state):
        out = self.carry(state)
        u, diag = state[3], state[4]
        out.update(u0=u.movedim(0, -1), r_prim=diag.r_prim, r_dual=diag.r_dual,
                   converged=diag.converged.to(torch.bool), iters=diag.iters.to(torch.float32))
        return out

    def launches(self):
        return self.fk.fused_mpc_solve.launches


def make(ctx):
    return FusedRoute(ctx)

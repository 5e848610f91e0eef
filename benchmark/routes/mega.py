"""The megastep route: ``ops.megastep_kernel.megastep``, one launch per
closed-loop step (schedule, discretization, QP, Riccati and ADMM,
limp-home, plant), the carry kept batch-last on the card between steps."""

from __future__ import annotations

from benchmark import program, trace


class MegaRoute:
    kernel = "megastep_kernel"
    lookup = "mul"             # the kernel's cell index: floor(wrap(s) * (1 / ds))
    exact_done_at = False      # done-at recorded at chunk boundaries

    def __init__(self, ctx):
        import importlib

        self.mk = importlib.import_module(f"{program.PACKAGE}.ops.megastep_kernel")
        c = ctx.config
        self.p, self.cfg, self.scfg = program.configs(c)
        self.track = program.track(c, ctx.device)
        self.x_ref = program.constant_refs(self.cfg, float(c["vx_ref"]), ctx.device)
        self.n_sub, self.sim_tire = int(c["n_sub"]), c["sim_tire"]
        self.ctx = ctx

    def start(self, scen):
        with trace.span(self.ctx, "mega.megastep_init"):
            p_b = self.p.replace(mu=scen.mu)
            carry = self.mk.megastep_init(p_b, self.cfg, self.track, scen.x0)
            prm = self.mk.megastep_params(p_b, scen.x0.shape[0], device=scen.x0.device)
        return carry, prm, None, None

    def step(self, state):
        carry, prm = state[0], state[1]
        with trace.span(self.ctx, "mega.megastep"):
            new, u0, diag = self.mk.megastep(self.cfg, self.scfg, self.track, prm, self.x_ref, carry,
                                             n_sub=self.n_sub, sim_tire=self.sim_tire)
        return new, prm, u0, diag

    def accumulate(self, acc, state):
        acc.add_(state[3][2::2])          # diag rows 2 (converged) and 4 (done-at)

    def carry(self, state):
        return state[0]._asdict()

    def outputs(self, state):
        new, _, u0, diag = state
        out = new._asdict()
        out.update(u0=u0, r_prim=diag[0], r_dual=diag[1], converged=diag[2] > 0.5, iters=diag[4])
        return out

    def launches(self):
        return self.mk.megastep.launches


def make(ctx):
    return MegaRoute(ctx)

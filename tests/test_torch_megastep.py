"""The megastep's plain PyTorch version vs the JAX package's megastep
kernel (Pallas, interpret mode under ``jax.jit``) on the CPU.

Same shapes and tolerances as the JAX package's own megastep tests
(tests/test_megastep.py): N=8, B=4, racetrack, 3 closed-loop steps; u 2e-4,
x and X_pred 5e-4, lam 5e-3, rho 1e-3 relative; early exit within 5e-3 of
the fixed-count closed loop; done-at within one iteration at check cadence 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_prepare as jmpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep as jmegastep
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_init as jmegastep_init
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_params as jmegastep_params
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve as jadmm_solve
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    megastep, megastep_init, megastep_params, megastep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

B = 4


def _setup():
    p = JVehicleParams()
    cfg = JMPCConfig(N=8, model="dynamic")
    track = jrace()
    x_ref = jconstant_refs(cfg, 1.6)
    p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (B,) + jnp.shape(l)), p)
    x0 = np.tile(np.array([1.2, 0.0, 0.0, 0.0, 0.0, 0.05], np.float32)[None], (B, 1))
    x0[:, 4] = [0.3, 2.7, 6.1, 9.4]
    x0[:, 5] = [0.05, -0.1, 0.0, 0.12]
    return p_b, cfg, track, x_ref, x0


def _jax_steps(p_b, cfg, scfg, track, x_ref, x0, n_steps):
    carry = jmegastep_init(p_b, cfg, track, jnp.asarray(x0))
    prm = jmegastep_params(p_b, B)
    step = jax.jit(lambda c: jmegastep(cfg, scfg, track, prm, x_ref, c, n_sub=4, interpret=True))
    us, xs, diags = [], [], []
    for _ in range(n_steps):
        carry, u0, diag = step(carry)
        us.append(np.asarray(u0))
        xs.append(np.asarray(carry.x))
        diags.append(np.asarray(diag))
    return np.stack(us), np.stack(xs), np.stack(diags), carry


def _port_steps(p_b, cfg, scfg, track, x_ref, x0, n_steps):
    p, pcfg, pscfg, ptrack = (convert.vehicle_params(p_b, device="cpu"), convert.mpc_config(cfg),
                              convert.solver_config(scfg), convert.track(track, device="cpu"))
    carry = megastep_init(p, pcfg, ptrack, torch.tensor(x0))
    prm = megastep_params(p, B, device="cpu")
    xr = convert.tensor(x_ref, device="cpu")
    us, xs, diags = [], [], []
    for _ in range(n_steps):
        carry, u0, diag = megastep(pcfg, pscfg, ptrack, prm, xr, carry, n_sub=4)
        us.append(u0.numpy())
        xs.append(carry.x.numpy())
        diags.append(diag.numpy())
    return np.stack(us), np.stack(xs), np.stack(diags), carry


def test_megastep_plain_matches_jax_megastep():
    """3 closed-loop steps, fixed iteration count."""
    args = _setup()
    scfg = JSolverConfig(max_iter=15, rho_interval=0)
    ju, jx, jd, jc = _jax_steps(*args[:2], scfg, *args[2:], n_steps=3)
    pu, px, pd, pc = _port_steps(*args[:2], scfg, *args[2:], n_steps=3)
    np.testing.assert_allclose(pu, ju, atol=2e-4, rtol=0)
    np.testing.assert_allclose(px, jx, atol=5e-4, rtol=0)
    np.testing.assert_allclose(pc.X_pred.numpy(), np.asarray(jc.X_pred), atol=5e-4, rtol=0)
    np.testing.assert_allclose(pc.lam.numpy(), np.asarray(jc.lam), atol=5e-3, rtol=0)
    np.testing.assert_allclose(pc.rho.numpy(), np.asarray(jc.rho), rtol=1e-3)
    np.testing.assert_array_equal(pd[:, 2], jd[:, 2])            # converged flags
    assert np.abs(pd[:, 4] - jd[:, 4]).max() <= 1                  # done-at


def test_megastep_early_exit_semantics():
    """All-lanes early exit: every lane converged when the group stops,
    warm-started steps stop early, and the closed loop stays within the
    solver tolerance (5e-3) of the fixed-count run — on the port and
    against the JAX kernel's early exit."""
    args = _setup()
    base = JSolverConfig(max_iter=25, rho_interval=0, check_termination=5,
                         eps_abs=3e-3, eps_rel=3e-3)
    ee = base.replace(early_exit=True)
    fu, fx, _, _ = _port_steps(*args[:2], base, *args[2:], n_steps=4)
    eu, ex, ed, _ = _port_steps(*args[:2], ee, *args[2:], n_steps=4)
    assert (ed[:, 2] == 1.0).all()
    assert (ed[1:, 4] < base.max_iter).all(), ed[:, 4]
    np.testing.assert_allclose(eu, fu, atol=5e-3, rtol=0)
    np.testing.assert_allclose(ex, fx, atol=5e-3, rtol=0)
    ju, jx, jd, _ = _jax_steps(*args[:2], ee, *args[2:], n_steps=4)
    np.testing.assert_allclose(eu, ju, atol=5e-3, rtol=0)
    np.testing.assert_allclose(ex, jx, atol=5e-3, rtol=0)
    assert np.abs(ed[:, 4] - jd[:, 4]).max() <= ee.check_termination


def test_megastep_done_at_matches_admm_solve():
    """diag row 4 at check cadence 1 equals the done-at of the JAX XLA
    solver on the same first-step QPs, within one iteration."""
    p_b, cfg, track, x_ref, x0 = _setup()
    scfg = JSolverConfig(max_iter=25, rho_interval=0, check_termination=1,
                         eps_abs=3e-3, eps_rel=3e-3)
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, cfg, track, x))(p_b, jnp.asarray(x0))
    qp, warm, _ = jax.vmap(lambda pp, x, c: jmpc_prepare(pp, cfg, track, x, x_ref, c))(
        p_b, jnp.asarray(x0), carry)
    sol = jax.jit(jax.vmap(lambda q, w, r: jadmm_solve(q, scfg, warm=w, rho0=r)))(qp, warm, carry.rho)
    iters_xla = np.asarray(sol.iters)
    assert (iters_xla < scfg.max_iter).any(), "not exercising an early done-at"
    _, _, pd, _ = _port_steps(p_b, cfg, scfg, track, x_ref, x0, n_steps=1)
    assert np.abs(pd[0, 4] - iters_xla).max() <= 1, (pd[0, 4], iters_xla)


def test_megastep_groups_exit_per_128_lanes():
    """With early exit a 128-lane group iterates until all of its lanes
    are done, independently of the other groups: lanes of a 130-lane batch
    give the results of their own group run alone."""
    p, cfg, track = VehicleParams(), MPCConfig(N=8), racetrack(device="cpu")
    scen = make_scenario_grid(p, cfg, n_ey=13, n_mu=10, vx0=1.3, device="cpu")
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    x_ref = constant_refs(cfg, 1.8, device="cpu")

    def run(sl):
        pp = p.replace(mu=scen.params.mu[sl])
        carry = megastep_init(pp, cfg, track, scen.x0[sl])
        prm = megastep_params(pp, carry.x.shape[-1], device="cpu")
        for _ in range(3):
            carry, u0, diag = megastep_plain(cfg, scfg, track, prm, x_ref, carry)
        return u0, diag

    u_all, d_all = run(slice(0, 130))
    for sl in (slice(0, 128), slice(128, 130)):
        u_g, d_g = run(sl)
        np.testing.assert_array_equal(u_all[:, sl].numpy(), u_g.numpy())
        np.testing.assert_array_equal(d_all[:, sl].numpy(), d_g.numpy())
    assert megastep.launches == 0     # CPU tensors never launch the kernel


def test_megastep_pacejka_and_mismatch():
    """Pacejka-linearized LPV with a Pacejka plant: the port's plain
    megastep follows the JAX kernel for 3 steps (fixed count)."""
    p_b, cfg, track, x_ref, x0 = _setup()
    cfg = cfg.replace(tire="pacejka")
    scfg = JSolverConfig(max_iter=15, rho_interval=0)
    ju, jx, _, _ = _jax_steps(p_b, cfg, scfg, track, x_ref, x0, n_steps=3)
    pu, px, _, _ = _port_steps(p_b, cfg, scfg, track, x_ref, x0, n_steps=3)
    np.testing.assert_allclose(pu, ju, atol=2e-4, rtol=0)
    np.testing.assert_allclose(px, jx, atol=5e-4, rtol=0)
    assert np.isfinite(px).all() and (np.abs(px[:, 5]) < 0.5).all()


def test_carry_resync_both_directions():
    """State carries across: a JAX carry handed to the port, and the
    port's carry handed back, each give the other side's next step."""
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import MegaCarry as JMegaCarry

    p_b, cfg, track, x_ref, x0 = _setup()
    scfg = JSolverConfig(max_iter=15, rho_interval=0)
    jprm = jmegastep_params(p_b, B)
    step = jax.jit(lambda c: jmegastep(cfg, scfg, track, jprm, x_ref, c, n_sub=4, interpret=True))
    pcfg, pscfg, ptrack = convert.mpc_config(cfg), convert.solver_config(scfg), convert.track(track, device="cpu")
    prm = megastep_params(convert.vehicle_params(p_b, device="cpu"), B, device="cpu")
    xr = convert.tensor(x_ref, device="cpu")

    jc = jmegastep_init(p_b, cfg, track, jnp.asarray(x0))
    jc, _, _ = step(jc)
    pc, pu, _ = megastep(pcfg, pscfg, ptrack, prm, xr, convert.mega_carry(jc, device="cpu"))   # JAX -> port
    jc2, ju, _ = step(JMegaCarry(**{k: jnp.asarray(v) for k, v in convert.to_numpy(pc).items()}))
    jc1, ju1, _ = step(jc)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju1), atol=2e-4, rtol=0)
    np.testing.assert_allclose(pc.x.numpy(), np.asarray(jc1.x), atol=5e-4, rtol=0)
    pc2, pu2, _ = megastep(pcfg, pscfg, ptrack, prm, xr, pc)                    # port -> JAX
    np.testing.assert_allclose(pu2.numpy(), np.asarray(ju), atol=2e-4, rtol=0)
    np.testing.assert_allclose(pc2.x.numpy(), np.asarray(jc2.x), atol=5e-4, rtol=0)

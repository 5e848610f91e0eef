"""The port's composed controller and closed loop vs the JAX package, and
the oracle rung of the bench solver configuration (CPU).

- One composed step (``mpc_step_batched`` + ``plant_step``) of the port's
  "plain" backend against the JAX "xla" backend, and of the port's "admm"
  backend (the solver kernel's plain version) against the JAX "pallas"
  backend in interpret mode: 2e-4 on u and x (same algorithm, other
  summation order), as the JAX package's fused-vs-composed test.
- The megastep's plain version against the JAX composed "xla" step: 2e-3,
  the tolerance of the JAX package's own megastep-vs-xla test.
- The port's ``closed_loop`` against the JAX ``closed_loop``: 3 steps, 2e-4.
- The oracle rung: the port's plain megastep at the bench solver config
  (max_iter=20, rho_interval=0, early exit, check cadence 2) drives N=12 on
  the oval for 35 steps; every 5th step the QP it is about to solve is
  handed, as numpy arrays, to the JAX package's ``stack_boxqp`` and the f64
  OSQP-semantics oracle, and u0 must agree within 5e-5
  (tests/test_headline_oracle.py). The same at N=20 on the racetrack, the
  bench's own shape, with constant references and with a reference table
  whose racing line is a sinusoid (vx, e_y and the e_psi slope sampled
  along each step's scheduled s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autonomous_racing_lpv_mpp_mpc_tpu.ops.admm_kernel as jadmm_kernel
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import closed_loop as jclosed_loop
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_step_batched as jmpc_step_batched
from autonomous_racing_lpv_mpp_mpc_tpu.loop import plant_step as jplant_step
from autonomous_racing_lpv_mpp_mpc_tpu.oracle import (
    OsqpRefSettings, osqp_ref_solve, stack_boxqp, unstack_solution,
)
from autonomous_racing_lpv_mpp_mpc_tpu.solver import BoxQP as JBoxQP
from autonomous_racing_lpv_mpp_mpc_tpu.solver import LQRCost as JLQRCost
from autonomous_racing_lpv_mpp_mpc_tpu.solver import LQRDynamics as JLQRDynamics
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    MPCCarry, closed_loop, constant_refs, mpc_init, mpc_prepare, mpc_step_batched, plant_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    admm_kernel_solve, megastep_init, megastep_params, megastep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import RefTable
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack

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


def _jax_composed_step(p_b, cfg, scfg, track, x_ref, x0):
    def step(x):
        carry = jax.vmap(lambda pp, xx: jmpc_init(pp, cfg, track, xx))(p_b, x)
        u, _, _ = jmpc_step_batched(p_b, cfg, scfg, track, x, x_ref, carry)
        xn = jax.vmap(lambda pp, xx, uu: jplant_step(pp, cfg, track, xx, uu, n_sub=4))(p_b, x, u)
        return u, xn
    return [np.asarray(a) for a in jax.jit(step)(jnp.asarray(x0))]


def _port_composed_step(p_b, cfg, scfg, track, x_ref, x0):
    p, pcfg, ptrack = convert.vehicle_params(p_b, device="cpu"), convert.mpc_config(cfg), convert.track(track, device="cpu")
    pscfg = convert.solver_config(scfg).replace(certify_infeasibility=False)
    x = torch.tensor(x0)
    carry = mpc_init(p, pcfg, ptrack, x)
    u, _, _ = mpc_step_batched(p, pcfg, pscfg, ptrack, x, convert.tensor(x_ref, device="cpu"), carry)
    return u.numpy(), plant_step(p, pcfg, ptrack, x, u, n_sub=4).numpy()


def test_composed_plain_step_matches_jax_xla():
    args = _setup()
    scfg = JSolverConfig(max_iter=15, rho_interval=0, backend="xla")
    ju, jx = _jax_composed_step(*args[:2], scfg, *args[2:])
    pu, px = _port_composed_step(*args[:2], scfg, *args[2:])
    np.testing.assert_allclose(pu, ju, atol=2e-4, rtol=0)
    np.testing.assert_allclose(px, jx, atol=2e-4, rtol=0)

    # the megastep's plain version against the same composed step
    p_b, cfg, track, x_ref, x0 = args
    p, pcfg, ptrack = convert.vehicle_params(p_b, device="cpu"), convert.mpc_config(cfg), convert.track(track, device="cpu")
    mc = megastep_init(p, pcfg, ptrack, torch.tensor(x0))
    mc, u0, _ = megastep_plain(pcfg, convert.solver_config(scfg), ptrack,
                               megastep_params(p, B, device="cpu"), convert.tensor(x_ref, device="cpu"), mc)
    np.testing.assert_allclose(u0.numpy().T, ju, atol=2e-3, rtol=0)
    np.testing.assert_allclose(mc.x.numpy().T, jx, atol=2e-3, rtol=0)


def test_composed_admm_backend_matches_jax_pallas(monkeypatch):
    args = _setup()
    scfg = JSolverConfig(max_iter=15, rho_interval=0, backend="pallas")
    orig = jadmm_kernel.pallas_admm_solve
    monkeypatch.setattr(jadmm_kernel, "pallas_admm_solve",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    ju, jx = _jax_composed_step(*args[:2], scfg, *args[2:])
    pu, px = _port_composed_step(*args[:2], scfg, *args[2:])
    np.testing.assert_allclose(pu, ju, atol=2e-4, rtol=0)
    np.testing.assert_allclose(px, jx, atol=2e-4, rtol=0)
    assert admm_kernel_solve.launches == 0


def test_closed_loop_matches_jax():
    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8), jrace()
    x0 = np.array([1.2, 0.0, 0.0, 0.0, 2.0, 0.08], np.float32)
    jscfg = JSolverConfig(max_iter=20, rho_interval=0)
    jlog = jax.jit(lambda x: jclosed_loop(jp, jcfg, jscfg, jt, x, jconstant_refs(jcfg, 1.6),
                                          T=3, n_sub=4))(jnp.asarray(x0))
    cfg = convert.mpc_config(jcfg)
    log = closed_loop(VehicleParams(), cfg, convert.solver_config(jscfg).replace(certify_infeasibility=False),
                      convert.track(jt, device="cpu"), torch.tensor(x0)[None], constant_refs(cfg, 1.6, device="cpu"), T=3, n_sub=4)
    np.testing.assert_allclose(log.U[:, 0].numpy(), np.asarray(jlog.U), atol=2e-4, rtol=0)
    np.testing.assert_allclose(log.X[:, 0].numpy(), np.asarray(jlog.X), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(log.converged[:, 0].numpy(), np.asarray(jlog.converged))


def test_single_vehicle_mpc_step_matches_jax():
    from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_step as jmpc_step

    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import mpc_step

    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8), jrace()
    jscfg = JSolverConfig(max_iter=20, rho_interval=0)
    x0 = jnp.asarray([1.3, 0.05, 0.1, 0.02, 5.0, -0.1], jnp.float32)
    jcar = jmpc_init(jp, jcfg, jt, x0)
    ju, jcar2, jdiag = jax.jit(lambda x, c: jmpc_step(jp, jcfg, jscfg, jt, x, jconstant_refs(jcfg, 1.6), c))(
        x0, jcar)
    cfg = convert.mpc_config(jcfg)
    car = MPCCarry(*(convert.tensor(getattr(jcar, n), device="cpu") for n in MPCCarry._fields))
    u, car2, diag = mpc_step(VehicleParams(), cfg, convert.solver_config(jscfg).replace(certify_infeasibility=False),
                             convert.track(jt, device="cpu"), convert.tensor(x0, device="cpu"), constant_refs(cfg, 1.6, device="cpu"), car)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=2e-4, rtol=0)
    np.testing.assert_allclose(car2.X_pred.numpy(), np.asarray(jcar2.X_pred), atol=5e-4, rtol=0)
    assert bool(diag.converged) == bool(jdiag.converged)


def _jax_boxqp(qp_np):
    j = lambda a: jnp.asarray(a)
    return JBoxQP(dyn=JLQRDynamics(*(j(qp_np["dyn"][n]) for n in JLQRDynamics._fields)),
                  cost=JLQRCost(*(j(qp_np["cost"][n]) for n in JLQRCost._fields)),
                  **{n: j(qp_np[n]) for n in ("Dx", "Du", "lb", "ub", "x0", "soft")})


def _sinusoidal_table(track, ds=0.05):
    """A racing line e_y = 0.1 sin(6 pi s / L) with vx 1.5 +- 0.3: the
    e_psi reference is not zero."""
    L = float(track.length)
    n = int(round(L / ds))
    w = 2 * np.pi * 3 * np.arange(n) * (L / n) / L
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return RefTable(ds=t(L / n), length=t(L), vx=t(1.5 + 0.3 * np.sin(w)), ey=t(0.1 * np.sin(w)),
                    delta=t(0.02 * np.cos(w)))


@pytest.mark.parametrize("N,track_name", [(12, "oval"), (20, "racetrack"), (20, "racetrack-table")])
def test_oracle_rung_at_bench_solver_config(N, track_name):
    p, cfg = VehicleParams(), MPCConfig(N=N, model="dynamic")
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    track = {"oval": oval_track, "racetrack": racetrack}[track_name.split("-")[0]](device="cpu")
    x_ref = _sinusoidal_table(track) if track_name.endswith("table") else constant_refs(cfg, 1.5, device="cpu")
    car = megastep_init(p, cfg, track, torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.05]]))
    prm = megastep_params(p, 1, device="cpu")
    max_du, n_checked = 0.0, 0
    for t in range(35):
        if t % 5 == 0:
            lane0 = MPCCarry(X_pred=car.X_pred[..., 0], U_pred=car.U_pred[..., 0], s=car.s[..., 0],
                             lam=car.lam[..., 0], u_prev=car.u_prev[..., 0], rho=car.rho[0])
            one = lambda a: a.unsqueeze(0)
            qp, _, _ = mpc_prepare(p, cfg, track, car.x[:, 0][None], x_ref,
                                   MPCCarry(*(one(a) for a in lane0)))
            qp_np = convert.boxqp_to_numpy(qp)
            qp_np = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                         else (v[0] if k in ("lb", "ub", "x0") else v)) for k, v in qp_np.items()}
        car, u0, _ = megastep_plain(cfg, scfg, track, prm, x_ref, car)
        if t % 5 == 0:
            jqp = _jax_boxqp(qp_np)
            ref = osqp_ref_solve(*stack_boxqp(jqp), OsqpRefSettings())
            assert ref.converged, f"oracle failed at step {t}"
            _, Ur = unstack_solution(jqp, ref.x)
            max_du = max(max_du, float(np.abs(u0[:, 0].numpy() - Ur[0]).max()))
            n_checked += 1
    assert n_checked == 7
    assert float(car.x[4, 0]) > 1.0          # the car advanced along the oval
    print(f"oracle rung N={N} {track_name}: max |du| = {max_du:.3e} over {n_checked} checks")
    assert max_du < 5e-5, f"max |u_port - u_oracle| = {max_du}"

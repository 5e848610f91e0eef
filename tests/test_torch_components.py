"""PyTorch port vs the JAX package, component by component, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Tolerances:
elementwise functions 1e-6 absolute (plus 1e-6 relative for entries far
above 1, where one float32 ulp already exceeds 1e-6); matrix chains
(Van Loan, Riccati) 1e-5, because the two frameworks sum in another order.
Where a slip angle (atan2) feeds a tire force, the frameworks' atan2 differ
by up to 1 ulp and the force rows multiply that by up to Cf*lf/Iz ~ 360,
so those rows are held at 1e-6 * 360 absolute.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.engine import assembly as jasm
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_prepare as jmpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu.models import dynamics as jdyn
from autonomous_racing_lpv_mpp_mpc_tpu.models import lpv as jlpv
from autonomous_racing_lpv_mpp_mpc_tpu.parallel import make_scenario_grid as jgrid
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm as jadmm
from autonomous_racing_lpv_mpp_mpc_tpu.solver import riccati as jric
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace
from autonomous_racing_lpv_mpp_mpc_tpu.track import track as jtrack

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import assembly as tasm
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs, mpc_init, mpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu_torch.models import dynamics as tdyn
from autonomous_racing_lpv_mpp_mpc_tpu_torch.models import lpv as tlpv
from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import admm as tadmm
from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import riccati as tric
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import track as ttrack

jdisc = importlib.import_module("autonomous_racing_lpv_mpp_mpc_tpu.models.discretize")
tdisc = importlib.import_module("autonomous_racing_lpv_mpp_mpc_tpu_torch.models.discretize")

ELEM = dict(atol=1e-6, rtol=1e-6)
CHAIN = dict(atol=1e-5, rtol=1e-5)
SLIP = dict(atol=4e-4, rtol=1e-6)
T = lambda a: torch.tensor(np.asarray(a, np.float32))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _states(rng, n):
    """Scheduling points inside the operating envelope."""
    x = np.stack([
        rng.uniform(0.02, 3.5, n), rng.uniform(-0.4, 0.4, n), rng.uniform(-2.0, 2.0, n),
        rng.uniform(-0.5, 0.5, n), rng.uniform(-5.0, 40.0, n), rng.uniform(-0.45, 0.45, n),
    ], axis=1).astype(np.float32)
    u = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-2.0, 3.0, n)], axis=1).astype(np.float32)
    kap = rng.choice([-1.0, 0.0, 0.77, 1.0, 1.3], n).astype(np.float32)
    return x, u, kap


@pytest.mark.parametrize("name", ["racetrack", "oval"])
def test_track_tables_match(name):
    jt = {"racetrack": jrace, "oval": joval}[name]()
    tt = {"racetrack": racetrack, "oval": oval_track}[name](device="cpu")
    for field in ("ds", "length", "width", "kappa", "X", "Y", "psi"):
        np.testing.assert_allclose(_np(getattr(tt, field)), np.asarray(getattr(jt, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
    assert tt.n_cells == jt.kappa.shape[0]


def test_wrap_and_curvature_lookup():
    rng = np.random.default_rng(0)
    jt, tt = jrace(), racetrack(device="cpu")
    s = rng.uniform(-40.0, 80.0, 4096).astype(np.float32)
    np.testing.assert_allclose(_np(ttrack.wrap_s(tt, T(s))), np.asarray(jtrack.wrap_s(jt, s)), **ELEM)
    np.testing.assert_array_equal(_np(ttrack.curvature_at(tt, T(s))),
                                  np.asarray(jtrack.curvature_at(jt, s)))


@pytest.mark.parametrize("tire", ["linear", "pacejka"])
def test_dynamics_match(tire):
    rng = np.random.default_rng(1)
    x, u, kap = _states(rng, 512)
    p = JVehicleParams()
    jf = jax.vmap(lambda xx, uu, kk: jdyn.f_dynamic(p, xx, uu, kk, tire))(x, u, kap)
    tf = tdyn.f_dynamic(convert.vehicle_params(p, device="cpu"), T(x), T(u), T(kap), tire)
    np.testing.assert_allclose(_np(tf)[:, :3], np.asarray(jf)[:, :3], **SLIP)
    np.testing.assert_allclose(_np(tf)[:, 3:], np.asarray(jf)[:, 3:], **ELEM)
    xk = x[:, [0, 3, 4, 5]]
    jk = jax.vmap(lambda xx, uu, kk: jdyn.f_kinematic(p, xx, uu, kk))(xk, u, kap)
    tk = tdyn.f_kinematic(convert.vehicle_params(p, device="cpu"), T(xk), T(u), T(kap))
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **ELEM)
    np.testing.assert_allclose(_np(tdyn.frenet_denom(T(kap), T(x[:, 5]))),
                               np.asarray(jdyn.frenet_denom(kap, x[:, 5])), **ELEM)


@pytest.mark.parametrize("model,tire", [("dynamic", "linear"), ("dynamic", "pacejka"),
                                        ("kinematic", "linear")])
def test_lpv_ab_match(model, tire):
    rng = np.random.default_rng(2)
    x, u, kap = _states(rng, 512)
    if model == "kinematic":
        x = x[:, [0, 3, 4, 5]]
    p = JVehicleParams()
    jA, jB = jax.vmap(lambda xx, uu, kk: jlpv.lpv_ab(p, xx, uu, kk, model, tire))(x, u, kap)
    tA, tB = tlpv.lpv_ab(convert.vehicle_params(p, device="cpu"), T(x), T(u), T(kap), model, tire)
    # the Pacejka secant stiffness goes through atan2: its force rows get SLIP
    force = dict(SLIP if tire == "pacejka" else ELEM)
    np.testing.assert_allclose(_np(tA)[:, :3], np.asarray(jA)[:, :3], **force)
    np.testing.assert_allclose(_np(tB)[:, :3], np.asarray(jB)[:, :3], **force)
    np.testing.assert_allclose(_np(tA)[:, 3:], np.asarray(jA)[:, 3:], **ELEM)
    np.testing.assert_allclose(_np(tB)[:, 3:], np.asarray(jB)[:, 3:], **ELEM)


def test_discretize_match():
    rng = np.random.default_rng(3)
    x, u, kap = _states(rng, 256)
    p = JVehicleParams()
    A, B = jax.vmap(lambda xx, uu, kk: jlpv.lpv_ab(p, xx, uu, kk, "dynamic"))(x, u, kap)
    A, B = np.asarray(A), np.asarray(B)
    dt = 1.0 / 30.0
    jAd, jBd = jdisc.discretize_expm(A, B, dt)
    tAd, tBd = tdisc.discretize_expm(T(A), T(B), dt)
    np.testing.assert_allclose(_np(tAd), np.asarray(jAd), **CHAIN)
    np.testing.assert_allclose(_np(tBd), np.asarray(jBd), **CHAIN)
    jAe, jBe = jdisc.discretize_euler(A, B, dt)
    tAe, tBe = tdisc.discretize_euler(T(A), T(B), dt)
    np.testing.assert_allclose(_np(tAe), np.asarray(jAe), **ELEM)
    np.testing.assert_allclose(_np(tBe), np.asarray(jBe), **ELEM)


def _jax_batch_qps(N=12, n_ey=4, n_mu=4):
    """Batched JAX QPs of the tracker at the grid's first step (and a
    second step from a perturbed carry), plus the port's inputs."""
    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=N), jrace()
    scen = jgrid(jp, jcfg, n_ey=n_ey, n_mu=n_mu, vx0=1.5)
    xr = jconstant_refs(jcfg, 1.8)
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, jcfg, jt, x))(scen.params, scen.x0)
    rng = np.random.default_rng(4)
    x = np.asarray(scen.x0) + rng.normal(0, 0.05, scen.x0.shape).astype(np.float32)
    x[:, 4] = rng.uniform(0.0, 30.0, x.shape[0])
    qp, warm, _ = jax.vmap(lambda pp, xx, c: jmpc_prepare(pp, jcfg, jt, xx, xr, c))(
        scen.params, x, carry)
    return (jp, jcfg, jt, scen, xr, carry, x), qp, warm


def test_initial_schedule_and_bounds_match():
    (jp, jcfg, jt, scen, xr, carry, x), _, _ = _jax_batch_qps()
    p, cfg, tt = convert.vehicle_params(scen.params, device="cpu"), convert.mpc_config(jcfg), convert.track(jt, device="cpu")
    tcar = mpc_init(p, cfg, tt, T(scen.x0))
    np.testing.assert_allclose(_np(tcar.X_pred), np.asarray(carry.X_pred), **ELEM)
    np.testing.assert_allclose(_np(tcar.U_pred), np.asarray(carry.U_pred), **ELEM)
    jlb, jub = jax.vmap(lambda pp, X: jasm.tracker_bounds(pp, jcfg, jt, X))(scen.params, carry.X_pred)
    tlb, tub = tasm.tracker_bounds(p, cfg, tt, tcar.X_pred)
    np.testing.assert_allclose(_np(tlb), np.asarray(jlb), **ELEM)
    np.testing.assert_allclose(_np(tub), np.asarray(jub), **ELEM)
    Xs, Us = tasm.shift_schedule(tcar.X_pred, tcar.U_pred)
    jXs, jUs = jax.vmap(jasm.shift_schedule)(carry.X_pred, carry.U_pred)
    np.testing.assert_allclose(_np(Xs), np.asarray(jXs), **ELEM)
    np.testing.assert_allclose(_np(Us), np.asarray(jUs), **ELEM)


def test_build_boxqp_match():
    (jp, jcfg, jt, scen, xr, carry, x), jqp, jwarm = _jax_batch_qps()
    p, cfg, tt = convert.vehicle_params(scen.params, device="cpu"), convert.mpc_config(jcfg), convert.track(jt, device="cpu")
    qp, warm, _ = mpc_prepare(p, cfg, tt, T(x), constant_refs(cfg, 1.8, device="cpu"), convert.mpc_carry(carry, device="cpu"))
    ref = convert.boxqp(jqp, device="cpu")
    for name in ("A", "B", "c"):
        np.testing.assert_allclose(_np(getattr(qp.dyn, name)), _np(getattr(ref.dyn, name)),
                                   **CHAIN, err_msg=name)
    for name in ("Q", "q", "R", "r", "M"):
        np.testing.assert_allclose(_np(getattr(qp.cost, name)), _np(getattr(ref.cost, name)),
                                   **ELEM, err_msg=name)
    for name in ("Dx", "Du", "lb", "ub", "x0", "soft"):
        np.testing.assert_allclose(_np(getattr(qp, name)), _np(getattr(ref, name)), **ELEM, err_msg=name)
    for a, b in zip(warm, jwarm):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ELEM)


def test_riccati_factor_and_solve_match():
    _, jqp, _ = _jax_batch_qps()
    rho = 0.1
    jcost = jax.vmap(lambda q: jadmm._folded_cost(q, rho, 1e-6))(jqp)
    jfac = jax.vmap(jric.riccati_factor_scan)(jqp.dyn, jcost)
    jX, jU = jax.vmap(jric.lqr_linear_solve)(jfac, jcost.q, jcost.r, jqp.x0)

    qp = convert.boxqp(jqp, device="cpu")
    B = qp.x0.shape[0]
    cost = tadmm._folded_cost(qp, torch.full((B,), rho), 1e-6)
    fac = tric.riccati_factor_scan(qp.dyn, cost)
    X, U = tric.lqr_linear_solve(fac, cost.q, cost.r, qp.x0)
    for name in ("K", "Huu_inv", "Hux", "Vc"):
        np.testing.assert_allclose(_np(getattr(fac, name)), np.asarray(getattr(jfac, name)),
                                   **CHAIN, err_msg=name)
    np.testing.assert_allclose(_np(X), np.asarray(jX), **CHAIN)
    np.testing.assert_allclose(_np(U), np.asarray(jU), **CHAIN)

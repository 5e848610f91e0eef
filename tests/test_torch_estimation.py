"""The port's Frenet transforms, reference tables, world-frame plant, EKF and
friction RLS vs the JAX package on the CPU.

Inputs come from a numpy seed and go to both sides as numpy arrays.
Tolerances: 2e-5 on the Frenet transforms and the measurement (the JAX
package's own measurement-parity bound); 1e-6 on table lookups; 4e-4 on
tire-force rows (the frameworks' atan2 differ by an ulp and those rows
scale the slip angle by up to ~360, ROADMAP Queue 3); 1e-5 on EKF and RLS
outputs (a 6x6 solve and a chain of sub-steps in f32); 1e-6 elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import global_loop as jgl
from autonomous_racing_lpv_mpp_mpc_tpu.loop.estimator import EKFState as JEKFState
from autonomous_racing_lpv_mpp_mpc_tpu.loop.estimator import ekf_step as jekf_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop.friction import FrictionState as JFrictionState
from autonomous_racing_lpv_mpp_mpc_tpu.loop.friction import friction_step as jfriction_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop.friction import measured_axle_forces as jaxle_forces
from autonomous_racing_lpv_mpp_mpc_tpu.loop.lap_learning import initial_table as jinitial_table
from autonomous_racing_lpv_mpp_mpc_tpu.models.tires import tire_force_pacejka as jtire_pacejka
from autonomous_racing_lpv_mpp_mpc_tpu.planner.reftable import RefTable as JRefTable
from autonomous_racing_lpv_mpp_mpc_tpu.planner.reftable import refs_from_table as jrefs_from_table
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace
from autonomous_racing_lpv_mpp_mpc_tpu.track import track as jtrack

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    EKFState, FrictionState, ekf_step, estimate_frenet, f_global, friction_step, global_plant_step,
    initial_table, measured_axle_forces,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.models import tire_force_pacejka
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.stage_math import _inv6, pacejka_mu_sensitivity
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import RefTable, refs_from_table
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import (
    centerline_pose, frenet_to_global, global_to_frenet, global_to_frenet_windowed, racetrack,
)

B = 24


def _queries(track, rng, n=B):
    """Random Frenet poses on the track and their world-frame poses."""
    L = float(track.length)
    s = rng.uniform(0.0, L, n).astype(np.float32)
    ey = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    ep = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    X, Y, psi = (np.asarray(a) for a in jax.vmap(
        lambda a, b, c: jtrack.frenet_to_global(track, a, b, c))(s, ey, ep))
    return s, ey, ep, X, Y, psi


def sinusoidal_table(track_length: float, ds: float = 0.05):
    """(JAX RefTable, numpy leaves) with a sinusoidal racing line, so the
    e_psi reference is not zero."""
    n = int(round(track_length / ds))
    s = np.arange(n) * (track_length / n)
    w = 2 * np.pi * 3 * s / track_length
    leaves = dict(ds=np.float32(track_length / n), length=np.float32(track_length),
                  vx=(1.5 + 0.3 * np.sin(w)).astype(np.float32),
                  ey=(0.1 * np.sin(w)).astype(np.float32),
                  delta=(0.02 * np.cos(w)).astype(np.float32))
    return JRefTable(**{k: jnp.asarray(v) for k, v in leaves.items()}), leaves


def test_frenet_transforms_match_jax():
    jt = jrace()
    pt = convert.track(jt, device="cpu")
    rng = np.random.default_rng(0)
    s, ey, ep, X, Y, psi = _queries(jt, rng)
    for got, want in zip(centerline_pose(pt, torch.tensor(s)),
                         jax.vmap(lambda a: jtrack.centerline_pose(jt, a))(s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    for got, want in zip(frenet_to_global(pt, torch.tensor(s), torch.tensor(ey), torch.tensor(ep)),
                         (X, Y, psi)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    t = lambda a: torch.tensor(a)
    dense_j = jax.vmap(lambda a, b, c: jtrack.global_to_frenet(jt, a, b, c))(X, Y, psi)
    for got, want in zip(global_to_frenet(pt, t(X), t(Y), t(psi)), dense_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # windowed: hints near the truth, and one lane's hint half a lap off, so
    # every windowed node is more than window_m = 3 m from the query (a hint
    # 4 m off along the track still finds nodes within 3 m and locks on)
    hint = (s + rng.uniform(-0.2, 0.2, B)).astype(np.float32)
    hint[3] = np.float32((s[3] + 0.5 * float(jt.length)) % float(jt.length))
    W = int(3.0 / float(jt.ds))
    idx = (int(hint[3] / float(jt.ds)) + np.arange(-W, W + 1)) % jt.n_cells
    assert np.hypot(X[3] - np.asarray(jt.X)[idx], Y[3] - np.asarray(jt.Y)[idx]).min() > 4.0
    win_j = jax.vmap(lambda a, b, c, h: jtrack.global_to_frenet_windowed(jt, a, b, c, h))(X, Y, psi, hint)
    win_p = global_to_frenet_windowed(pt, t(X), t(Y), t(psi), t(hint))
    for got, want in zip(win_p, win_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    dense_p = global_to_frenet(pt, t(X), t(Y), t(psi))
    assert float(win_p[0][3]) == float(dense_p[0][3])                   # lane 3 fell back
    # without a wrong hint every lane takes the windowed answer
    hint[3] = s[3]
    for got, want in zip(global_to_frenet_windowed(pt, t(X), t(Y), t(psi), t(hint)), dense_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_reference_tables_match_jax():
    jt = jrace()
    pt = convert.track(jt, device="cpu")
    L = float(jt.length)
    jtab, leaves = sinusoidal_table(L)
    ptab = convert.ref_table(jtab, device="cpu")
    rng = np.random.default_rng(1)
    s = rng.uniform(-2.0, 2 * L, (5, 21)).astype(np.float32)
    for got, want in zip(ptab.lookup(torch.tensor(s)), jtab.lookup(jnp.asarray(s))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    cfg = JMPCConfig(N=20, model="dynamic")
    want = jax.vmap(lambda row: jrefs_from_table(cfg, jtab, row))(jnp.asarray(s))
    got = refs_from_table(convert.mpc_config(cfg), ptab, torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.abs(got[..., 3].numpy()).max() > 0.02          # a real heading reference
    for ds, vx0 in ((0.05, 1.5), (0.02, 1.2)):
        jit_ = jinitial_table(jt, ds=ds, vx0=vx0)
        pit = initial_table(pt, ds=ds, vx0=vx0)
        assert isinstance(pit, RefTable)
        for name in ("ds", "length", "vx", "ey", "delta"):
            np.testing.assert_allclose(getattr(pit, name).numpy(), np.asarray(getattr(jit_, name)),
                                       atol=1e-6, rtol=0)


def _states(rng, n=B):
    x = np.stack([rng.uniform(0.8, 2.5, n), rng.uniform(-0.15, 0.15, n), rng.uniform(-1.0, 1.0, n),
                  rng.uniform(-0.2, 0.2, n), rng.uniform(0.0, 30.0, n), rng.uniform(-0.3, 0.3, n)], 1)
    u = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-2.0, 3.0, n)], 1)
    return x.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("tire", ["linear", "pacejka"])
def test_world_frame_plant_matches_jax(tire):
    rng = np.random.default_rng(2)
    xg, u = _states(rng)
    xg[:, 3:5] = rng.uniform(-5.0, 5.0, (B, 2))
    xg[:, 5] = rng.uniform(-3.0, 3.0, B)
    mu = rng.uniform(0.5, 1.2, B).astype(np.float32)
    jp = jax.vmap(lambda m: JVehicleParams(mu=m))(jnp.asarray(mu))
    pp = VehicleParams(mu=torch.tensor(mu))
    want = jax.vmap(lambda p, x, uu: jgl.f_global(p, x, uu, tire))(jp, xg, u)
    got = f_global(pp, torch.tensor(xg), torch.tensor(u), tire)
    np.testing.assert_allclose(got[:, :3].numpy(), np.asarray(want)[:, :3], atol=4e-4, rtol=0)
    np.testing.assert_allclose(got[:, 3:].numpy(), np.asarray(want)[:, 3:], atol=1e-6, rtol=0)
    cfg = JMPCConfig(N=8, tire=tire)
    want = jax.vmap(lambda p, x, uu: jgl.global_plant_step(p, cfg, x, uu, n_sub=10))(jp, xg, u)
    got = global_plant_step(pp, convert.mpc_config(cfg), torch.tensor(xg), torch.tensor(u), n_sub=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_estimate_frenet_matches_jax():
    jt = jrace()
    pt = convert.track(jt, device="cpu")
    rng = np.random.default_rng(3)
    s, ey, ep, X, Y, psi = _queries(jt, rng)
    xg, _ = _states(rng)
    xg[:, 3], xg[:, 4], xg[:, 5] = X, Y, psi
    lap = rng.integers(0, 3, B).astype(np.float32) * np.float32(jt.length)
    hint = (s + lap + rng.uniform(-0.1, 0.1, B)).astype(np.float32)
    for h in (None, hint):
        want = jax.vmap(lambda x, hh: jgl.estimate_frenet(jt, x, s_hint=hh),
                        in_axes=(0, None if h is None else 0))(xg, h)
        got = estimate_frenet(pt, torch.tensor(xg), s_hint=None if h is None else torch.tensor(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert (got[:, 4].numpy() > float(jt.length) - 1.0).any()          # unwrapped to the hint's lap


@pytest.mark.parametrize("gate_sigma", [0.0, 3.0])
def test_ekf_step_matches_jax(gate_sigma):
    jt = jrace()
    cfg = JMPCConfig(N=8, tire="pacejka")
    rng = np.random.default_rng(4)
    x, u = _states(rng)
    u[:, 1] = 0.0
    P = np.tile(np.diag(rng.uniform(0.01, 0.1, 6)).astype(np.float32), (B, 1, 1))
    z = (x + rng.normal(0.0, 0.02, x.shape)).astype(np.float32)
    z[::5, 5] += 0.3                                       # glitches for the gate
    Q = np.diag([1e-3, 1e-3, 5e-3, 1e-4, 1e-4, 1e-4]).astype(np.float32)
    R = np.diag(np.full(6, 4e-4)).astype(np.float32)
    mu = rng.uniform(0.5, 1.2, B).astype(np.float32)
    want = jax.vmap(lambda m, xx, pp, uu, zz: jekf_step(
        JVehicleParams(mu=m), cfg, jt, JEKFState(xx, pp), uu, zz, jnp.asarray(Q), jnp.asarray(R),
        gate_sigma=gate_sigma))(mu, x, P, u, z)
    got = ekf_step(VehicleParams(mu=torch.tensor(mu)), convert.mpc_config(cfg), convert.track(jt, device="cpu"),
                   EKFState(torch.tensor(x), torch.tensor(P)), torch.tensor(u), torch.tensor(z),
                   torch.tensor(Q), torch.tensor(R), gate_sigma=gate_sigma)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), atol=1e-5, rtol=0)


def test_friction_rls_matches_jax():
    rng = np.random.default_rng(5)
    x_prev, u = _states(rng)
    x_next = (x_prev + rng.normal(0.0, 0.05, x_prev.shape)).astype(np.float32)
    jp = JVehicleParams()
    forces_j = jax.vmap(lambda a, b, c: jaxle_forces(jp, a, b, c, 1.0 / 30.0))(x_prev, x_next, u)
    forces_p = measured_axle_forces(VehicleParams(), torch.tensor(x_prev), torch.tensor(x_next),
                                    torch.tensor(u), 1.0 / 30.0)
    for got, want, tol in zip(forces_p, forces_j, (4e-4, 4e-4, 1e-6, 1e-6)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    mu = rng.uniform(0.3, 1.3, B).astype(np.float32)
    P0 = rng.uniform(0.05, 0.5, B).astype(np.float32)
    want = jax.vmap(lambda m, pr, a, b, c: jfriction_step(jp, JFrictionState(m, pr), a, b, c, 1.0 / 30.0))(
        mu, P0, x_prev, x_next, u)
    got = friction_step(VehicleParams(), FrictionState(torch.tensor(mu), torch.tensor(P0)),
                        torch.tensor(x_prev), torch.tensor(x_next), torch.tensor(u), 1.0 / 30.0)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), atol=1e-5, rtol=0)
    assert (np.abs(got.mu.numpy() - mu) > 1e-3).sum() >= B // 4      # the gate let updates through


def test_analytic_mu_sensitivity_and_inv6():
    """The racestep's closed-form dFy/dmu against torch.func.grad of the
    port's tire model and jax.grad of the JAX one (atol 2e-5, rtol 2e-4 as
    tests/test_racestep.py); the unpivoted Gauss-Jordan 6x6 inverse against
    torch.linalg.inv on SPD matrices."""
    rng = np.random.default_rng(6)
    mu, alpha = rng.uniform(0.2, 1.4, 50), rng.uniform(-0.3, 0.3, 50)
    stiff, fz = rng.uniform(20.0, 80.0, 50), rng.uniform(5.0, 20.0, 50)
    args = [np.asarray(a, np.float32) for a in (mu, alpha, stiff, fz)]
    fy, g_an = pacejka_mu_sensitivity(*(torch.tensor(a) for a in args))
    g_torch = torch.func.vmap(torch.func.grad(
        lambda m, a, s, f: tire_force_pacejka(a, s, m * f)))(*(torch.tensor(a) for a in args))
    g_jax = jax.vmap(jax.grad(lambda m, a, s, f: jtire_pacejka(a, s, m * f)))(*args)
    np.testing.assert_allclose(g_an.numpy(), g_torch.numpy(), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(g_an.numpy(), np.asarray(g_jax), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(fy.numpy(), tire_force_pacejka(torch.tensor(args[1]), torch.tensor(args[2]),
                                                              torch.tensor(args[0] * args[3])).numpy(),
                               atol=1e-5, rtol=0)
    A = rng.normal(size=(B, 6, 6))
    S = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    got = _inv6(torch.tensor(S).permute(1, 2, 0)).permute(2, 0, 1)
    want = torch.linalg.inv(torch.tensor(S, dtype=torch.float64)).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)

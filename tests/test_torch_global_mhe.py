"""The port's world-frame closed loop (``loop.closed_loop_global``) and
moving-horizon estimator (``loop/mhe.py``) vs the JAX package, on the CPU
(the JAX fused kernel in interpret mode).

- ``closed_loop_global``, noise-free, T=40 on the oval, without the EKF
  on the "plain" route (JAX "xla") and with it on the "fused" route (the
  fused kernel's plain version; JAX "fused"); the plain route with the
  EKF is the noisy case below. Each JAX run is a compile of some 3-5 s,
  so three runs cover the routes and flags. The tracker is
  tests/test_global_loop.py's at N=10 and max_iter=20 (its N=16 and 40
  run on the card, ``chip_smoke.py`` ``[global]``, and in the slow test
  below), which keeps the port's plain fused solve and EKF within the
  file's time. The first of two cars in one batched call against JAX's
  loop: 2e-4 on every logged state and input (the port's closed-loop
  parity bound, tests/test_torch_closed_loop.py), the converged flags
  equal; the second car of the batch equals the car run alone (1e-6).
- With sensor noise and the EKF, plain route: JAX's own draws (its key chain,
  tests/test_global_loop.py's sigma and key 3) handed to the port as the
  pre-drawn ``noise``: 2e-4.
- ``mhe_solve`` on one window and ``mhe_step`` over the five protocols of
  tests/test_mhe.py (noise-free, noisy, vy unmeasured, a biased cold start,
  one s outlier of 0.6 L): 1e-4 on every estimate, and the JAX test's own
  bound on the port's estimates; a batch of the three noisy runs equals
  the three single runs (1e-6).
- ``slow``: the multi-lap unwrap of tests/test_global_loop.py (its
  tracker, T=400): s monotone across the start line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autonomous_racing_lpv_mpp_mpc_tpu.ops.fused_kernel as jfk
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import MHEConfig as JMHEConfig
from autonomous_racing_lpv_mpp_mpc_tpu.loop import closed_loop_global as jclosed_loop_global
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mhe_init as jmhe_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mhe_step as jmhe_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop import plant_step as jplant_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mhe import mhe_solve as jmhe_solve
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    MHEConfig, closed_loop_global, constant_refs, mhe_init, mhe_solve, mhe_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track

CPU = "cpu"
NX = 6
T_GLOBAL = 40
X0S = np.array([[1.0, 0.0, 0.0, 0.0, 0.0, 0.05], [1.2, 0.0, 0.0, 0.0, 0.5, -0.05]], np.float32)
SIGMA = np.array([0.02, 0.01, 0.02, 0.01, 0.01, 0.005], np.float32)
_BACKEND = {"plain": "xla", "fused": "fused"}


def _tracker():
    return MPCConfig(N=10), JMPCConfig(N=10)


def _jax_global(backend, use_ekf, x0, monkeypatch, **kw):
    if backend == "fused":
        orig = jfk.fused_mpc_solve
        monkeypatch.setattr(jfk, "fused_mpc_solve", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    _, jcfg = _tracker()
    scfg = JSolverConfig(max_iter=20, rho_interval=0, backend=_BACKEND[backend])
    return jclosed_loop_global(JVehicleParams(), jcfg, scfg, joval(), jnp.asarray(x0), jconstant_refs(jcfg, 1.5),
                               T=T_GLOBAL, use_ekf=use_ekf, **kw)


def _port_global(backend, use_ekf, x0s, **kw):
    cfg, _ = _tracker()
    return closed_loop_global(VehicleParams(), cfg, SolverConfig(max_iter=20, rho_interval=0, backend=backend),
                              oval_track(device=CPU), torch.tensor(x0s), constant_refs(cfg, 1.5, device=CPU),
                              T=T_GLOBAL, use_ekf=use_ekf, **kw)


@pytest.mark.parametrize("backend,use_ekf", [("plain", False), ("fused", True)])
def test_closed_loop_global_matches_jax(backend, use_ekf, monkeypatch):
    jlog = _jax_global(backend, use_ekf, X0S[0], monkeypatch)
    log = _port_global(backend, use_ekf, X0S)                    # both cars in one batch
    for name in ("Xg", "Xf", "U"):
        np.testing.assert_allclose(getattr(log, name)[:, 0].numpy(), np.asarray(getattr(jlog, name)), atol=2e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(log.converged[:, 0].numpy(), np.asarray(jlog.converged))
    assert float(log.Xf[-1, :, 4].min()) > 1.5                   # both cars progressed
    if backend == "plain" and not use_ekf:
        # the second car of the batch is the car run alone
        alone = _port_global(backend, use_ekf, X0S[1])
        for a, b in zip(log, alone):
            np.testing.assert_allclose(a[:, 1].numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_closed_loop_global_with_jax_noise():
    _, jcfg = _tracker()
    key = jax.random.PRNGKey(3)
    jlog = jclosed_loop_global(JVehicleParams(), jcfg, JSolverConfig(max_iter=20, rho_interval=0), joval(),
                               jnp.asarray(X0S[0]), jconstant_refs(jcfg, 1.5), T=T_GLOBAL,
                               noise_sigma=jnp.asarray(SIGMA), key=key, use_ekf=True)

    def draw(k, _):                     # closed_loop_global's key chain
        k, k2 = jax.random.split(k)
        return k, jax.random.normal(k2, (NX,), jnp.float32)

    _, noise = jax.lax.scan(draw, key, None, length=T_GLOBAL)
    cfg, _ = _tracker()
    log = closed_loop_global(VehicleParams(), cfg, SolverConfig(max_iter=20, rho_interval=0),
                             oval_track(device=CPU), torch.tensor(X0S[0]), constant_refs(cfg, 1.5, device=CPU),
                             T=T_GLOBAL, noise_sigma=SIGMA, noise=torch.tensor(np.asarray(noise)), use_ekf=True)
    for name in ("Xg", "Xf", "U"):
        np.testing.assert_allclose(getattr(log, name).numpy(), np.asarray(getattr(jlog, name)), atol=2e-4, rtol=0,
                                   err_msg=name)
    # a generator draws a stream of its own, reproducibly
    runs = [closed_loop_global(VehicleParams(), cfg, SolverConfig(max_iter=20, rho_interval=0),
                               oval_track(device=CPU), torch.tensor(X0S[0]), constant_refs(cfg, 1.5, device=CPU),
                               T=3, noise_sigma=SIGMA, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0].Xf, runs[1].Xf) and not torch.equal(runs[0].Xf, log.Xf[:3])


@pytest.mark.slow
def test_closed_loop_global_multilap_unwrap():
    cfg = MPCConfig(N=16)
    track = oval_track(device=CPU)
    log = closed_loop_global(VehicleParams(), cfg, SolverConfig(max_iter=40, rho_interval=0), track,
                             torch.tensor([1.5, 0.0, 0.0, 0.0, 0.0, 0.0]), constant_refs(cfg, 1.8, device=CPU),
                             T=400)
    s = log.Xf[:, 4].numpy()
    assert s[-1] > 1.5 * float(track.length)
    assert np.all(np.diff(s) > -0.05)


# ---- MHE: the protocols of tests/test_mhe.py ----

def _drive_inputs(T):
    t = np.arange(T, dtype=np.float32)
    return np.stack([0.08 * np.sin(2 * np.pi * t / 40.0), 0.3 + 0.2 * np.cos(2 * np.pi * t / 60.0)],
                    axis=1).astype(np.float32)


def _truth(x0, U):
    cfg, track = JMPCConfig(N=12), joval()

    def step(x, u):
        xn = jplant_step(JVehicleParams(), cfg, track, x, u, n_sub=4)
        return xn, xn

    return np.asarray(jax.lax.scan(step, jnp.asarray(x0), jnp.asarray(U))[1])


def _protocol(name):
    """(W, H, Qw, Rv, P0, Z, U, x0 guess, truth, the JAX test's check)."""
    eye = np.eye(NX, dtype=np.float32)
    x0 = np.array([1.2, 0.0, 0.0, 0.0, 0.0, 0.05], np.float32)
    if name == "noise_free":
        U = _drive_inputs(30)
        X = _truth(x0, U)
        return 6, eye, 1e-4 * eye, 1e-6 * eye, 0.1 * eye, X, U, x0, X, \
            lambda Xh: np.abs(Xh[6:] - X[6:]).max() < 2e-3
    if name == "noisy":
        U = _drive_inputs(90)
        X = _truth(x0, U)
        sig = np.array([0.05, 0.02, 0.05, 0.02, 0.02, 0.02], np.float32)
        Z = X + sig * np.asarray(jax.random.normal(jax.random.PRNGKey(0), X.shape))
        rmse = lambda A: np.sqrt(np.mean((A[8:] - X[8:]) ** 2))
        return 8, eye, 1e-4 * eye, np.diag(sig ** 2), 0.1 * eye, Z, U, x0, X, \
            lambda Xh: rmse(Xh) < 0.6 * rmse(Z)
    if name == "vy_unmeasured":
        U = _drive_inputs(80)
        x0 = np.array([1.5, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
        X = _truth(x0, U)
        H = eye[[0, 2, 3, 4, 5]]
        sig = np.array([0.02, 0.02, 0.01, 0.01, 0.01], np.float32)
        Z = X @ H.T + sig * np.asarray(jax.random.normal(jax.random.PRNGKey(1), (80, 5)))
        return 8, H, 1e-4 * eye, np.diag(sig ** 2), 0.1 * eye, Z, U, x0, X, \
            lambda Xh: np.abs(Xh[16:, 1] - X[16:, 1]).max() < 0.5 * np.abs(X[16:, 1]).max() + 0.01
    if name == "poor_guess":
        U = _drive_inputs(40)
        X = _truth(x0, U)
        bad = x0 + np.array([0.4, 0.05, 0.1, 0.05, 0.0, -0.15], np.float32)
        return 6, eye, 1e-3 * eye, 1e-5 * eye, 0.5 * eye, X, U, bad, X, \
            lambda Xh: np.abs(Xh[12:] - X[12:]).max() < 5e-3
    if name == "s_outlier":
        U = _drive_inputs(60)
        X = _truth(x0, U)
        Z = X.copy()
        L = float(joval().length)
        Z[25, 4] += 0.6 * L
        return 6, eye, 1e-4 * eye, 1e-4 * eye, 0.1 * eye, Z, U, x0, X, \
            lambda Xh: np.abs(Xh[:, 4] - X[:, 4]).max() < L / 4 and np.abs(Xh[33:, 4] - X[33:, 4]).max() < 5e-3
    raise ValueError(name)


def _jax_filter(W, H, Qw, Rv, P0, Z, U, x0):
    mcfg, cfg, track = JMHEConfig(W=W, n_gn=2), JMPCConfig(N=12), joval()
    mats = [jnp.asarray(a) for a in (P0, H, Qw, Rv)]

    @jax.jit
    def run(st):
        step = lambda st, inp: jmhe_step(JVehicleParams(), cfg, mcfg, track, st, inp[0], inp[1], *mats)
        return jax.lax.scan(step, st, (jnp.asarray(U), jnp.asarray(Z)))[1]

    return np.asarray(run(jmhe_init(cfg, mcfg, jnp.asarray(x0), jnp.asarray(H))))


def _port_filter(W, H, Qw, Rv, P0, Z, U, x0):
    """MHE over (T, ...) inputs, or a batch (B, T, ...) with x0 (B, nx)."""
    mcfg, cfg, track = MHEConfig(W=W, n_gn=2), MPCConfig(N=12), oval_track(device=CPU)
    P0, H, Qw, Rv, Z, U, x0 = (torch.tensor(np.asarray(a, np.float32)) for a in (P0, H, Qw, Rv, Z, U, x0))
    st = mhe_init(cfg, mcfg, x0, H)
    out = []
    for k in range(Z.shape[-2]):
        st, x_hat = mhe_step(VehicleParams(), cfg, mcfg, track, st, U[..., k, :], Z[..., k, :], P0, H, Qw, Rv)
        out.append(x_hat)
    return torch.stack(out, dim=-2).numpy()


@pytest.mark.parametrize("name", ["noise_free", "noisy", "vy_unmeasured", "poor_guess", "s_outlier"])
def test_mhe_step_matches_jax(name):
    W, H, Qw, Rv, P0, Z, U, x0, _X, check = _protocol(name)
    ours = _port_filter(W, H, Qw, Rv, P0, Z, U, x0)
    np.testing.assert_allclose(ours, _jax_filter(W, H, Qw, Rv, P0, Z, U, x0), atol=1e-4, rtol=0)
    assert check(ours)


@pytest.mark.parametrize("riccati", ["scan", "assoc"])
def test_mhe_solve_matches_jax(riccati):
    W, H, Qw, Rv, P0, Z, U, x0, X, _ = _protocol("noisy")
    z_hist, u_hist, X_guess = Z[20:29], U[20:28], np.repeat(X[19:20], 9, axis=0)
    jout = jmhe_solve(JVehicleParams(), JMPCConfig(N=12), JMHEConfig(W=W, n_gn=2, riccati=riccati), joval(),
                      *(jnp.asarray(a) for a in (z_hist, u_hist, X_guess, X[19], P0, H, Qw, Rv)))
    ours = mhe_solve(VehicleParams(), MPCConfig(N=12), MHEConfig(W=W, n_gn=2, riccati=riccati),
                     oval_track(device=CPU),
                     *(torch.tensor(np.asarray(a, np.float32)) for a in (z_hist, u_hist, X_guess, X[19], P0, H, Qw,
                                                                         Rv)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jout), atol=1e-4, rtol=0)


def test_mhe_batch_equals_single_runs():
    W, H, Qw, Rv, P0, Z, U, x0, _X, _ = _protocol("noisy")
    rng = np.random.default_rng(2)
    Zs = np.stack([Z, Z + 0.01 * rng.standard_normal(Z.shape), Z - 0.01 * rng.standard_normal(Z.shape)])
    x0s = np.stack([x0, x0 + 0.02, x0 - 0.02]).astype(np.float32)
    batch = _port_filter(W, H, Qw, Rv, P0, Zs[:, :30], np.broadcast_to(U[:30], (3, 30, 2)), x0s)
    for b in range(3):
        np.testing.assert_allclose(batch[b], _port_filter(W, H, Qw, Rv, P0, Zs[b, :30], U[:30], x0s[b]),
                                   atol=1e-6, rtol=0)

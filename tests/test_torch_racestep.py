"""The racestep's plain PyTorch version vs the JAX package's racestep kernel
(Pallas, interpret mode under ``jax.jit``) on the CPU, with shared,
constant and per-lane references and with an obstacle corridor, its
measurement and its innovation gating. The wrapper's routing and the kernel-vs-plain test
on a card are in tests/test_torch_port.py, which imports no JAX.

Bounds against JAX over 5 composed steps (3 with per-lane tables or a
corridor) with identical numpy noise: u0
2e-4; xg, ekx, X_pred and z 5e-4; fr 1e-4 (the megastep's kernel-parity
bounds plus the measurement's). The measurement stage against
``global_to_frenet_windowed``: 2e-5 (tests/test_racestep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.engine import assembly as jasm
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop.lap_learning import initial_table as jinitial_table
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_params as jmegastep_params
from autonomous_racing_lpv_mpp_mpc_tpu.ops.racestep_kernel import racestep as jracestep
from autonomous_racing_lpv_mpp_mpc_tpu.ops.racestep_kernel import racestep_init as jracestep_init
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace
from autonomous_racing_lpv_mpp_mpc_tpu.planner.opponents import DUMMY_BLOCK
from autonomous_racing_lpv_mpp_mpc_tpu.track.track import global_to_frenet_windowed, wrap_s

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import DEFAULT_EKF_Q, constant_refs, initial_table
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    megastep, megastep_params, racestep, racestep_init, racestep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track

P = JVehicleParams()
CFG = JMPCConfig(N=8, model="dynamic", tire="pacejka")
SCFG = JSolverConfig(max_iter=30)
SIGMA = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
EKF_Q = np.asarray(DEFAULT_EKF_Q, np.float32)
B = 3


def _inputs():
    track = joval()
    mu_b = np.array([0.5, 0.8, 1.1], np.float32)
    x0 = np.zeros((B, 6), np.float32)
    x0[:, 0] = 1.2
    x0[:, 4] = 2.0
    rng = np.random.default_rng(0)
    noise = [(SIGMA[:, None] * rng.standard_normal((6, B))).astype(np.float32) for _ in range(5)]
    return track, mu_b, x0, noise


def _per_lane_table(track):
    """``initial_table`` made per lane: every leaf broadcast to (B,) +
    shape, each lane its own vx level and a racing line of its own."""
    base = jinitial_table(track, ds=0.05, vx0=1.2)
    n = base.vx.shape[0]
    w = 2 * np.pi * np.arange(n, dtype=np.float32) * float(base.ds) / float(base.length)
    lane = np.arange(B, dtype=np.float32)[:, None]
    lanes = lambda a: jnp.broadcast_to(a, (B,) + jnp.shape(a))
    return base.replace(ds=lanes(base.ds), length=lanes(base.length),
                        vx=jnp.asarray((1.1 + 0.1 * lane + 0.2 * np.sin(w)).astype(np.float32)),
                        ey=jnp.asarray((0.06 * (lane - 1) * np.sin(2 * w + lane)).astype(np.float32)),
                        delta=jnp.zeros((B, n), jnp.float32))


def _jax_eyb(track, carry, blocks):
    """The (N+1, 2, B) corridor operand along the JAX carry's schedule,
    made by the JAX package's corridor functions (as its race runner does)."""
    half = CFG.bounds.ey_max
    s = jnp.concatenate([carry.ekx[4][None], carry.X_pred[2:, 4], carry.X_pred[-1:, 4]], axis=0)
    sm = wrap_s(track, s)
    lo, hi = jasm.corridor_from_blocks(sm, jnp.full(sm.shape, -half), jnp.full(sm.shape, half), blocks, 0.0,
                                       half, kappa_blk=jasm.block_curvatures(track, blocks),
                                       kappa_cap=jasm.steerable_curvature(P, CFG.bounds.delta_max))
    return np.asarray(jnp.stack([lo, hi], axis=1))


@pytest.mark.parametrize("refs", ["table", "constant", "per_lane", "table+eyb"])
def test_racestep_plain_matches_jax_kernel(refs):
    """Composed steps with EKF and adaptation on and noisy measurements: 5
    with a shared table or constant references, 3 with per-lane tables and
    with a shared table under an obstacle corridor (eyb). The corridor is
    made once per step from the JAX carry and handed to both sides."""
    track, mu_b, x0, noise = _inputs()
    jref = {"constant": jconstant_refs(CFG, 1.2), "per_lane": _per_lane_table(track)}.get(
        refs, jinitial_table(track, ds=0.05, vx0=1.2))
    jprm = jmegastep_params(P.replace(mu=jnp.float32(0.8)), B)
    step = jax.jit(lambda c, n, e: jracestep(CFG, SCFG, track, jprm, jref, c, n, jnp.asarray(mu_b),
                                             EKF_Q, SIGMA ** 2, interpret=True, eyb=e))
    jc = jracestep_init(P, CFG, track, jnp.asarray(x0), 0.8)
    cfg, scfg, ptrack = convert.mpc_config(CFG), convert.solver_config(SCFG), convert.track(track, device="cpu")
    pref = constant_refs(cfg, 1.2, device="cpu") if refs == "constant" else convert.ref_table(jref, device="cpu")
    pc = racestep_init(VehicleParams(), cfg, ptrack, torch.tensor(x0), 0.8)
    prm = megastep_params(VehicleParams(mu=0.8), B, device="cpu")
    blocks = jnp.asarray([[2.1, 2.6, -0.3, 0.05], DUMMY_BLOCK], jnp.float32)
    ey_bound = []
    for k in range(3 if refs in ("per_lane", "table+eyb") else 5):
        eyb = _jax_eyb(track, jc, blocks) if refs == "table+eyb" else None
        jc, ju, jd, jz = step(jc, jnp.asarray(noise[k]), eyb)
        pc, pu, pd, pz = racestep(cfg, scfg, ptrack, prm, pref, pc, torch.tensor(noise[k]),
                                  torch.tensor(mu_b), EKF_Q, SIGMA ** 2,
                                  eyb=None if eyb is None else torch.tensor(eyb))
        ey_bound.append(eyb is not None and bool((eyb[:, 0] > -CFG.bounds.ey_max).any()))
        np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=2e-4, rtol=0)
        np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=5e-4, rtol=0)
        for name, tol in (("xg", 5e-4), ("ekx", 5e-4), ("X_pred", 5e-4), ("fr", 1e-4)):
            np.testing.assert_allclose(getattr(pc, name).numpy(), np.asarray(getattr(jc, name)),
                                       atol=tol, rtol=0, err_msg=f"{name} at step {k}")
        np.testing.assert_array_equal(pd[2].numpy(), np.asarray(jd[2]))        # converged flags
        np.testing.assert_allclose(pd[5].numpy(), np.asarray(jd[5]), atol=1e-4, rtol=0)  # mu-hat
    assert np.abs(pc.fr[0].numpy() - 0.8).max() > 1e-3                     # the RLS moved
    assert racestep.launches == 0 and megastep.launches == 0
    assert any(ey_bound) == (refs == "table+eyb")                           # the corridor reached stages


def test_racestep_measurement_matches_windowed_transform():
    """The measurement stage at cells with chunk offsets {0, 1, 63, 64, 127}
    of the TPU layout's 128-cell chunks {0, 3, 7, 12}, with the hint 0.25 m
    behind the truth, against the JAX ``global_to_frenet_windowed``."""
    track = jrace()
    ds = float(track.ds)
    n_cells = track.kappa.shape[0]
    cells = [j * 128 + o for j in (0, 3, 7, 12) for o in (0, 1, 63, 64, 127)]
    nb = len(cells)
    x0 = np.zeros((nb, 6), np.float32)
    x0[:, 0] = 1.2
    x0[:, 4] = [(c % n_cells) * ds + 0.4 * ds for c in cells]
    x0[:, 5] = [(-0.1 if i % 2 else 0.15) for i in range(nb)]
    x0[:, 3] = [(0.05 if i % 3 else -0.08) for i in range(nb)]
    cfg = MPCConfig(N=8, model="dynamic", tire="pacejka")
    ptrack = convert.track(track, device="cpu")
    carry = racestep_init(VehicleParams(), cfg, ptrack, torch.tensor(x0), 0.8)
    carry = carry._replace(ekx=carry.ekx.clone())
    carry.ekx[4] -= 0.25
    _, _, _, z = racestep_plain(cfg, SolverConfig(max_iter=4), ptrack,
                                megastep_params(VehicleParams(), nb, device="cpu"), constant_refs(cfg, 1.2, device="cpu"), carry,
                                torch.zeros((6, nb)), torch.full((nb,), 0.8),
                                np.full(6, 1e-4, np.float32), np.full(6, 1e-4, np.float32),
                                use_ekf=False, adapt_mu=False)
    xg, hint = carry.xg.numpy(), carry.ekx[4].numpy()
    want = jax.vmap(lambda a, b, c, h: global_to_frenet_windowed(track, a, b, c, h))(
        xg[3], xg[4], xg[5], hint)
    np.testing.assert_allclose(np.asarray(wrap_s(track, jnp.asarray(z[4].numpy()))),
                               np.asarray(want[0]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(z[5].numpy(), np.asarray(want[1]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(z[3].numpy(), np.asarray(want[2]), atol=2e-5, rtol=0)


def test_racestep_ekf_innovation_gating():
    """A one-frame +0.3 m glitch on the e_y channel: the ungated filter
    jumps toward it, the gated one (gate_sigma=3) barely moves."""
    track = oval_track(device="cpu")
    cfg = MPCConfig(N=8, model="dynamic", tire="pacejka")
    x0 = torch.zeros((1, 6))
    x0[:, 0] = 1.2
    x0[:, 4] = 2.0
    prm = megastep_params(VehicleParams(mu=0.9), 1, device="cpu")
    table = initial_table(track, ds=0.05, vx0=1.2)
    ekr = np.full(6, 1e-4, np.float32)
    clean = torch.zeros((6, 1))
    spike = clean.clone()
    spike[5, 0] = 0.3

    def settle_then_spike(gate):
        car = racestep_init(VehicleParams(), cfg, track, x0, 0.9)
        step = lambda c, n: racestep(cfg, SolverConfig(max_iter=30), track, prm, table, c, n,
                                     torch.full((1,), 0.9), EKF_Q, ekr, gate_sigma=gate)
        for _ in range(20):
            car, _, _, _ = step(car, clean)
        before = float(car.x_prev_f[5, 0])
        car, _, _, _ = step(car, spike)
        return float(car.x_prev_f[5, 0]) - before

    d_ungated, d_gated = settle_then_spike(0.0), settle_then_spike(3.0)
    assert abs(d_ungated) > 0.1, d_ungated
    assert abs(d_gated) < 0.03, d_gated

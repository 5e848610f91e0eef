"""The port's composed race loop vs the JAX package's ``batched_race_sweep``
on the CPU, and the carries handed across by ``convert``.

- ``mega_race_sweep`` (every step one racestep; the plain version on CPU
  tensors) and ``batched_race_sweep`` (the module composition) against the
  JAX ``batched_race_sweep``: T=80 steps, B=3 lanes on the oval, clean
  measurements, per-lane plant friction, adaptation on; Xf, U and mu-hat
  within 1e-4 (tests/test_racestep.py's kernel-vs-composition bound). The
  composition again with an all-zero ``noise_sigma`` (20 steps), where the
  EKF's R is diag(sigma^2) = 0 as in the JAX composition.
- ``make_racestep_scan(table_arg=True, obstacles_arg=True)`` with per-lane
  tables and moving opponent blocks against the JAX runner: 4 clean steps,
  Xf, U and mu-hat within 1e-4.
- ``convert`` hands RefTable (shared and per lane), OpponentSet,
  RaceMegaCarry, EKFState, FrictionState and RaceCarry objects of the JAX
  package to the port and back unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import batched_race_sweep as jbatched_race_sweep
from autonomous_racing_lpv_mpp_mpc_tpu.loop.estimator import ekf_init as jekf_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.friction import friction_init as jfriction_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.lap_learning import initial_table as jinitial_table
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.race import RaceCarry as JRaceCarry
from autonomous_racing_lpv_mpp_mpc_tpu.loop.race import make_racestep_scan as jmake_racestep_scan
from autonomous_racing_lpv_mpp_mpc_tpu.ops.racestep_kernel import racestep_init as jracestep_init
from autonomous_racing_lpv_mpp_mpc_tpu.planner.opponents import opponents as jopponents
from autonomous_racing_lpv_mpp_mpc_tpu.planner.opponents import opponents_obstacle_fn as jopponents_obstacle_fn
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    EKFState, FrictionState, RaceCarry, batched_race_sweep, initial_table, make_racestep_scan,
    mega_race_sweep,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import RaceMegaCarry, racestep, racestep_init
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import OpponentSet, RefTable, pad_blocks

P = JVehicleParams()
CFG = JMPCConfig(N=8, model="dynamic", tire="pacejka")
SCFG = JSolverConfig(max_iter=30)
MU = np.array([0.5, 0.8, 1.1], np.float32)
T = 80
T_ZERO = 20


def _x0():
    x0 = np.zeros((3, 6), np.float32)
    x0[:, 0] = 1.2
    x0[:, 4] = 2.0           # corner entry: lateral dynamics and RLS excitation from the start
    return x0


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX ``batched_race_sweep`` over T steps, and over T_ZERO steps
    with an all-zero noise_sigma (its EKF then takes R = 0)."""
    track = joval()
    runs = {}

    def sweep(zero_noise: bool):
        if zero_noise not in runs:
            log = jbatched_race_sweep(P, CFG, SCFG, track, jinitial_table(track, ds=0.05, vx0=1.2),
                                      jnp.asarray(_x0()), T=T_ZERO if zero_noise else T,
                                      mu_true_b=jnp.asarray(MU), mu0=0.8,
                                      noise_sigma=np.zeros(6, np.float32) if zero_noise else None)
            runs[zero_noise] = {k: np.asarray(getattr(log, k)) for k in ("Xg", "Xf", "U", "mu_hat", "converged")}
        return runs[zero_noise]

    return track, sweep


@pytest.mark.parametrize("sweep", ["mega_race_sweep", "batched_race_sweep", "batched_race_sweep-zero-noise"])
def test_composed_sweep_matches_jax(jax_sweep, sweep):
    track, jax_run = jax_sweep
    zero_noise = sweep.endswith("zero-noise")
    ref = jax_run(zero_noise)
    steps = T_ZERO if zero_noise else T
    ptrack = convert.track(track, device="cpu")
    fn = {"mega_race_sweep": mega_race_sweep, "batched_race_sweep": batched_race_sweep}[sweep.split("-")[0]]
    out = fn(VehicleParams(), convert.mpc_config(CFG), convert.solver_config(SCFG), ptrack,
             initial_table(ptrack, ds=0.05, vx0=1.2), torch.tensor(_x0()), steps, torch.tensor(MU), mu0=0.8,
             noise_sigma=np.zeros(6, np.float32) if zero_noise else None)
    for name in ("Xf", "U", "mu_hat"):
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name], atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(out.Xg.numpy(), ref["Xg"], atol=1e-4, rtol=0)
    assert out.Xf.shape == (3, steps, 6) and out.mu_hat.shape == (3, steps)
    if not zero_noise:
        assert abs(float(out.mu_hat[0, -1]) - 0.8) > 0.02       # the adaptation moved
    assert float(out.converged.mean()) > 0.9
    assert racestep.launches == 0


def test_racestep_scan_runner_and_noise():
    """The runner built once takes a carry and a generator; the same seed
    gives the same noisy run, another seed another one."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import racestep_init
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track

    track = oval_track(device="cpu")
    cfg = MPCConfig(N=8, model="dynamic", tire="pacejka")
    scfg = SolverConfig(max_iter=20)
    table = initial_table(track, ds=0.05, vx0=1.2)
    sigma = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
    car0 = racestep_init(VehicleParams(), cfg, track, torch.tensor(_x0()), 0.8)
    run = make_racestep_scan(VehicleParams(mu=0.8), cfg, scfg, track, table, 4, torch.tensor(MU), sigma)
    gen = lambda s: torch.Generator().manual_seed(s)
    c1, o1 = run(car0, gen(0))
    c2, o2 = run(car0, gen(0))
    _, o3 = run(car0, gen(1))
    assert all(a.shape[0] == 4 for a in o1) and o1[0].shape == (4, 6, 3)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    assert not torch.equal(o1[5], o3[5])                       # the raw measurements differ
    assert (o1[5] - o1[1]).abs().max() > 1e-3                   # z is not the filtered state
    # static corridor blocks: all-dummy rows change nothing, a block ahead
    # of the cars does; moving blocks need the table argument too
    blocked = lambda obs: make_racestep_scan(VehicleParams(mu=0.8), cfg, scfg, track, table, 4,
                                             torch.tensor(MU), sigma, obstacles=obs)(car0, gen(0))[1]
    for a, b in zip(o1, blocked(pad_blocks(None, 4))):
        assert torch.equal(a, b)
    o4 = blocked(np.array([[2.0, 2.6, -0.4, 0.1]], np.float32))
    assert (o4[2] - o1[2]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="table_arg"):
        make_racestep_scan(VehicleParams(), cfg, scfg, track, table, 4, torch.tensor(MU), sigma,
                           obstacles_arg=True)


def test_convert_round_trips_race_objects():
    track = joval()
    x0 = jnp.asarray(_x0())
    jtab = jinitial_table(track, ds=0.05, vx0=1.2)
    tab = convert.ref_table(jtab, device="cpu")
    assert isinstance(tab, RefTable)
    for k, v in convert.to_numpy(tab).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jtab, k)))
    # per lane: every leaf with a leading lane axis
    jlanes = jax.tree.map(lambda a: jnp.stack([a, 0.9 * a, 1.1 * a]), jtab)
    lanes = convert.ref_table(jlanes, device="cpu")
    assert lanes.vx.shape == (3, jtab.vx.shape[0]) and lanes.ds.shape == (3,)
    for k, v in convert.to_numpy(lanes).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jlanes, k)))
    jo = jopponents([1.0, 5.0], [0.1, -0.2], [0.8, -0.5])
    to = convert.opponent_set(jo, device="cpu")
    assert isinstance(to, OpponentSet)
    for k, v in convert.to_numpy(to).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jo, k)))

    jmc = jracestep_init(P, CFG, track, x0, 0.8)
    mc = convert.race_mega_carry(jmc, device="cpu")
    assert isinstance(mc, RaceMegaCarry)
    back = convert.to_numpy(mc)
    assert set(back) == set(RaceMegaCarry._fields)
    for k in RaceMegaCarry._fields:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jmc, k)))

    jek = jax.vmap(jekf_init)(x0)
    ek = convert.ekf_state(jek, device="cpu")
    assert isinstance(ek, EKFState) and ek.P.shape == (3, 6, 6)
    jfr = jax.vmap(lambda m: jfriction_init(m))(jnp.asarray(MU))
    fr = convert.friction_state(jfr, device="cpu")
    assert isinstance(fr, FrictionState)
    np.testing.assert_array_equal(convert.to_numpy(fr)["mu"], MU)

    jrc = JRaceCarry(xg=jnp.zeros((3, 6)), mpc=jax.vmap(lambda x: jmpc_init(P, CFG, track, x))(x0),
                     ekf=jek, fric=jfr, x_prev_f=x0, u_prev=jnp.zeros((3, 2)),
                     key=jax.random.split(jax.random.PRNGKey(0), 3))
    rc = convert.race_carry(jrc, device="cpu")
    assert isinstance(rc, RaceCarry) and rc.generator is None
    back = convert.to_numpy(rc)
    assert "generator" not in back
    for k in ("xg", "x_prev_f", "u_prev"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jrc, k)))
    for k, v in back["mpc"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrc.mpc, k)))
    for k, v in back["ekf"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrc.ekf, k)))
    np.testing.assert_array_equal(back["fric"]["P"], np.asarray(jrc.fric.P))


def _per_lane_tables(jt, n_lanes):
    """The JAX table of ``initial_table`` made per lane: every leaf
    broadcast to (B,) + shape, each lane its own vx level and racing line."""
    base = jinitial_table(jt, ds=0.05, vx0=1.2)
    n = base.vx.shape[0]
    s = np.arange(n, dtype=np.float32) * float(base.ds)
    lane = np.arange(n_lanes, dtype=np.float32)[:, None]
    w = 2 * np.pi * s[None] / float(base.length)
    vx = (1.1 + 0.1 * lane + 0.2 * np.sin(w)).astype(np.float32)
    ey = (0.06 * (lane - 1) * np.sin(2 * w + lane)).astype(np.float32)
    b = lambda a: jnp.broadcast_to(a, (n_lanes,) + jnp.shape(a))
    return base.replace(ds=b(base.ds), length=b(base.length), vx=jnp.asarray(vx), ey=jnp.asarray(ey),
                        delta=jnp.zeros((n_lanes, n), jnp.float32))


def test_racestep_scan_with_tables_and_blocks_matches_jax():
    """``make_racestep_scan(table_arg=True, obstacles_arg=True)``:
    ``run(carry, generator, table, blocks)`` with per-lane tables and padded
    moving opponent blocks against the JAX runner (racestep in interpret
    mode), 4 clean steps, 3 lanes on the oval; Xf, U and mu-hat 1e-4."""
    n_lanes, steps = 3, 4
    jt = joval()
    x0 = _x0()
    x0[:, 4] = [2.0, 2.3, 2.6]
    jtab = _per_lane_tables(jt, n_lanes)
    jo = jopponents([2.7, 6.0], [0.05, -0.1], [0.6, 0.9])
    blocks = pad_blocks(jopponents_obstacle_fn(jt, jo, CFG.dt, steps)(0), 8)
    sig = np.zeros(6, np.float32)

    jrun = jmake_racestep_scan(P.replace(mu=jnp.float32(0.8)), CFG, SCFG, jt, None, steps, jnp.asarray(MU), sig,
                               table_arg=True, obstacles_arg=True, interpret=True)
    _, jouts = jrun(jracestep_init(P, CFG, jt, jnp.asarray(x0), 0.8), jax.random.PRNGKey(0), jtab,
                    jnp.asarray(blocks))

    cfg, scfg, tt = convert.mpc_config(CFG), convert.solver_config(SCFG), convert.track(jt, device="cpu")
    p = VehicleParams()
    tab = convert.ref_table(jtab, device="cpu")
    assert tab.vx.shape == (n_lanes, jtab.vx.shape[1]) and tab.ds.shape == (n_lanes,)
    run = make_racestep_scan(p.replace(mu=0.8), cfg, scfg, tt, None, steps, torch.tensor(MU), sig, table_arg=True,
                             obstacles_arg=True)
    car0 = racestep_init(p, cfg, tt, torch.tensor(x0), 0.8)
    _, outs = run(car0, torch.Generator().manual_seed(0), tab, blocks)
    for i, name in ((1, "Xf"), (2, "U"), (3, "mu_hat")):
        np.testing.assert_allclose(outs[i].numpy(), np.asarray(jouts[i]), atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_array_equal(outs[4].numpy(), np.asarray(jouts[4]))          # converged flags
    # the blocks bind: the same runner with all-dummy blocks steers otherwise
    _, free = run(car0, torch.Generator().manual_seed(0), tab, pad_blocks(None, 8))
    assert (free[2] - outs[2]).abs().max() > 1e-3
    assert racestep.launches == 0

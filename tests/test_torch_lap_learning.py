"""The port's lap learner (``loop/lap_learning.py``) vs the JAX package's on
the CPU, at small sizes; inputs are made from numpy seeds.

- ``learn_from_lap`` on B=3 lanes, each with its own table and friction,
  against the JAX function under ``jax.vmap``: dynamic and kinematic, with
  and without corridor blocks and per-step convergence; and the single-car
  form. Tables within 1e-6 (the port bins with ``scatter_add_`` and runs
  the accel filter in closed form; both agree with JAX to ~2.4e-7).
- ``_accel_limit_circular`` at the racetrack's n=635 nodes against JAX's
  sequential scan: relative 2e-6 (a few float32 roundings of the scan).
- ``lap_steps`` (batched, with and without s0, the T+1 sentinel) exactly;
  ``_memorize_obstacles`` and ``batched_refs_from_tables`` within 1e-6.
- ``mega_lap_rollout`` on the plain megastep against JAX's (Pallas in
  interpret mode): B=3, T=12, N=8, Pacejka controller and plant, per-lane
  tables with different speeds and lines, corridor blocks on the lanes'
  path, 15 ADMM iterations at a fixed count; u 2e-4, x 5e-4 (the
  megastep's bounds, tests/test_torch_megastep.py). The case without
  blocks is marked slow: the megastep without a corridor is held against
  JAX's in tests/test_torch_megastep.py.
- ``batched_lap_learning`` for 2 laps of 12 steps in both backends ("plain"
  against JAX "xla" at N=6, "mega" against JAX "mega" in interpret mode,
  with the case and blocks above) and
  ``iterative_lap_learning`` for 2 laps of 12 steps: the same lap steps,
  the tables and the last lap's states within 5e-4, controls within 2e-4.
  The single-car comparison is marked slow; its fast counterpart holds
  ``iterative_lap_learning`` equal (1e-6) to ``batched_lap_learning`` on
  one lane.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import lap_learning as jll
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import lap_learning as ll

B = 3
MUS = np.array([0.5, 0.8, 1.1], np.float32)
TABLE_TOL = dict(atol=1e-6, rtol=0)
U_TOL = dict(atol=2e-4, rtol=0)
X_TOL = dict(atol=5e-4, rtol=0)
BLOCKS = np.array([[2.0, 3.0, -0.1, 0.15], [10.0, 11.5, -0.4, -0.05], [5.0, 4.0, 0.0, 0.0]], np.float32)
ROLL_BLOCKS = np.array([[0.5, 1.4, -0.15, 0.1], [3.3, 4.2, 0.0, 0.3]], np.float32)


def _jax_params_b(mus=MUS):
    p_b = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float32), (len(mus),)), JVehicleParams())
    return dataclasses.replace(p_b, mu=jnp.asarray(mus))


def _jax_tables_b(one, seed=0):
    """Per-lane tables from ``one``: different speeds and racing lines."""
    rng = np.random.default_rng(seed)
    n = one.vx.shape[0]
    tb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), one)
    ey = 0.08 * np.sin(np.arange(n)[None] / rng.uniform(5.0, 9.0, (B, 1)) + rng.uniform(0, 3, (B, 1)))
    return tb.replace(vx=tb.vx * jnp.asarray([1.0, 1.2, 1.4])[:, None], ey=jnp.asarray(ey, jnp.float32))


def _lap_trace(model, n_nodes_L, T=240, seed=1):
    """A synthetic batched lap: speeds, yaw rates, lateral errors and
    controls drawn from a seed, s integrated from vx."""
    rng = np.random.default_rng(seed)
    nx = 6 if model == "dynamic" else 4
    s_i, ey_i = (4, 5) if model == "dynamic" else (2, 3)
    X = np.zeros((B, T, nx), np.float32)
    X[..., 0] = rng.uniform(0.8, 2.2, (B, T))
    if model == "dynamic":
        X[..., 1] = rng.normal(0.0, 0.05, (B, T))
        X[..., 2] = rng.normal(0.0, 0.8, (B, T))
    X[..., s_i] = np.cumsum(X[..., 0] / 30.0, axis=1) + rng.uniform(0.0, n_nodes_L, (B, 1))
    X[..., ey_i] = rng.normal(0.0, 0.1, (B, T))
    U = rng.normal(0.0, 0.1, (B, T, 2)).astype(np.float32)
    conv = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    return X, U, conv


def _cfgs(model):
    if model == "dynamic":
        jcfg = JMPCConfig(N=8)
    else:
        jcfg = JMPCConfig(N=8, model="kinematic", weights=JMPCWeights.for_model("kinematic"))
    return jcfg, convert.mpc_config(jcfg)


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
@pytest.mark.parametrize("extras", [False, True], ids=["bare", "obstacles-converged"])
def test_learn_from_lap_matches_jax(model, extras):
    jt = jrace()
    t = convert.track(jt, device="cpu")
    jcfg, cfg = _cfgs(model)
    jllc = jll.LapLearnConfig(gain=0.7, dv_max=0.8, a_lat_frac=0.78)
    tb = _jax_tables_b(jll.initial_table(jt, ds=0.05, vx0=1.0))
    X, U, conv = _lap_trace(model, float(jt.length))
    obs = BLOCKS if extras else None
    pb = _jax_params_b()
    want = jax.jit(jax.vmap(lambda pp, tt, x, u, c: jll.learn_from_lap(
        pp, jcfg, jllc, jt, tt, x, u, wraps=2, obstacles=None if obs is None else jnp.asarray(obs),
        curv_k=5, converged=c if extras else None)))(pb, tb, jnp.asarray(X), jnp.asarray(U), jnp.asarray(conv))
    got = ll.learn_from_lap(convert.vehicle_params(pb, device="cpu"), cfg, convert.lap_learn_config(jllc), t,
                            convert.ref_table(tb, device="cpu"), torch.tensor(X), torch.tensor(U), wraps=2,
                            obstacles=obs, curv_k=5, converged=torch.tensor(conv) if extras else None)
    for name in ("vx", "ey", "delta"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **TABLE_TOL,
                                   err_msg=name)
    # the update moved every lane's profile, each at its own friction
    assert (got.vx - convert.ref_table(tb, device="cpu").vx).abs().amax(dim=1).min() > 0.05


def test_learn_from_lap_single_car_matches_jax():
    """The unbatched form (one shared table, X (T, nx)) at a float mu."""
    jt = joval(ds=0.05)
    t = convert.track(jt, device="cpu")
    jcfg, cfg = _cfgs("dynamic")
    one = jll.initial_table(jt, ds=0.05, vx0=1.0)
    X, U, conv = _lap_trace("dynamic", float(jt.length), T=150, seed=3)
    want = jax.jit(lambda x, u, c: jll.learn_from_lap(JVehicleParams(mu=0.7), jcfg, jll.LapLearnConfig(), jt, one,
                                                      x, u, wraps=2, curv_k=5, converged=c))(
        jnp.asarray(X[0]), jnp.asarray(U[0]), jnp.asarray(conv[0]))
    got = ll.learn_from_lap(VehicleParams(mu=0.7), cfg, ll.LapLearnConfig(), t, convert.ref_table(one, device="cpu"),
                            torch.tensor(X[0]), torch.tensor(U[0]), wraps=2, curv_k=5,
                            converged=torch.tensor(conv[0]))
    assert got.vx.shape == (one.vx.shape[0],)
    for name in ("vx", "ey", "delta"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **TABLE_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("wraps", [2, 3])
def test_accel_limit_closed_form_matches_jax_scan(wraps):
    """The cummin form of each circular sweep against JAX's scan, on
    random profiles at the racetrack's node count (n=635, ds ~0.05)."""
    rng = np.random.default_rng(wraps)
    one = jll.initial_table(jrace(), ds=0.05)
    n, ds = one.vx.shape[0], one.ds
    assert n == 635
    v = rng.uniform(0.5, 4.0, (4, n)).astype(np.float32)
    v[:, 100:110] = 4.0                 # a spike the filter must pull down
    want = jax.vmap(lambda a: jll._accel_limit_circular(a, ds, 3.0, 2.0, wraps=wraps))(jnp.asarray(v))
    got = ll._accel_limit_circular(torch.tensor(v), torch.tensor(float(ds)), 3.0, 2.0, wraps=wraps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=0)
    # the sweep count and the line stencil are JAX's
    for args in ((4.0, 2.0, 10.28), (4.0, 2.0, 31.73), (6.0, 0.5, 5.0)):
        assert ll._wraps_needed(*args) == jll._wraps_needed(*args)
    for step in (0.05, 0.02, 0.3):
        tbl = jll.initial_table(jrace(), ds=step)
        assert ll._curv_stencil(convert.ref_table(tbl, device="cpu")) == jll._curv_stencil(tbl)
    # the output is consistent: v^2 steps within the accel and brake limits
    v2 = got.double().numpy() ** 2
    dv2 = np.roll(v2, -1, axis=1) - v2
    assert (dv2 <= 2 * 3.0 * float(ds) + 1e-4).all() and (-dv2 <= 2 * 2.0 * float(ds) + 1e-4).all()


def test_lap_steps_matches_jax():
    jt = joval(ds=0.05)
    t = convert.track(jt, device="cpu")
    L = float(jt.length)
    T = 50
    s = np.stack([np.linspace(0.0, 2.0 * L, T), np.linspace(0.1, 0.9 * L, T), np.linspace(-0.3, L, T)])
    X = np.zeros((3, T, 4), np.float32)
    X[..., 2] = s
    jcfg, cfg = _cfgs("kinematic")
    s0 = np.array([-0.2, 0.0, -0.5], np.float32)
    for kw_j, kw_p in (({}, {}), (dict(s0=jnp.asarray(s0)), dict(s0=torch.tensor(s0)))):
        want = jax.vmap(lambda x, *a: jll.lap_steps(jcfg, jt, x, T, *a))(jnp.asarray(X), *kw_j.values())
        got = ll.lap_steps(cfg, t, torch.tensor(X), T, **kw_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ll.lap_steps(cfg, t, torch.tensor(X), T).tolist()
    assert 0 < got[0] < T and got[1] == T + 1      # the DNF sentinel: T + 1
    # the single-car form
    assert int(ll.lap_steps(cfg, t, torch.tensor(X[0]), T)) == int(jll.lap_steps(jcfg, jt, jnp.asarray(X[0]), T))


def test_memorize_obstacles_matches_jax():
    """The line projection on per-lane lines: blocks on both sides, one in
    a corner (the steerable-side rule), one across the seam, a padding row."""
    jt = joval(ds=0.05)
    t = convert.track(jt, device="cpu")
    jcfg, cfg = _cfgs("dynamic")
    one = jll.initial_table(jt, ds=0.05)
    L = float(jt.length)
    blocks = np.array([[1.0, 2.0, -0.3, 0.05], [0.5 * L, 0.5 * L + 1.0, -0.05, 0.3],
                       [L - 0.4, L + 0.4, -0.1, 0.1], [6.0, 5.0, 0.0, 0.0]], np.float32)
    ey = 0.1 * np.sin(np.arange(one.vx.shape[0])[None] / np.array([[4.0], [6.0], [9.0]])).astype(np.float32)
    jllc = jll.LapLearnConfig(obs_lead=1.2)
    ey_room = float(jt.width) / 2.0 - 0.05
    want = jax.jit(jax.vmap(lambda e: jll._memorize_obstacles(JVehicleParams(), jcfg, jllc, jt, one, e,
                                                              jnp.asarray(blocks), ey_room)))(jnp.asarray(ey))
    got = ll._memorize_obstacles(VehicleParams(), cfg, convert.lap_learn_config(jllc), t,
                                 convert.ref_table(one, device="cpu"), torch.tensor(ey), blocks, ey_room)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TABLE_TOL)
    assert np.abs(got.numpy() - ey).max() > 0.1       # the projection moved the lines


def test_batched_refs_from_tables_matches_jax():
    jt = joval(ds=0.05)
    jcfg, cfg = _cfgs("dynamic")
    tb = _jax_tables_b(jll.initial_table(jt, ds=0.05))
    rng = np.random.default_rng(5)
    s = (np.cumsum(rng.uniform(0.0, 0.06, (9, B)), axis=0) + rng.uniform(0.0, float(jt.length), B)).astype(np.float32)
    want = jax.jit(lambda t_, s_: jll.batched_refs_from_tables(jcfg, t_, s_))(tb, jnp.asarray(s))
    got = ll.batched_refs_from_tables(cfg, convert.ref_table(tb, device="cpu"), torch.tensor(s))
    assert got.shape == (9, 6, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TABLE_TOL)


def _rollout_case(N=8):
    jcfg = JMPCConfig(N=N, model="dynamic", tire="pacejka")
    jscfg = JSolverConfig(max_iter=15, rho_interval=0)
    x0 = np.zeros((B, 6), np.float32)
    x0[:, 0] = 1.2
    x0[:, 4] = [0.2, 3.0, 7.5]
    return jcfg, jscfg, x0


_JAX_ROLLOUTS = {}
_JAX_MEGA_LAP_ROLLOUT = jll.mega_lap_rollout     # the JAX function, before any test patches it


def _jax_rollout(jt, obstacles: bool):
    """JAX's compiled mega_lap_rollout for this file's case (T=12, the
    per-lane frictions MUS), built once per corridor setting: the JAX
    batched learner in ``test_batched_lap_learning_matches_jax[mega]``
    reuses it rather than compiling the interpreted kernel again."""
    if obstacles not in _JAX_ROLLOUTS:
        jcfg, jscfg, _ = _rollout_case()
        _JAX_ROLLOUTS[obstacles] = _JAX_MEGA_LAP_ROLLOUT(
            _jax_params_b(), jcfg, jscfg, jt, 12, sim_tire="pacejka", interpret=True,
            obstacles=jnp.asarray(ROLL_BLOCKS) if obstacles else None)
    return _JAX_ROLLOUTS[obstacles]


@pytest.mark.parametrize("obstacles", [pytest.param(False, marks=pytest.mark.slow), True],
                         ids=["tables", "tables-obstacles"])
def test_mega_lap_rollout_matches_jax(obstacles):
    jt = joval(ds=0.05)
    jcfg, jscfg, x0 = _rollout_case()
    tb = _jax_tables_b(jll.initial_table(jt, ds=0.05, vx0=1.0))
    obs = ROLL_BLOCKS if obstacles else None
    pb = _jax_params_b()
    jX, jU, jc = _jax_rollout(jt, obstacles)(jnp.asarray(x0), tb)
    run = ll.mega_lap_rollout(convert.vehicle_params(pb, device="cpu"), convert.mpc_config(jcfg),
                              convert.solver_config(jscfg), convert.track(jt, device="cpu"), 12,
                              sim_tire="pacejka", obstacles=obs)
    got = run(torch.tensor(x0), convert.ref_table(tb, device="cpu"))
    assert got.X.shape == (B, 12, 6) and got.U.shape == (B, 12, 2) and got.converged.shape == (B, 12)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(jU), **U_TOL)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(jX), **X_TOL)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(jc))


def _check_learn_log(got, want, n_laps, T):
    assert got.lap_steps.shape == (n_laps, B)
    np.testing.assert_array_equal(got.lap_steps.numpy(), np.asarray(want.lap_steps))
    assert got.tables_vx.shape == np.asarray(want.tables_vx).shape
    np.testing.assert_allclose(got.tables_vx.numpy(), np.asarray(want.tables_vx), **X_TOL)
    for name in ("vx", "ey", "delta"):
        np.testing.assert_allclose(getattr(got.table, name).numpy(), np.asarray(getattr(want.table, name)), **X_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got.last_log.U.numpy(), np.asarray(want.last_log.U), **U_TOL)
    np.testing.assert_allclose(got.last_log.X.numpy(), np.asarray(want.last_log.X), **X_TOL)
    assert got.last_log.X.shape == (B, T, 6)


@pytest.mark.parametrize("backend", ["plain", "mega"])
def test_batched_lap_learning_matches_jax(backend, monkeypatch):
    """Two laps of 12 steps from per-lane friction; the learned tables
    differ per lane after the first, so the second lap rolls per-lane
    tables. The mega case carries corridor blocks (the kernel's eyb on the
    rollout, the line memory in the learner)."""
    jt = joval(ds=0.05)
    jcfg, jscfg, x0 = _rollout_case(N=8 if backend == "mega" else 6)
    if backend == "mega":
        def cached(p_b, cfg, scfg, track, T_lap, sim_tire=None, interpret=False, obstacles=None, **kw):
            assert (T_lap, sim_tire, interpret, kw) == (12, "pacejka", True, {})
            assert (cfg, scfg) == _rollout_case()[:2] and np.array_equal(np.asarray(obstacles), ROLL_BLOCKS)
            assert np.array_equal(np.asarray(p_b.mu), MUS)
            return _jax_rollout(jt, True)

        monkeypatch.setattr(jll, "mega_lap_rollout", cached)
    one = jll.initial_table(jt, ds=0.05, vx0=1.0)
    jllc = jll.LapLearnConfig(gain=0.7, dv_max=0.8, a_lat_frac=0.78)
    obs = ROLL_BLOCKS if backend == "mega" else None
    pb = _jax_params_b()
    jkw = dict(backend="mega", mega_interpret=True) if backend == "mega" else dict(backend="xla")
    want = jll.batched_lap_learning(pb, jcfg, jscfg, jt, jnp.asarray(x0), 2, 12, llcfg=jllc, table0=one,
                                    sim_tire="pacejka", obstacles=None if obs is None else jnp.asarray(obs), **jkw)
    got = ll.batched_lap_learning(convert.vehicle_params(pb, device="cpu"), convert.mpc_config(jcfg),
                                  convert.solver_config(jscfg), convert.track(jt, device="cpu"),
                                  torch.tensor(x0), 2, 12, llcfg=convert.lap_learn_config(jllc),
                                  table0=convert.ref_table(one, device="cpu"), sim_tire="pacejka", obstacles=obs,
                                  backend=backend)
    _check_learn_log(got, want, 2, 12)
    assert (got.tables_vx[1] - got.tables_vx[0]).abs().max() > 0.05
    with pytest.raises(ValueError, match="backend"):
        ll.batched_lap_learning(VehicleParams(), convert.mpc_config(jcfg), convert.solver_config(jscfg),
                                convert.track(jt, device="cpu"), torch.tensor(x0), 1, 2, backend="xla")


@pytest.mark.slow
def test_iterative_lap_learning_matches_jax():
    jt = joval(ds=0.05)
    jcfg = JMPCConfig(N=8)
    jscfg = JSolverConfig(max_iter=30)
    one = jll.initial_table(jt, ds=0.05, vx0=1.0)
    x0 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    want = jll.iterative_lap_learning(JVehicleParams(), jcfg, jscfg, jt, jnp.asarray(x0), 2, 12, table0=one)
    got = ll.iterative_lap_learning(VehicleParams(), convert.mpc_config(jcfg), convert.solver_config(jscfg),
                                    convert.track(jt, device="cpu"), torch.tensor(x0), 2, 12,
                                    table0=convert.ref_table(one, device="cpu"))
    np.testing.assert_array_equal(got.lap_steps.numpy(), np.asarray(want.lap_steps))
    np.testing.assert_allclose(got.tables_vx.numpy(), np.asarray(want.tables_vx), **X_TOL)
    np.testing.assert_allclose(got.last_log.U.numpy(), np.asarray(want.last_log.U), **U_TOL)
    np.testing.assert_allclose(got.last_log.X.numpy(), np.asarray(want.last_log.X), **X_TOL)


def test_iterative_lap_learning_is_the_batched_learner_on_one_lane():
    """The fast counterpart of the slow JAX comparison above: the one-car
    loop equals ``batched_lap_learning`` (held against JAX above) on a
    single lane, lap for lap."""
    t = convert.track(joval(ds=0.05), device="cpu")
    cfg = convert.mpc_config(JMPCConfig(N=8))
    scfg = convert.solver_config(JSolverConfig(max_iter=30))
    one = ll.initial_table(t, ds=0.05, vx0=1.0)
    x0 = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    got = ll.iterative_lap_learning(VehicleParams(), cfg, scfg, t, x0, 2, 12, table0=one)
    ref = ll.batched_lap_learning(VehicleParams(), cfg, scfg, t, x0[None], 2, 12, table0=one)
    np.testing.assert_array_equal(got.lap_steps.numpy(), ref.lap_steps[:, 0].numpy())
    np.testing.assert_allclose(got.tables_vx.numpy(), ref.tables_vx[:, 0].numpy(), **TABLE_TOL)
    np.testing.assert_allclose(got.last_log.X.numpy(), ref.last_log.X[0].numpy(), **TABLE_TOL)
    assert got.table.vx.shape == one.vx.shape
    assert (got.tables_vx[-1] - got.tables_vx[0]).abs().max() > 0.05

"""Lap learning in the composed race programs vs the JAX package's on the
CPU, with clean measurements (``noise_sigma=None``: the two packages'
noise streams differ) and inputs made from numpy seeds.

- ``mega_race_learn``: B=3 cars on the oval, plant mu (0.5, 0.8, 1.1),
  seed 0.85, N=6 Pacejka, 2 windows of 12 steps on the racestep (its plain
  version) against JAX's (Pallas in interpret mode), with a corridor block.
  Bounds: the racestep's (tests/test_torch_racestep.py): mu-hat 1e-4,
  filtered states and the tables learned from them 5e-4; the same lap
  steps, progress 5e-4, the converged shares 1e-6.
- ``race_loop``'s learning mode, ``backend="plain"`` against JAX "xla":
  the oval, plant mu 0.6 against a seed of 1.0, N=6 Pacejka, 40 ADMM
  iterations, T=30 in
  segments of 10 steps, the table refined every 2 segments from the
  ``table0`` seed (no plan), with a parked block ahead that the update
  memorizes into the line and the tracker's preview does not reach within
  the run. Bounds: those of tests/test_torch_race_loop.py, 5e-3 (the two
  sides agree to ~2e-6). A block inside the preview at 60 iterations parts
  the two at an unconverged solve (r_prim ~2e-2 after 60 iterations, then
  one side's limp-home), as that test found for the racestep.
- ``obs_tracker_lead``: the first plan's line is the plan's own line
  projected by ``_memorize_obstacles`` (held against JAX in
  tests/test_torch_lap_learning.py), exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPPConfig as JMPPConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import LapLearnConfig as JLapLearnConfig
from autonomous_racing_lpv_mpp_mpc_tpu.loop import initial_table as jinitial_table
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mega_race_learn as jmega_race_learn
from autonomous_racing_lpv_mpp_mpc_tpu.loop import race_loop as jrace_loop
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import LapLearnConfig, mega_race_learn, race_loop
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.lap_learning import _memorize_obstacles
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import pad_blocks, plan_mpp

TIGHT = dict(atol=5e-4, rtol=0)
BLOCK = np.array([[2.0, 2.8, -0.1, 0.12]], np.float32)


def test_mega_race_learn_matches_jax():
    jt = joval(ds=0.05)
    jcfg = JMPCConfig(N=6, model="dynamic", tire="pacejka")
    jscfg = JSolverConfig(max_iter=40, rho_interval=0, early_exit=True, check_termination=2)
    mus = np.array([0.5, 0.8, 1.1], np.float32)
    x0 = np.zeros((3, 6), np.float32)
    x0[:, 0] = 1.0
    x0[:, 4] = [0.6, 4.0, 9.0]
    one = jinitial_table(jt, ds=0.05, vx0=1.2)
    jllc = JLapLearnConfig(gain=0.5, dv_max=0.5)
    want = jmega_race_learn(JVehicleParams(), jcfg, jscfg, jt, jnp.asarray(x0), n_windows=2, T_window=12,
                            mu_true_b=jnp.asarray(mus), mu0=0.85, noise_sigma=None, llcfg=jllc, table0=one,
                            obstacles=jnp.asarray(BLOCK), interpret=True)
    got = mega_race_learn(VehicleParams(), convert.mpc_config(jcfg), convert.solver_config(jscfg),
                          convert.track(jt, device="cpu"), torch.tensor(x0), n_windows=2, T_window=12,
                          mu_true_b=torch.tensor(mus), mu0=0.85, noise_sigma=None,
                          llcfg=convert.lap_learn_config(jllc), table0=convert.ref_table(one, device="cpu"),
                          obstacles=BLOCK)
    assert got.tables_vx.shape == np.asarray(want.tables_vx).shape == (3, 3, one.vx.shape[0])
    np.testing.assert_allclose(got.mu_hat.numpy(), np.asarray(want.mu_hat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.Xf_last.numpy(), np.asarray(want.Xf_last), **TIGHT)
    np.testing.assert_allclose(got.tables_vx.numpy(), np.asarray(want.tables_vx), **TIGHT)
    for name in ("vx", "ey", "delta"):
        np.testing.assert_allclose(getattr(got.table, name).numpy(), np.asarray(getattr(want.table, name)), **TIGHT,
                                   err_msg=name)
    np.testing.assert_array_equal(got.lap_steps.numpy(), np.asarray(want.lap_steps))
    np.testing.assert_allclose(got.progress.numpy(), np.asarray(want.progress), **TIGHT)
    np.testing.assert_allclose(got.converged.numpy(), np.asarray(want.converged), atol=1e-6, rtol=0)
    # each lane learned from its own window, at its own mu-hat
    assert (got.tables_vx[2] - got.tables_vx[0]).abs().amax(dim=1).min() > 0.05
    assert (got.progress > 0.3).all()


def test_race_loop_learning_mode_matches_jax():
    jt = joval(ds=0.05)
    jcfg = JMPCConfig(N=6, model="dynamic", tire="pacejka")
    jscfg = JSolverConfig(max_iter=40)
    pcfg = JMPPConfig.for_model("dynamic", H=64, n_sqp=2)
    one = jinitial_table(jt, ds=0.05, vx0=1.0)
    jllc = JLapLearnConfig(gain=0.7, dv_max=0.8)
    x0 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    ahead = np.array([[2.4, 3.2, -0.1, 0.12]], np.float32)
    kw = dict(T=30, mu_true=0.6, mu0=1.0, replan_every=10, noise_sigma=None, ilc_every=2,
              obstacles_fn=lambda t: ahead, max_obstacle_rows=4)
    want = jrace_loop(JVehicleParams(), jcfg, jscfg, pcfg, jt, jnp.asarray(x0), ilc_cfg=jllc, table0=one,
                      backend="xla", **kw)
    got = race_loop(VehicleParams(), convert.mpc_config(jcfg), convert.solver_config(jscfg),
                    convert.mpp_config(pcfg), convert.track(jt, device="cpu"), torch.tensor(x0),
                    ilc_cfg=convert.lap_learn_config(jllc), table0=convert.ref_table(one, device="cpu"),
                    backend="plain", **kw)
    res = convert.race_log_to_numpy(got)
    assert res["replan_steps"].tolist() == np.asarray(want.replan_steps).tolist() == [0, 20]
    assert res["tables_vx"].shape == np.asarray(want.tables_vx).shape == (2, one.vx.shape[0])
    for name in ("tables_vx", "tables_ey", "Xg", "Xf", "U", "mu_hat"):
        assert res[name].shape == np.asarray(getattr(want, name)).shape, name
        np.testing.assert_allclose(res[name], np.asarray(getattr(want, name)), atol=5e-3, rtol=0, err_msg=name)
    np.testing.assert_array_equal(res["lap_steps"], np.asarray(want.lap_steps))
    # the update refined the seed where the car drove and moved the line
    # clear of the block ahead
    assert np.abs(res["tables_vx"][1] - res["tables_vx"][0]).max() > 0.1
    assert np.abs(res["tables_ey"][1]).max() > 0.1


def test_race_loop_obs_tracker_lead_projects_the_plan(monkeypatch):
    """One plan (T = replan_every) on the oval with a block ahead: the
    table the car follows is the plan's line projected clear of the block
    over the lead-in."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import race as race_mod

    plans = []

    def recording_plan(*a, **k):
        plans.append((a, k, plan_mpp(*a, **k)[0]))
        return plans[-1][2], None

    monkeypatch.setattr(race_mod, "plan_mpp", recording_plan)
    jt = joval(ds=0.05)
    track = convert.track(jt, device="cpu")
    cfg = convert.mpc_config(JMPCConfig(N=10, model="dynamic", tire="pacejka"))
    pcfg = convert.mpp_config(JMPPConfig.for_model("dynamic", H=32, n_sqp=1))
    p = VehicleParams()
    x0 = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    got = race_loop(p, cfg, convert.solver_config(JSolverConfig(max_iter=60)), pcfg, track, x0, T=10,
                    mu_true=0.6, mu0=1.0, replan_every=10, obstacles_fn=lambda t: BLOCK, max_obstacle_rows=4,
                    obs_tracker_lead=0.8)
    blocks = torch.as_tensor(pad_blocks(BLOCK, 4))
    (a, k, plan), = plans
    assert a[0].mu == 1.0 and torch.equal(k["obstacles"], blocks) and torch.equal(k["x0_state"], x0)
    ey = _memorize_obstacles(p.replace(mu=1.0), cfg, LapLearnConfig(obs_lead=0.8), track, plan, plan.ey, blocks,
                             float(track.width) / 2.0 - 0.05)
    np.testing.assert_array_equal(got.tables_vx[0].numpy(), plan.vx.numpy())
    np.testing.assert_array_equal(got.tables_ey[0].numpy(), ey.numpy())
    assert (ey - plan.ey).abs().max() > 0.01       # the projection moved the line
    with pytest.raises(ValueError, match="backend"):
        race_loop(p, cfg, convert.solver_config(JSolverConfig()), pcfg, track, x0, T=10, mu_true=0.6,
                  backend="xla")

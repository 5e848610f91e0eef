"""The port's planner vs the JAX package on the CPU: the velocity profile,
``plan_mpp`` and ``replanning_loop`` (``race_loop`` is in
``tests/test_torch_race_loop.py``).

Inputs are the same configs and tracks on both sides (``convert``).
Tolerances:

- the velocity profile within 1e-5: the same float32 recurrence, run on
  the host;
- ``plan_mpp`` at H=64, n_sqp=2 on the oval, with and without an obstacle
  block: the table's vx / ey / delta within 5e-3 (the JAX package's
  scan-vs-assoc bound, tests/test_solver.py:89-90: the port's associative
  scan has another tree and its affine sweep another association, so the
  400-iteration solve rounds differently), the same per-pass convergence,
  progress within 1e-3 relative;
- ``replanning_loop`` (T=120, replanning every 60 steps at H=64, a block
  appearing at step 60): the same replan steps, X and U within 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPPConfig as JMPPConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.planner import plan_mpp as jplan_mpp
from autonomous_racing_lpv_mpp_mpc_tpu.planner import replanning_loop as jreplanning_loop
from autonomous_racing_lpv_mpp_mpc_tpu.planner import velocity_profile as jvelocity_profile
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import plan_mpp, replanning_loop, velocity_profile

P = JVehicleParams()
PCFG = JMPPConfig.for_model("dynamic", H=64, n_sqp=2)
BLOCK = np.array([[4.0, 5.0, -0.4, 0.1]], np.float32)
PLAN_TOL = dict(atol=5e-3, rtol=0)
LOOP_TOL = dict(atol=5e-3, rtol=0)
T_LOOP = 120
X0 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)


def _cpu(jtrack):
    return convert.track(jtrack, device="cpu")


@pytest.mark.parametrize("mu", [1.0, 0.5])
def test_velocity_profile_matches_jax(mu):
    jt = jrace()
    pcfg = JMPPConfig()
    want = np.asarray(jvelocity_profile(P.replace(mu=jnp.float32(mu)), jt, pcfg.bounds, pcfg.a_lat_frac))
    got = velocity_profile(VehicleParams(mu=mu), _cpu(jt), convert.mpp_config(pcfg).bounds, pcfg.a_lat_frac)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def oval_plans():
    """(obstacles?) -> (JAX table, JAX diag, port table, port diag)."""
    jt = joval()
    out = {}
    for blocked in (False, True):
        obs = BLOCK if blocked else None
        jtab, jd = jplan_mpp(P, PCFG, jt, obstacles=None if obs is None else jnp.asarray(obs))
        tab, d = plan_mpp(VehicleParams(), convert.mpp_config(PCFG), _cpu(jt), obstacles=obs)
        out[blocked] = (jtab, jd, tab, d)
    return out


@pytest.mark.parametrize("blocked", [False, True])
def test_plan_mpp_matches_jax(oval_plans, blocked):
    jtab, jd, tab, d = oval_plans[blocked]
    for name in ("vx", "ey", "delta"):
        np.testing.assert_allclose(getattr(tab, name).numpy(), np.asarray(getattr(jtab, name)),
                                   **PLAN_TOL, err_msg=name)
    np.testing.assert_allclose(float(tab.ds), float(jtab.ds), rtol=1e-7)
    assert d.converged.tolist() == np.asarray(jd.converged).tolist()
    np.testing.assert_allclose(float(d.progress), float(jd.progress), rtol=1e-3)
    np.testing.assert_allclose(float(d.lap_time), float(jd.lap_time), rtol=1e-3)


def test_plan_mpp_obstacle_shifts_the_line(oval_plans):
    """The block on the lower side of the straight (e_y -0.4..0.1) moves the
    planned line above it, clear of the block by the planner's margin."""
    blocked, free = oval_plans[True][2], oval_plans[False][2]
    s = torch.arange(blocked.ey.shape[0]) * blocked.ds
    inside = (s >= 4.2) & (s <= 4.8)
    assert float(blocked.ey[inside].min()) > 0.1 + 0.05 - 1e-3
    assert float(blocked.ey[inside].min()) > float(free.ey[inside].min())


@pytest.fixture(scope="module")
def replans():
    jt = joval()
    jcfg = JMPCConfig(N=10, model="dynamic")
    jscfg = JSolverConfig(max_iter=60, rho_interval=20)

    def obstacles_fn(t):
        return BLOCK if t >= 60 else None

    jres = jreplanning_loop(P, jcfg, jscfg, PCFG, jt, jnp.asarray(X0), T=T_LOOP, replan_every=60,
                            obstacles_fn=lambda t: None if obstacles_fn(t) is None else jnp.asarray(obstacles_fn(t)))
    res = replanning_loop(VehicleParams(), convert.mpc_config(jcfg), convert.solver_config(jscfg),
                          convert.mpp_config(PCFG), _cpu(jt), torch.tensor(X0), T=T_LOOP, replan_every=60,
                          obstacles_fn=obstacles_fn)
    return jres, res


def test_replanning_loop_matches_jax(replans):
    jres, res = replans
    got = convert.replan_log_to_numpy(res)
    assert got["replan_steps"].tolist() == np.asarray(jres.replan_steps).tolist() == [0, 60]
    np.testing.assert_allclose(got["plan_progress"], np.asarray(jres.plan_progress), rtol=1e-3)
    for name in ("X", "U"):
        assert got[name].shape == np.asarray(getattr(jres.log, name)).shape
        np.testing.assert_allclose(got[name], np.asarray(getattr(jres.log, name)), **LOOP_TOL, err_msg=name)
    np.testing.assert_array_equal(got["converged"], np.asarray(jres.log.converged))
    assert not got["certified_infeasible"].any()

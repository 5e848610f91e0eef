"""The port's flagship race program, ``race_loop`` in replanning mode, vs
the JAX package's on the CPU: the oval, the dynamic bicycle at N=10 with
Pacejka tyres, plant friction 0.6 against a controller seed of 1.0,
T=120 steps, the planner (H=64, n_sqp=2) replanning every 60 steps from the
EKF's state at the live mu-hat, clean measurements (``noise_sigma=None``:
the two packages' noise streams differ).

- ``backend="plain"`` (the module composition, ``mpc_step`` per step)
  against the JAX ``backend="xla"`` at the JAX race test's solver,
  ``SolverConfig(max_iter=60)``.
- ``backend="mega"`` (the racestep; its plain version on CPU tensors)
  against the JAX ``backend="mega"`` (the Pallas racestep in interpret
  mode). The JAX package's two backends are two forms of the step (the
  kernel form's forward-difference EKF Jacobian and e_psi node table, the
  composition's exact Jacobian and slope probes) and part far beyond 5e-3
  on this input. At max_iter=60 about one step in eight ends unconverged,
  and an unconverged solve's output moves with the rounding of its inputs
  (the port's and JAX's racesteps agree closely for the first 45 steps,
  then part); so this comparison runs at max_iter=200, where the solves
  converge as far as they can, with the kernel form's early exit (checked
  every 2 iterations) so that converged steps stop there.

Bounds: the same replan steps and lap steps; Xg, Xf, Z, U and mu-hat
within 5e-3; the planned tables within the planner's 5e-3
(tests/test_torch_planner.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPPConfig as JMPPConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import race_loop as jrace_loop
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import race_loop

P = JVehicleParams()
PCFG = JMPPConfig.for_model("dynamic", H=64, n_sqp=2)
RCFG = JMPCConfig(N=10, model="dynamic", tire="pacejka")
SOLVERS = {"plain": JSolverConfig(max_iter=60),
           "mega": JSolverConfig(max_iter=200, early_exit=True, check_termination=2)}
JAX_BACKEND = {"plain": dict(backend="xla"), "mega": dict(backend="mega", interpret=True)}
TOL = dict(atol=5e-3, rtol=0)
T_LOOP = 120
X0 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)


def _args(jt, backend):
    return (VehicleParams(), convert.mpc_config(RCFG), convert.solver_config(SOLVERS[backend]),
            convert.mpp_config(PCFG), convert.track(jt, device="cpu"), torch.tensor(X0))


@pytest.mark.parametrize("backend", ["plain", "mega"])
def test_race_loop_matches_jax(backend):
    jt = joval()
    jlog = jrace_loop(P, RCFG, SOLVERS[backend], PCFG, jt, jnp.asarray(X0), T=T_LOOP, mu_true=0.6,
                      mu0=1.0, replan_every=60, noise_sigma=None, **JAX_BACKEND[backend])
    log = race_loop(*_args(jt, backend), T=T_LOOP, mu_true=0.6, mu0=1.0, replan_every=60,
                    noise_sigma=None, backend=backend)
    got = convert.race_log_to_numpy(log)
    assert got["replan_steps"].tolist() == np.asarray(jlog.replan_steps).tolist() == [0, 60]
    assert got["tables_vx"].shape == np.asarray(jlog.tables_vx).shape
    assert got["tables_ey"].shape[0] == got["replan_steps"].shape[0]
    for name in ("tables_vx", "tables_ey"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jlog, name)), **TOL, err_msg=name)
    for name in ("Xg", "Xf", "Z", "U", "mu_hat"):
        assert got[name].shape == np.asarray(getattr(jlog, name)).shape, name
        np.testing.assert_allclose(got[name], np.asarray(getattr(jlog, name)), **TOL, err_msg=name)
    np.testing.assert_array_equal(got["lap_steps"], np.asarray(jlog.lap_steps))
    # mu-hat moved from the seed toward the plant's 0.6
    assert got["mu_hat"][-1] < 0.9


def test_race_loop_unported_modes_raise():
    args = _args(joval(), "plain")
    with pytest.raises(NotImplementedError, match="ilc_every"):
        race_loop(*args, T=10, mu_true=0.6, ilc_every=2)
    with pytest.raises(NotImplementedError, match="obs_tracker_lead"):
        race_loop(*args, T=10, mu_true=0.6, obs_tracker_lead=0.5)
    with pytest.raises(ValueError, match="backend"):
        race_loop(*args, T=10, mu_true=0.6, backend="xla")

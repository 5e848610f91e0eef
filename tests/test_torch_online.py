"""The port's pipelined replanning loop against the JAX package on the CPU.

Inputs are tests/test_torch_planner.py's: the oval, ``MPCConfig(N=10)``,
``SolverConfig(max_iter=60, rho_interval=20)``,
``MPPConfig.for_model("dynamic", H=64, n_sqp=2)``, T=120, replanning every
60 steps, the block [4, 5, -0.4, 0.1] from step 60. JAX runs its loop on
its fake CPU devices with the planner on ``jax.devices()[1]``; the port's
loop on CPU tensors makes each plan on the caller's thread before the
segment it follows.

Tolerances: the same replan steps, planned progress within 1e-3 relative,
X and U within 5e-3 (the serial loop's bound, tests/test_torch_planner.py:
the associative Riccati rounds differently from XLA's scans), converged
equal; ``_boundary_predictor`` within 1e-5 for both models (the same
float32 recurrence).
"""

import collections
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPPConfig as JMPPConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.planner import RefTable as JRefTable
from autonomous_racing_lpv_mpp_mpc_tpu.planner import pipelined_replanning_loop as jpipelined
from autonomous_racing_lpv_mpp_mpc_tpu.planner.online import _boundary_predictor as jpredictor
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, MPPConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import online, pipelined_replanning_loop

PCFG = JMPPConfig.for_model("dynamic", H=64, n_sqp=2)
JCFG = JMPCConfig(N=10, model="dynamic")
JSCFG = JSolverConfig(max_iter=60, rho_interval=20)
BLOCK = np.array([[4.0, 5.0, -0.4, 0.1]], np.float32)
X0 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
T_LOOP, EVERY = 120, 60
LOOP_TOL = dict(atol=5e-3, rtol=0)
# the host reads the budget test counts: torch.Tensor's conversions
SYNC_METHODS = ("__float__", "__bool__", "__int__", "__index__", "item", "tolist", "numpy", "__array__")


def _obstacles(t):
    return BLOCK if t >= EVERY else None


def _run_port(**kw):
    return pipelined_replanning_loop(
        VehicleParams(), convert.mpc_config(JCFG), convert.solver_config(JSCFG), convert.mpp_config(PCFG),
        convert.track(joval(), device="cpu"), torch.tensor(X0), T=T_LOOP, replan_every=EVERY,
        obstacles_fn=_obstacles, **kw)


@pytest.fixture(scope="module")
def pipelined():
    """(JAX ReplanLog, port ReplanLog, host reads on the caller's thread
    during the port's call by (method, file:line of the caller))."""
    jres = jpipelined(JVehicleParams(), JCFG, JSCFG, PCFG, joval(), jnp.asarray(X0), T=T_LOOP,
                      replan_every=EVERY, obstacles_fn=lambda t: None if t < EVERY else jnp.asarray(BLOCK),
                      planner_device=jax.devices()[1])
    caller = threading.get_ident()
    reads = collections.Counter()
    orig = {name: getattr(torch.Tensor, name) for name in SYNC_METHODS}

    def counting(name):
        def f(self, *a, **k):
            if threading.get_ident() == caller:
                frame = sys._getframe(1)
                reads[name, f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"] += 1
            return orig[name](self, *a, **k)
        return f

    for name in SYNC_METHODS:
        setattr(torch.Tensor, name, counting(name))
    try:
        res = _run_port()
    finally:
        for name, fn in orig.items():
            setattr(torch.Tensor, name, fn)
    return jres, res, reads


def test_pipelined_replanning_matches_jax(pipelined):
    jres, res, _ = pipelined
    got = convert.replan_log_to_numpy(res)
    assert got["replan_steps"].tolist() == np.asarray(jres.replan_steps).tolist() == [0, EVERY]
    np.testing.assert_allclose(got["plan_progress"], np.asarray(jres.plan_progress), rtol=1e-3)
    for name in ("X", "U"):
        assert got[name].shape == np.asarray(getattr(jres.log, name)).shape
        np.testing.assert_allclose(got[name], np.asarray(getattr(jres.log, name)), **LOOP_TOL, err_msg=name)
    np.testing.assert_array_equal(got["converged"], np.asarray(jres.log.converged))


def test_pipelined_loop_host_sync_budget(pipelined):
    """The overlap lasts only while the caller's thread reads nothing back
    from the device inside the loop. On CPU tensors the caller's thread
    makes every plan; on the card it makes only the first, and the later
    plans' reads happen on the worker thread, on the planner's stream.
    Pinned reads on the caller's thread here:

    - each plan (5, and 1 more for the first): the velocity profile's
      ``.cpu().numpy()`` (``velocity_profile.py``), ``float(track.width)``
      in each of the two SQP passes' bounds and ``float(track.length)``
      twice (``mpp.py``); ``track.ds_host``'s one ``float(ds)`` per track
      (``track.py``), cached after the first plan;
    - the tracker (1 per step): on this plain route, the certificate's
      any-flag of ``loop/mpc.py`` (the fused route the card runs reads
      nothing per step);
    - after the loop (1 per plan): each planned span's ``float``
      (``online.py``)."""
    _, res, reads = pipelined
    n_plans = len(res.replan_steps)
    per_file = collections.Counter()
    for (_name, where), n in reads.items():
        per_file[where.split(":")[0]] += n
    assert per_file == {"velocity_profile.py": n_plans, "track.py": 1, "mpp.py": 4 * n_plans, "mpc.py": T_LOOP,
                        "online.py": n_plans}, dict(reads)
    assert sum(reads.values()) <= 1 + 5 * n_plans + T_LOOP + n_plans


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_boundary_predictor_matches_jax(model):
    rng = np.random.default_rng(3)
    n = 257
    jt = JRefTable(ds=jnp.float32(10.28 / n), length=jnp.float32(10.28),
                   vx=jnp.asarray(rng.uniform(0.8, 2.2, n), jnp.float32),
                   ey=jnp.asarray(rng.uniform(-0.3, 0.3, n), jnp.float32),
                   delta=jnp.asarray(rng.uniform(-0.2, 0.2, n), jnp.float32))
    nx = 6 if model == "dynamic" else 4
    x = rng.normal(size=nx).astype(np.float32)
    x[4 if model == "dynamic" else 2] = 9.7          # near the end of the lap: the lookup wraps
    jcfg = JMPCConfig(N=10, model=model)
    want = np.asarray(jpredictor(jcfg, EVERY)(jt, jnp.asarray(x)))
    got = online._boundary_predictor(convert.mpc_config(jcfg), EVERY)(convert.ref_table(jt, device="cpu"),
                                                                        torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == (nx,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_planner_exception_reraises(monkeypatch):
    """An error inside the planner's work (here its boundary predictor, which
    only the plans made inside the loop run) re-raises from the loop."""
    def failing(cfg, steps):
        def predict(table, x):
            raise FloatingPointError("planner failed")
        return predict

    monkeypatch.setattr(online, "_boundary_predictor", failing)
    with pytest.raises(FloatingPointError, match="planner failed"):
        pipelined_replanning_loop(VehicleParams(), MPCConfig(N=10), SolverConfig(max_iter=10),
                                  MPPConfig.for_model("dynamic", H=16, n_sqp=1),
                                  convert.track(joval(), device="cpu"), torch.tensor(X0), T=4, replan_every=2)


@pytest.mark.slow
def test_fused_tracker_at_60_iterations_follows_the_rho_schedule():
    """Why the card's pipelined phase gives its fused tracker more than the
    JAX test's 60 iterations: tests/test_planner.py:147-185's serial
    scenario (oval, N=16, H=192, T=240, the block from step 60) at 60
    iterations. With rho adapted every 20 iterations (that test's setting)
    JAX's loop and the port's plain route both pass the test's 0.85
    converged share. The fused kernel adapts rho once per solve; JAX's
    loop on that schedule (``rho_interval=0``) converges on the same share
    as the port's fused route (here the kernel's plain version), below
    0.85: the schedule, not the port, sets the share."""
    from autonomous_racing_lpv_mpp_mpc_tpu.planner import replanning_loop as jreplanning_loop
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import replanning_loop

    jcfg, jpcfg = JMPCConfig(N=16, model="dynamic"), JMPPConfig(H=192, n_sqp=2)
    shares = {}
    for rho_interval in (20, 0):
        res = jreplanning_loop(JVehicleParams(), jcfg, JSolverConfig(max_iter=60, rho_interval=rho_interval), jpcfg,
                               joval(), jnp.asarray(X0), T=240, replan_every=EVERY,
                               obstacles_fn=lambda t: jnp.asarray(BLOCK) if t >= EVERY else None)
        shares["jax", rho_interval] = float(np.mean(np.asarray(res.log.converged)))
    for backend, rho_interval in (("plain", 20), ("fused", 0)):
        res = replanning_loop(VehicleParams(), convert.mpc_config(jcfg),
                              SolverConfig(max_iter=60, rho_interval=rho_interval, backend=backend),
                              convert.mpp_config(jpcfg), convert.track(joval(), device="cpu"), torch.tensor(X0),
                              T=240, replan_every=EVERY, obstacles_fn=_obstacles)
        shares[backend, rho_interval] = res.log.converged.float().mean().item()
    print(shares)
    assert shares["jax", 20] > 0.85 and shares["plain", 20] > 0.85, shares
    assert abs(shares["fused", 0] - shares["jax", 0]) <= 0.02, shares

"""Batched ADMM and the solver-only kernel's plain version vs the JAX
package (CPU).

The port's ``admm_solve`` is held against JAX ``admm_solve``; the kernel
wrapper ``admm_kernel_solve`` — which takes its plain version for CPU
tensors — against JAX ``pallas_admm_solve`` in interpret mode under
``jax.jit``. Tolerances are those of the JAX package's own kernel test
(tests/test_ops.py): U and X 2e-4, r_prim 1e-4, done-at within one
iteration, and the adapted rho 5% relative on lanes whose dual residual is
above 1e-6. rho scales with the sqrt of r_prim/r_dual, and below that the
dual residual is float noise: the JAX package's own Pallas and XLA paths
then differ by 20% in rho.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_prepare as jmpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu.ops import pallas_admm_solve
from autonomous_racing_lpv_mpp_mpc_tpu.parallel import make_scenario_grid as jgrid
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve as jadmm_solve
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import admm_kernel_solve
from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import admm_solve

from tests.test_solver import random_qp

TOL_UX = dict(atol=2e-4, rtol=0)
TOL_R = dict(atol=1e-4, rtol=0)


def _random_batch(seeds, tight):
    qps = [random_qp(s, tight=tight) for s in seeds]
    return jax.tree.map(lambda *ls: jnp.stack(ls), *qps)


def _tracker_batch(N=12, model="dynamic"):
    """Batched tracker QPs (the kernel's shapes: na=8, nu=2, nc=6 for the
    dynamic bicycle on the racetrack; na=6 for the kinematic one on the
    oval) with their shifted warm start, at a perturbed first step."""
    kin = model == "kinematic"
    jp = JVehicleParams()
    jcfg = JMPCConfig(N=N, model=model, weights=JMPCWeights.for_model(model))
    jt = joval() if kin else jrace()
    scen = jgrid(jp, jcfg, n_ey=3, n_mu=2, vx0=0.5 if kin else 1.5)
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, jcfg, jt, x))(scen.params, scen.x0)
    rng = np.random.default_rng(7)
    x = np.asarray(scen.x0) + rng.normal(0, 0.05, scen.x0.shape).astype(np.float32)
    vref = 1.5 if kin else 1.8
    qp, warm, _ = jax.vmap(
        lambda pp, xx, c: jmpc_prepare(pp, jcfg, jt, xx, jconstant_refs(jcfg, vref), c)
    )(scen.params, x, carry)
    lam = np.asarray(rng.normal(0, 0.5, np.shape(warm[1])), np.float32)
    return qp, (warm[0], jnp.asarray(lam), warm[2], warm[3]), jnp.full((scen.batch,), 0.3)


def _compare(sol, ref, iters_slack=1):
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), **TOL_UX)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(ref.X), **TOL_UX)
    np.testing.assert_allclose(sol.r_prim.numpy(), np.asarray(ref.r_prim), **TOL_R)
    live = np.asarray(ref.r_dual) > 1e-6
    np.testing.assert_allclose(sol.rho.numpy()[live], np.asarray(ref.rho)[live], rtol=0.05)
    assert np.abs(sol.iters.numpy() - np.asarray(ref.iters)).max() <= iters_slack


@pytest.mark.parametrize("tight,rho_interval", [(True, 0), (False, 0), (True, 10)])
def test_admm_solve_matches_jax(tight, rho_interval):
    qp_b = _random_batch(range(4), tight)
    cfg = JSolverConfig(max_iter=60, rho_interval=rho_interval)
    ref = jax.jit(jax.vmap(lambda q: jadmm_solve(q, cfg)))(qp_b)
    sol = admm_solve(convert.boxqp(qp_b, device="cpu"), convert.solver_config(cfg))
    _compare(sol, ref)
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(ref.converged))


def test_admm_solve_warm_start_matches_jax():
    qp_b, warm, rho0 = _tracker_batch()
    cfg = JSolverConfig(max_iter=20, rho_interval=0)
    ref = jax.jit(jax.vmap(lambda q, w, r: jadmm_solve(q, cfg, warm=w, rho0=r)))(qp_b, warm, rho0)
    sol = admm_solve(convert.boxqp(qp_b, device="cpu"), convert.solver_config(cfg),
                     warm=tuple(convert.tensor(w, device="cpu") for w in warm), rho0=convert.tensor(rho0, device="cpu"))
    _compare(sol, ref)


@pytest.mark.parametrize("case", ["random-cold", "random-warm", "tracker-warm", "kinematic-cold",
                                  "kinematic-warm"])
def test_admm_kernel_plain_matches_pallas(case):
    """B = 5 or 6 (not a multiple of 128): the kernel's plain version vs
    the Pallas kernel, which pads the batch to 128 lanes; the tracker QPs of
    both models (na = 8 and na = 6, the widths the CUDA kernel takes)."""
    if case.startswith("random"):
        qp_b = _random_batch(range(5), tight=True)
        cfg = JSolverConfig(max_iter=60, rho_interval=0)
        warm, rho0 = None, None
        if case == "random-warm":
            cold = jax.jit(lambda q: pallas_admm_solve(q, cfg, interpret=True))(qp_b)
            warm, rho0 = (cold.s, cold.lam, cold.X, cold.U), cold.rho
    elif case == "tracker-warm":
        qp_b, warm, rho0 = _tracker_batch()
        cfg = JSolverConfig(max_iter=20, rho_interval=0)
    else:
        qp_b, warm, rho0 = _tracker_batch(N=10, model="kinematic")
        assert qp_b.Dx.shape[-1] == 6
        cfg = JSolverConfig(max_iter=20, rho_interval=0)
        if case == "kinematic-cold":
            warm, rho0 = None, None
    ref = jax.jit(lambda q, w, r: pallas_admm_solve(q, cfg, warm=w, rho0=r, interpret=True))(
        qp_b, warm, rho0)
    sol = admm_kernel_solve(
        convert.boxqp(qp_b, device="cpu"), convert.solver_config(cfg),
        warm=None if warm is None else tuple(convert.tensor(w, device="cpu") for w in warm),
        rho0=None if rho0 is None else convert.tensor(rho0, device="cpu"),
    )
    _compare(sol, ref)
    assert admm_kernel_solve.launches == 0   # CPU tensors never launch the kernel

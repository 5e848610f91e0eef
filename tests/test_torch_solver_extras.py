"""The port's solver extras vs the JAX package on the CPU: the associative
Riccati factorization, the early-exit ADMM solve, Ruiz row equilibration,
active-set polish, the Farkas infeasibility certificate and the production
pipeline.

Inputs are the JAX package's own test QPs (``tests/test_solver.py::
random_qp`` and ``tests/test_solver_extras.py::badly_scaled_qp``), built
with numpy from a seed and handed to the port through ``convert.boxqp``.
Tolerances are the JAX tests' own:

- the associative factor against the sequential one, K and Vc 3e-4 and the
  solve's U 5e-4 (tests/test_solver.py:93-101); the scan tree here is not
  XLA's, so the rounding differs;
- ``admm_solve_single``: the same exit iteration and U within 1e-5 (the
  bound of tests/test_solver.py:154);
- rows of unit inf-norm at 1e-5 relative, bounds scaled at 1e-6;
- polish lands within 1e-4 of the tight f64 oracle and never degrades the
  primal residual beyond 1e-5 (tests/test_solver_extras.py:105-141);
- ``production_solve`` with polish within 1e-4 of the f64 oracle, through
  the port's own stacker (tests/test_solver_extras.py:197-221): the port's
  rung of the oracle ladder for this slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.oracle import OsqpRefSettings, osqp_ref_solve
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve as jadmm_solve
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve_single as jadmm_solve_single
from autonomous_racing_lpv_mpp_mpc_tpu.solver import lqr_solve as jlqr_solve
from autonomous_racing_lpv_mpp_mpc_tpu.solver import polish as jpolish
from autonomous_racing_lpv_mpp_mpc_tpu.solver import qp_objective as jqp_objective
from autonomous_racing_lpv_mpp_mpc_tpu.solver import riccati_factor_assoc as jfactor_assoc
from autonomous_racing_lpv_mpp_mpc_tpu.solver import riccati_factor_scan as jfactor_scan
from autonomous_racing_lpv_mpp_mpc_tpu.solver.polish import stack_boxqp_jax as jstack

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import SolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import (
    admm_solve,
    admm_solve_equilibrated,
    admm_solve_single,
    certify_primal_infeasibility,
    hard_rows,
    kkt_residuals,
    lqr_solve,
    polish,
    production_solve,
    qp_objective,
    riccati_factor_assoc,
    riccati_factor_scan,
    ruiz_row_equilibrate,
    stack_boxqp,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver.admm import _map_qp

from tests.test_solver import N, NU, NX, random_qp
from tests.test_solver_extras import badly_scaled_qp


def _port(jqp):
    return convert.boxqp(jqp, device="cpu")


def _batch(seeds, tight=True):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *(random_qp(s, tight=tight) for s in seeds))


def _oracle_u(qp, eps):
    """U of the f64 oracle on a port QP, stacked by the port in float64."""
    st = stack_boxqp(_map_qp(lambda t: t.double(), qp))
    f = lambda t: t.numpy()
    ref = osqp_ref_solve(f(st.P), f(st.q), f(st.A), f(st.l), f(st.u),
                         OsqpRefSettings(eps_abs=eps, eps_rel=eps, max_iter=20000))
    assert ref.converged
    return ref.x[N * NX:].reshape(N, NU)


@pytest.mark.parametrize("seed", [1, 9])
def test_riccati_assoc_matches_jax(seed):
    jqp = random_qp(seed)
    qp = _port(jqp)
    fa, fs = riccati_factor_assoc(qp.dyn, qp.cost), riccati_factor_scan(qp.dyn, qp.cost)
    for jfac in (jfactor_assoc(jqp.dyn, jqp.cost), jfactor_scan(jqp.dyn, jqp.cost)):
        np.testing.assert_allclose(fa.K.numpy(), np.asarray(jfac.K), atol=3e-4, rtol=0)
        np.testing.assert_allclose(fa.Vc.numpy(), np.asarray(jfac.Vc), atol=3e-4, rtol=0)
    np.testing.assert_allclose(fa.K.numpy(), fs.K.numpy(), atol=3e-4, rtol=0)
    _, jU = jlqr_solve(jqp.dyn, jqp.cost, jqp.x0, "scan")
    _, U = lqr_solve(qp.dyn, qp.cost, qp.x0, "assoc")
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), atol=5e-4, rtol=0)


def test_riccati_assoc_batched_and_odd_horizons():
    """Leading batch dims, and horizons that are not powers of two (the
    scan's last round covers a partial span), against the sequential form."""
    qp = _port(_batch([2, 3, 4]))
    for n in (1, 3, 5, 8):
        dyn = type(qp.dyn)(*(t[:, :n] for t in qp.dyn))
        cost = type(qp.cost)(qp.cost.Q[:, : n + 1], qp.cost.q[:, : n + 1], qp.cost.R[:, :n],
                             qp.cost.r[:, :n], qp.cost.M[:, :n])
        fa, fs = riccati_factor_assoc(dyn, cost), riccati_factor_scan(dyn, cost)
        np.testing.assert_allclose(fa.K.numpy(), fs.K.numpy(), atol=3e-4, rtol=0)
        np.testing.assert_allclose(fa.Vc.numpy(), fs.Vc.numpy(), atol=3e-4, rtol=0)


@pytest.mark.parametrize("seed", [6, 10])
def test_admm_solve_single_matches_jax(seed):
    jqp = random_qp(seed)
    jcfg = JSolverConfig(max_iter=400, eps_abs=1e-6, eps_rel=1e-6, rho_interval=50)
    ref = jadmm_solve_single(jqp, jcfg)
    sol = admm_solve_single(_port(jqp), convert.solver_config(jcfg))
    assert bool(sol.converged) and bool(ref.converged)
    assert int(sol.iters) == int(ref.iters)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), atol=1e-5, rtol=0)


def test_admm_solve_single_batched_lanes_stop_on_their_own():
    """Each QP of a batch exits at its own iteration (the JAX function under
    vmap), and its iterate is the one it had when it stopped."""
    seeds = [6, 7, 10]
    jcfg = JSolverConfig(max_iter=400, eps_abs=1e-6, eps_rel=1e-6, rho_interval=50)
    sol = admm_solve_single(_port(_batch(seeds)), convert.solver_config(jcfg))
    for i, s in enumerate(seeds):
        one = admm_solve_single(_port(random_qp(s)), convert.solver_config(jcfg))
        assert int(sol.iters[i]) == int(one.iters)
        np.testing.assert_allclose(sol.U[i].numpy(), one.U.numpy(), atol=1e-6, rtol=0)


def test_ruiz_rows_unit_norm_and_bounds_consistent():
    jqp = badly_scaled_qp()
    qp = _port(jqp)
    scaled, sc = ruiz_row_equilibrate(qp)
    rn = torch.maximum(scaled.Dx.abs().amax(dim=1), scaled.Du.abs().amax(dim=1))
    np.testing.assert_allclose(rn.numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(scaled.lb.numpy(), qp.lb.numpy() * sc.d.numpy(), rtol=1e-6)
    # hard rows keep an infinite softness; the port's hard_rows is the JAX one
    assert torch.equal(scaled.soft, hard_rows(qp.Dx.shape[0]))


def test_equilibrated_solve_matches_jax_and_oracle():
    from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve_equilibrated as jeq

    jqp = badly_scaled_qp()
    jcfg = JSolverConfig(max_iter=400, eps_abs=1e-6, eps_rel=1e-6, rho_interval=50)
    ref = jeq(jqp, jcfg)
    qp = _port(jqp)
    sol = admm_solve_equilibrated(qp, convert.solver_config(jcfg))
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), atol=2e-4, rtol=0)
    np.testing.assert_allclose(sol.U.numpy(), _oracle_u(ruiz_row_equilibrate(qp)[0], 1e-8), atol=3e-4, rtol=0)


def test_stack_and_objective_match_jax():
    jqp = random_qp(12)
    qp = _port(jqp)
    st, jst = stack_boxqp(qp), jstack(jqp)
    for name in ("P", "q", "A", "l", "u"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert st.n_eq == jst.n_eq
    sol = admm_solve(qp, SolverConfig(max_iter=60))
    np.testing.assert_allclose(float(qp_objective(qp, sol.X, sol.U)),
                               float(jqp_objective(jqp, jnp.asarray(sol.X.numpy()), jnp.asarray(sol.U.numpy()))),
                               rtol=1e-5)


def test_polish_recovers_tight_solution_from_loose_admm():
    jqp = random_qp(12)
    qp = _port(jqp)
    loose = SolverConfig(max_iter=18, eps_abs=3e-3, eps_rel=3e-3, rho_interval=18)
    sol = admm_solve(qp, loose)
    pol = polish(qp, sol)
    assert bool(pol.improved)
    Ur = _oracle_u(qp, 1e-10)
    err_before = np.abs(sol.U.numpy() - Ur).max()
    err_after = np.abs(pol.U.numpy() - Ur).max()
    assert err_after < err_before
    assert err_after < 1e-4
    assert float(pol.r_prim) < 1e-4
    assert float(pol.r_dual) < 1e-3
    # the JAX polish of the same iterate lands on the same point
    jsol = jadmm_solve(jqp, convert_back_solver(loose))
    jpol = jpolish(jqp, jsol)
    assert bool(jpol.improved)
    np.testing.assert_allclose(pol.U.numpy(), np.asarray(jpol.U), atol=1e-4, rtol=0)


def convert_back_solver(scfg: SolverConfig) -> JSolverConfig:
    return JSolverConfig(max_iter=scfg.max_iter, eps_abs=scfg.eps_abs, eps_rel=scfg.eps_rel,
                         rho_interval=scfg.rho_interval)


@pytest.mark.parametrize("batched", [False, True])
def test_polish_never_degrades(batched):
    """On tight solves polish keeps or improves the primal feasibility; with
    a batch, each QP is polished as it would be alone."""
    seeds = [13, 14, 15]
    tight = SolverConfig(max_iter=400, eps_abs=1e-6, eps_rel=1e-6, rho_interval=50)
    qp = _port(_batch(seeds) if batched else random_qp(13))
    sol = admm_solve(qp, tight)
    st = stack_boxqp(qp)
    pol = polish(qp, sol)
    flat = lambda X, U: torch.cat([X[..., 1:, :].flatten(-2), U.flatten(-2)], dim=-1)
    y0 = torch.zeros(st.A.shape[:-1])
    rp0, _ = kkt_residuals(st, flat(sol.X, sol.U), y0)
    rp1, _ = kkt_residuals(st, flat(pol.X, pol.U), y0)
    assert bool((rp1 <= rp0 + 1e-5).all())
    if batched:
        for i, s in enumerate(seeds):
            one_qp = _port(random_qp(s))
            one = polish(one_qp, admm_solve(one_qp, tight))
            np.testing.assert_allclose(pol.U[i].numpy(), one.U.numpy(), atol=1e-5, rtol=0)


def _infeasible(jqp):
    """Row 4 duplicates row 0 with a disjoint interval (the JAX test's QP)."""
    fin = jnp.isfinite(jqp.ub[:, 0])
    return jqp._replace(
        Dx=jqp.Dx.at[4].set(jqp.Dx[0]), Du=jqp.Du.at[4].set(jqp.Du[0]),
        lb=jqp.lb.at[:, 4].set(jnp.where(fin, jqp.ub[:, 0] + 5.0, -jnp.inf)),
        ub=jqp.ub.at[:, 4].set(jnp.where(fin, jqp.ub[:, 0] + 6.0, jnp.inf)))


def test_primal_infeasibility_certificate():
    """The heuristic fires on the infeasible QPs and the Farkas test confirms
    it, each QP of a batch on its own; a feasible QP is not certified; the
    JAX certificate agrees."""
    from autonomous_racing_lpv_mpp_mpc_tpu.solver import certify_primal_infeasibility as jcert

    jbad = [_infeasible(random_qp(s)) for s in (21, 23)]
    jcfg = JSolverConfig(max_iter=300, rho_interval=25)
    cfg = convert.solver_config(jcfg)
    bad = _port(jax.tree.map(lambda *ls: jnp.stack(ls), *jbad))
    sol = admm_solve(bad, cfg)
    assert bool(sol.primal_infeasible.all())
    cert, dy = certify_primal_infeasibility(bad, cfg, sol)
    assert bool(cert.all())
    st = stack_boxqp(bad)
    norm = dy.abs().amax(dim=-1)
    assert bool(((st.A.transpose(-1, -2) @ dy[..., None])[..., 0].abs().amax(dim=-1) <= 1e-3 * norm).all())
    good = _port(random_qp(21))
    solf = admm_solve(good, cfg)
    certf, _ = certify_primal_infeasibility(good, cfg, solf)
    assert not bool(certf) and bool(solf.converged)
    jcert_bad, _ = jcert(jbad[0], jcfg, jadmm_solve(jbad[0], jcfg))
    assert bool(jcert_bad)


def test_production_solve_pipeline_matches_oracle():
    """equilibrate -> ADMM -> polish on a badly scaled QP reaches the f64
    oracle within 1e-4 (the oracle solves the equilibrated problem: U is
    invariant under row scaling); without polish it is exactly
    ``admm_solve_equilibrated``; it agrees with the JAX pipeline."""
    from autonomous_racing_lpv_mpp_mpc_tpu.solver import production_solve as jprod

    jqp = badly_scaled_qp(factor=500.0)
    qp = _port(jqp)
    cfg = SolverConfig(max_iter=200, eps_abs=1e-4, eps_rel=1e-4, rho_interval=25, polish=True)
    sol = production_solve(qp, cfg)
    assert bool(sol.converged)
    Ur = _oracle_u(ruiz_row_equilibrate(qp)[0], 1e-9)
    assert np.abs(sol.U.numpy() - Ur).max() < 1e-4
    dflt = cfg.replace(polish=False)
    a, b = production_solve(qp, dflt), admm_solve_equilibrated(qp, dflt)
    assert torch.equal(a.U, b.U)
    jsol = jprod(jqp, JSolverConfig(max_iter=200, eps_abs=1e-4, eps_rel=1e-4, rho_interval=25, polish=True))
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U), atol=1e-4, rtol=0)

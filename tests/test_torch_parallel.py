"""The port's parallel layer (``parallel/``) vs the JAX package, on the CPU.

Ranks are gloo processes: the in-process tests form a one-rank group
through a FileStore in tmp_path (torn down after the test); the multi-rank
tests spawn their ranks with ``torch.multiprocessing`` (the rank bodies are
in tests/_torch_dist_worker.py, which imports no JAX) and hold what they
write against the JAX package on its fake 8-device mesh.

- Audit: no raw collective of ``torch.distributed`` outside
  ``parallel/collectives.py`` (tests/test_collectives_audit.py's rule).
- ``make_mesh`` / ``from_config`` shapes, ``scenario_sharding`` and
  ``host_local_to_global`` at world size 1; the collectives' arithmetic.
- At world size 1, ``sharded_closed_loop``, ``sharded_mega_loop``,
  ``sharded_solve_step`` and ``sharded_race_sweep`` equal the unsharded
  port bit for bit (the same code on the same lanes), and their metrics a
  host computation (rtol 1e-6).
- ``horizon_sharded_solve`` at one horizon rank against JAX's plain solve:
  1e-5 (tests/test_parallel.py::test_horizon_sharded_solve_matches_plain).
- Two ranks: ``sharded_closed_loop`` (B=8, T=30): the gathered log within
  2e-5 of the port's unsharded run (JAX's own bound,
  tests/test_parallel.py:52-75), the metrics equal on both ranks and
  within 1e-4 of JAX's ``sharded_closed_loop`` on a 2-device mesh (30
  steps of f32 closed loop; the logs themselves agree within 2e-4, the
  port's closed-loop parity bound).
- Two ranks: ``riccati_factor_horizon_sharded`` (N=16, na=4) and
  ``admm_solve_horizon_sharded`` (N=16, max_iter=40, rho_interval=10)
  against JAX's single-device factorization and solve: 2e-5, rho rtol 1e-4,
  the same convergence flag.
- ``slow``: ``horizon_sharded_solve`` on a 2 x 2 mesh (four ranks) against
  JAX's plain solve (1e-5), and config5's weak-scaling efficiency at two
  ranks (tests/test_multiprocess.py's band).
"""

import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_worker as W
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.engine import build_boxqp as jbuild_boxqp
from autonomous_racing_lpv_mpp_mpc_tpu.engine import initial_schedule as jinitial_schedule
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.parallel import make_mesh as jmake_mesh
from autonomous_racing_lpv_mpp_mpc_tpu.parallel import make_scenario_grid as jmake_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu.parallel import sharded_closed_loop as jsharded_closed_loop
from autonomous_racing_lpv_mpp_mpc_tpu.solver import LQRCost as JLQRCost
from autonomous_racing_lpv_mpp_mpc_tpu.solver import LQRDynamics as JLQRDynamics
from autonomous_racing_lpv_mpp_mpc_tpu.solver import admm_solve as jadmm_solve
from autonomous_racing_lpv_mpp_mpc_tpu.solver import riccati_factor_scan as jriccati_factor_scan
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, MeshConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    closed_loop, constant_refs, initial_table, mega_race_sweep, mpc_init, mpc_step_batched,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep, megastep_init, megastep_params
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import (
    SweepMetrics, host_local_to_global, make_mesh, make_scenario_grid, pmax_scalar, pmean_tree, psum_tree,
    scenario_sharding, sharded_closed_loop, sharded_mega_loop, sharded_race_sweep, sharded_solve_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.collectives import all_gather, all_gather_tree
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.horizon import horizon_sharded_solve
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.mesh import from_config
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack

CPU = "cpu"
PKG = pathlib.Path(__file__).resolve().parent.parent / "autonomous_racing_lpv_mpp_mpc_tpu_torch"
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "broadcast_object_list", "all_to_all",
                "all_to_all_single", "send", "recv", "isend", "irecv", "reduce", "gather", "scatter",
                "barrier", "monitored_barrier")
RAW = re.compile(r"(?:\bdist|torch\.distributed)\.(" + "|".join(_COLLECTIVES) + r")\s*\(")
RAW_IMPORT = re.compile(r"from\s+torch\.distributed\s+import\s+[^\n]*\b(" + "|".join(_COLLECTIVES) + r")\b")


@pytest.fixture
def group1(tmp_path):
    """A one-rank gloo group for the test (FileStore in tmp_path), destroyed
    after it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_no_raw_collective_outside_collectives_module():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if rel == "parallel/collectives.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            code = line.split("#", 1)[0]
            m = RAW.search(code) or RAW_IMPORT.search(code)
            if m:
                offenders.append(f"{rel}:{i}: {m.group(1)}")
    assert not offenders, "raw collectives outside parallel/collectives.py:\n" + "\n".join(offenders)
    # the audit point itself still calls the raw primitives
    assert RAW.search((PKG / "parallel" / "collectives.py").read_text())


def test_mesh_and_collectives_at_world_size_1(group1):
    mesh = make_mesh(device=CPU)
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("scenarios", "horizon")
    assert from_config(MeshConfig(), device=CPU).shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_scenario=2, device=CPU)
    scen = make_scenario_grid(VehicleParams(), MPCConfig(N=8), n_ey=4, n_mu=2, device=CPU)
    local = scenario_sharding(mesh, scen)
    assert torch.equal(local.x0, scen.x0) and torch.equal(local.params.mu, scen.params.mu)
    assert local.params.m == scen.params.m                     # float leaves pass through
    assert torch.equal(host_local_to_global(mesh, local.x0), scen.x0)
    g = mesh.get_group("scenarios")
    m = SweepMetrics(*(torch.tensor(float(i)) for i in range(5)))
    assert psum_tree(m, g) == m and isinstance(psum_tree(m, g), SweepMetrics)
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, 2)]}
    assert torch.equal(pmean_tree(tree, g)["a"], tree["a"])
    assert torch.equal(pmax_scalar(torch.tensor([1.0, -2.0]), g), torch.tensor([1.0, -2.0]))
    assert all_gather(torch.ones(2, 3), g, axis=1).shape == (2, 1, 3)
    assert all_gather(torch.ones(2, 3), g, axis=1, tiled=True).shape == (2, 3)
    assert all_gather_tree(tree, g)["b"][0].shape == (1, 2, 2)


def _kin_case(B_ey=4, B_mu=2):
    scen = make_scenario_grid(VehicleParams(), W.KIN, n_ey=B_ey, n_mu=B_mu, vx0=1.0, device=CPU)
    return scen, oval_track(device=CPU), constant_refs(W.KIN, 1.2, device=CPU)


def _metrics_by_host(X, conv, iters, ey_i, s_i):
    X, conv, iters = (np.asarray(a, np.float64) for a in (X, conv, iters))
    return [X.shape[0], np.sqrt((X[..., ey_i] ** 2).mean(axis=1)).mean(), conv.mean(), iters.mean(),
            X[:, -1, s_i].mean()]


def test_sharded_loops_at_world_size_1_equal_unsharded(group1):
    mesh = make_mesh(device=CPU)
    scen, track, refs = _kin_case()
    log, m = sharded_closed_loop(mesh, scen, W.KIN, W.KIN_SCFG, track, refs, T=10)
    ref = closed_loop(scen.params, W.KIN, W.KIN_SCFG, track, scen.x0, refs, T=10)
    for a, b in zip(log, ref):
        assert torch.equal(a, b.movedim(0, 1))
    np.testing.assert_allclose([float(v) for v in m], _metrics_by_host(log.X, log.converged, log.iters, 3, 2),
                               rtol=1e-6)

    cfg, scfg = MPCConfig(N=8), SolverConfig(max_iter=20, rho_interval=0)
    dscen = make_scenario_grid(VehicleParams(), cfg, n_ey=4, n_mu=2, vx0=1.5, device=CPU)
    rt, drefs = racetrack(device=CPU), constant_refs(cfg, 1.8, device=CPU)
    X, m = sharded_mega_loop(mesh, dscen, cfg, scfg, rt, drefs, T=6)
    carry = megastep_init(dscen.params, cfg, rt, dscen.x0)
    prm = megastep_params(dscen.params, dscen.batch, device=CPU)
    xs, conv, iters = [], [], []
    for _ in range(6):
        carry, _, diag = megastep(cfg, scfg, rt, prm, drefs, carry)
        xs.append(carry.x.T)
        conv.append(diag[2])
        iters.append(diag[4])
    assert torch.equal(X, torch.stack(xs, dim=1))
    np.testing.assert_allclose([float(v) for v in m],
                               _metrics_by_host(X, torch.stack(conv).T, torch.stack(iters).T, 5, 4), rtol=1e-6)


def test_sharded_step_and_race_sweep_at_world_size_1_equal_unsharded(group1):
    mesh = make_mesh(device=CPU)
    cfg = MPCConfig(N=8, tire="pacejka")
    scfg = SolverConfig(max_iter=20, rho_interval=0, backend="admm")
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=2, n_mu=2, vx0=1.5, device=CPU)
    rt, refs = racetrack(device=CPU), constant_refs(cfg, 1.8, device=CPU)
    out = sharded_solve_step(mesh, scen, cfg, scfg, rt, refs)
    ref = mpc_step_batched(scen.params, cfg, scfg, rt, scen.x0, refs, mpc_init(scen.params, cfg, rt, scen.x0))
    assert torch.equal(out[0], ref[0]) and all(torch.equal(a, b) for a, b in zip(out[1], ref[1]))

    rscfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    table = initial_table(rt, ds=0.05, vx0=1.5)
    x0 = torch.zeros((4, 6))
    x0[:, 0] = 1.5
    mu = torch.linspace(0.5, 1.2, 4)
    sigma = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01)
    mu_hat, Xf, m = sharded_race_sweep(mesh, VehicleParams(), cfg, rscfg, rt, table, x0, 5, mu, mu0=0.85,
                                       noise_sigma=sigma, seed=6)
    log = mega_race_sweep(VehicleParams(), cfg, rscfg, rt, table, x0, 5, mu, mu0=0.85, noise_sigma=sigma, seed=6)
    assert torch.equal(mu_hat, log.mu_hat) and torch.equal(Xf, log.Xf)
    np.testing.assert_allclose([float(v) for v in m],
                               _metrics_by_host(Xf, log.converged, torch.zeros_like(log.converged), 5, 4),
                               rtol=1e-6)


def _jax_plain_solves(cfg, scfg, refs_vx, x0s):
    """JAX's single-device solve of each lane's QP from rest."""
    jcfg = JMPCConfig(N=cfg.N, model=cfg.model)
    track, refs = joval(), jconstant_refs(jcfg, refs_vx)

    def plain(x0, mu):
        p = JVehicleParams(mu=mu)
        u0 = jnp.zeros(2)
        X_s, U_s = jinitial_schedule(p, jcfg, track, x0, u0)
        return jadmm_solve(jbuild_boxqp(p, jcfg, track, x0, u0, X_s, U_s, refs),
                           JSolverConfig(max_iter=scfg.max_iter)).U

    return np.asarray(jax.jit(jax.vmap(plain))(*x0s))


def test_horizon_sharded_solve_at_one_horizon_rank_matches_jax(group1):
    mesh = make_mesh(device=CPU)
    cfg, scfg = MPCConfig(N=8), SolverConfig(max_iter=30)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=4, n_mu=1, vx0=1.2, device=CPU)
    U, conv = horizon_sharded_solve(mesh, scen, cfg, scfg, oval_track(device=CPU),
                                    constant_refs(cfg, 1.5, device=CPU))
    assert U.shape == (4, 8, 2) and conv.shape == (4,)
    ref = _jax_plain_solves(cfg, scfg, 1.5, (jnp.asarray(scen.x0.numpy()), jnp.asarray(scen.params.mu.numpy())))
    np.testing.assert_allclose(U.numpy(), ref, atol=1e-5, rtol=0)


def _start(fn, world, tmp_path, *args):
    """Start the ranks; the returned call waits for them and loads what each
    wrote (the parent computes its JAX reference meanwhile)."""
    out = tmp_path / "out"
    out.mkdir()
    ctx = W.start(fn, world, str(tmp_path / "store"), str(out), *args)

    def results():
        W.wait(ctx)
        return [torch.load(out / f"rank{r}.pt") for r in range(world)]

    return results


def _spawn(fn, world, tmp_path, *args):
    return _start(fn, world, tmp_path, *args)()


def test_two_rank_sharded_closed_loop_matches_jax(tmp_path):
    results = _start(W.closed_loop_rank, 2, tmp_path)
    jcfg = JMPCConfig(N=8, model="kinematic", weights=JMPCWeights.for_model("kinematic"))
    jscen = jmake_scenario_grid(JVehicleParams(), jcfg, n_ey=4, n_mu=2, vx0=1.0)
    jlog, jm = jax.jit(lambda s: jsharded_closed_loop(jmake_mesh(devices=jax.devices()[:2]), s, jcfg,
                                                      JSolverConfig(max_iter=40), joval(), jconstant_refs(jcfg, 1.2),
                                                      T=30))(jscen)
    scen, track, refs = _kin_case()
    ref = closed_loop(scen.params, W.KIN, W.KIN_SCFG, track, scen.x0, refs, T=30).X.movedim(0, 1)
    outs = results()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["X"].numpy(), ref.numpy(), atol=2e-5, rtol=0)
        assert torch.equal(o["X_local"], o["X"][4 * r:4 * (r + 1)])
    assert all(torch.equal(a, b) for a, b in zip(outs[0]["metrics"], outs[1]["metrics"]))
    np.testing.assert_allclose(outs[0]["X"].numpy(), np.asarray(jlog.X), atol=2e-4, rtol=0)
    np.testing.assert_allclose([float(v) for v in outs[0]["metrics"]], [float(v) for v in jm], atol=1e-4, rtol=0)


def test_two_rank_horizon_riccati_and_admm_match_jax(tmp_path):
    results = _start(W.horizon_rank, 2, tmp_path)
    J = {k: jnp.asarray(v) for k, v in W.riccati_inputs().items()}
    fac = jax.jit(jriccati_factor_scan)(JLQRDynamics(J["A"], J["B"], J["c"]),
                                        JLQRCost(J["Q"], J["q"], J["R"], J["r"], J["M"]))
    jcfg = JMPCConfig(N=16, model="dynamic")
    track = joval()

    def solve(x0):
        u0 = jnp.zeros(2)
        X_s, U_s = jinitial_schedule(JVehicleParams(), jcfg, track, x0, u0)
        qp = jbuild_boxqp(JVehicleParams(), jcfg, track, x0, u0, X_s, U_s, jconstant_refs(jcfg, 1.5))
        return jadmm_solve(qp, JSolverConfig(max_iter=40, rho_interval=10))

    sol = jax.jit(solve)(jnp.asarray(W.ADMM_X0))
    for o in results():
        np.testing.assert_allclose(o["K"].numpy(), np.asarray(fac.K), atol=2e-5, rtol=0)
        np.testing.assert_allclose(o["Vc"].numpy(), np.asarray(fac.Vc), atol=2e-5, rtol=0)
        np.testing.assert_allclose(o["U"].numpy(), np.asarray(sol.U), atol=2e-5, rtol=0)
        np.testing.assert_allclose(o["X"].numpy(), np.asarray(sol.X)[:-1], atol=2e-5, rtol=0)
        np.testing.assert_allclose(float(o["rho"]), float(sol.rho), rtol=1e-4)
        assert bool(o["converged"]) == bool(sol.converged)


@pytest.mark.slow
def test_four_rank_2d_horizon_sharded_solve_matches_jax(tmp_path):
    outs = _spawn(W.horizon_2d_rank, 4, tmp_path)
    cfg = MPCConfig(N=8)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=4, n_mu=1, vx0=1.2, device=CPU)
    ref = _jax_plain_solves(cfg, SolverConfig(max_iter=30), 1.5,
                            (jnp.asarray(scen.x0.numpy()), jnp.asarray(scen.params.mu.numpy())))
    for o in outs:
        np.testing.assert_allclose(o["U"].numpy(), ref, atol=1e-5, rtol=0)
        assert torch.equal(o["converged"], outs[0]["converged"])


@pytest.mark.slow
def test_two_rank_config5_scaling_efficiency(tmp_path):
    outs = _spawn(W.config5_rank, 2, tmp_path)
    assert outs[0] == outs[1]                  # the walls are max-reduced: one figure on every rank
    r = outs[0]
    assert r["devices"] == 2 and r["batch"] == 16 and r["trials"] == 7
    assert 0.65 <= r["scaling_efficiency"] <= 1.35, r["scaling_efficiency"]
    assert r["converged_frac"] > 0.9

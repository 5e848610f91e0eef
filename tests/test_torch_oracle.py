"""The port's oracle (``oracle/``) against the JAX package's, and the
port's plain paths against the port's own oracle (CPU).

- ``osqp_ref_solve`` on tests/test_solver.py's seeded random QPs, stacked
  by the JAX stacker as tests/test_native.py does, and on a primal- and a
  dual-infeasible QP (tests/test_solver_extras.py's certificates): x, y,
  z, iterations, status and certificates bitwise equal to the JAX
  oracle's, since it is the same float64 algorithm.
- ``stack_boxqp`` / ``unstack_solution`` on the bench QP at N=20 (dynamic,
  racetrack) and N=10 (kinematic, oval), the JAX BoxQP carried across with
  ``convert.boxqp``: the stacked arrays bitwise the JAX stacker's, the
  unstack round trip exact; ``boxqp_lane`` takes the lane asked for.
- ``osqp_native_solve`` against the numpy oracle (tests/test_native.py's
  three cases), and ``NativeUnavailable`` where the library cannot be
  found: the native core is never a silent fallback.
- Short oracle rungs: the plain megastep (N=20, racetrack), the plain
  racestep (B=2, sensor noise from a seed, the QP of each checked step
  rebuilt at the new filtered state with the old carry's mu-hat and warm
  start) and the fused and admm routes of ``mpc_step_batched`` (their
  plain versions on CPU tensors), each at its cell's solver config for 35
  steps, every 5th step's u0 within 5e-5 of the port's oracle
  (tests/test_headline_oracle.py's rung).
- Importing ``oracle`` brings in no JAX and nothing of the JAX package.
- chip_smoke.py's ``[oracle]`` branch for a converged lane-check over its
  bound, on each cell rung's route at B=4 on the CPU: the plain version
  replayed from the saved carry gives u0 (B, 2) by global lane, a lane that
  plain leaves out of bound too gets the algorithmic bound, and a lane that
  plain keeps within bound fails the run as a kernel fault.

``slow``: tests/test_headline_oracle.py's full oval lap (N=12, T=210) on the
port's plain megastep and its own oracle, and a full racetrack lap at N=20
with a sinusoidal reference table, both at 5e-5.
"""

import importlib.util
import subprocess
import sys
import types
from contextlib import nullcontext
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu import oracle as joracle
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_prepare as jmpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch import oracle
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    DEFAULT_EKF_Q, MPCCarry, constant_refs, initial_table, mpc_init, mpc_prepare, mpc_step_batched,
    plant_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    megastep, megastep_init, megastep_params, megastep_plain, racestep, racestep_init, racestep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle import native
from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.stack import boxqp_lane
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import RefTable
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack

try:
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None

RUNG = 5e-5                    # tests/test_headline_oracle.py:98
BENCH = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
SIGMA = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01)    # tools/racebench.py's sensor noise


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The oracle's dense float64 solves are small (n ~ 200): one BLAS
    thread each, as chip_smoke.py's oracle workers run them. With every
    core's BLAS threads spinning against the other test processes, an
    oracle solve takes seconds instead of ~40 ms."""
    with threadpool_limits(1) if threadpool_limits is not None else nullcontext():
        yield


def _random_qp(seed):
    from tests.test_solver import random_qp

    return random_qp(seed)


def _same_result(a, b):
    for f in ("x", "y", "z", "cert_dy", "cert_dx"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert np.array_equal(va, vb), f
    for f in ("iters", "r_prim", "r_dual", "converged", "obj", "primal_infeasible", "dual_infeasible"):
        va, vb = getattr(a, f), getattr(b, f)
        assert va == vb or (np.isnan(va) and np.isnan(vb)), (f, va, vb)


@pytest.mark.parametrize("seed", [2, 3, 5, 11])
def test_oracle_bitwise_matches_jax(seed):
    stacked = joracle.stack_boxqp(_random_qp(seed))
    mine = oracle.osqp_ref_solve(*stacked, oracle.OsqpRefSettings())
    ref = joracle.osqp_ref_solve(*stacked, joracle.OsqpRefSettings())
    assert mine.converged
    _same_result(mine, ref)


def _primal_infeasible():
    P, q, A, l, u = joracle.stack_boxqp(_random_qp(17))
    return (P, q, np.vstack([A, A[-1:]]), np.concatenate([l, [l[-1] + 10.0]]),
            np.concatenate([u, [u[-1] + 10.0]])), 4000


def _dual_infeasible():
    return (np.zeros((1, 1)), np.array([-1.0]), np.eye(1), np.array([0.0]), np.array([np.inf])), 2000


@pytest.mark.parametrize("case", ["primal", "dual"])
def test_oracle_certificates_bitwise_match_jax(case):
    qp, max_iter = {"primal": _primal_infeasible, "dual": _dual_infeasible}[case]()
    mine = oracle.osqp_ref_solve(*qp, oracle.OsqpRefSettings(max_iter=max_iter))
    ref = joracle.osqp_ref_solve(*qp, joracle.OsqpRefSettings(max_iter=max_iter))
    assert not mine.converged
    assert mine.primal_infeasible == (case == "primal") and mine.dual_infeasible == (case == "dual")
    _same_result(mine, ref)


def _jax_bench_qp(kind):
    """The bench QP of one car from its first carry: dynamic N=20 on the
    racetrack (vx ref 1.8) or kinematic N=10 on the oval (vx ref 1.5)."""
    P = JVehicleParams()
    if kind == "dynamic":
        cfg, track, v = JMPCConfig(N=20), jrace(), 1.8
        x0 = jnp.array([1.5, 0.0, 0.0, 0.0, 0.0, 0.1], jnp.float32)
    else:
        cfg, track, v = JMPCConfig(N=10, model="kinematic", weights=JMPCWeights.for_model("kinematic")), joval(), 1.5
        x0 = jnp.array([0.5, 0.0, 0.0, 0.1], jnp.float32)
    carry = jmpc_init(P, cfg, track, x0)
    return jax.jit(lambda x, c: jmpc_prepare(P, cfg, track, x, jconstant_refs(cfg, v), c)[0])(x0, carry)


@pytest.mark.parametrize("kind", ["dynamic", "kinematic"])
def test_stacker_bitwise_matches_jax(kind):
    jqp = _jax_bench_qp(kind)
    qp = convert.boxqp(jqp, device="cpu")
    mine, ref = oracle.stack_boxqp(qp), joracle.stack_boxqp(jqp)
    N, nx, nu = qp.dyn.B.shape
    assert mine[0].shape == (N * (nx + nu),) * 2
    for a, b in zip(mine, ref):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    # the unstack round trip, on the oracle's own solution
    sol = oracle.osqp_ref_solve(*mine, oracle.OsqpRefSettings())
    assert sol.converged
    X, U = oracle.unstack_solution(qp, sol.x)
    Xj, Uj = joracle.unstack_solution(jqp, sol.x)
    assert np.array_equal(X, Xj) and np.array_equal(U, Uj)
    assert np.array_equal(X[0], qp.x0.double().numpy())
    assert np.array_equal(np.concatenate([X[1:].ravel(), U.ravel()]), sol.x)
    # boxqp_lane takes the lane asked for out of a batch-first BoxQP
    other = qp._replace(x0=qp.x0 + 0.01, lb=qp.lb - 0.5)
    pair = lambda a, b: torch.stack([a, b])
    batch = qp._replace(dyn=type(qp.dyn)(*map(pair, other.dyn, qp.dyn)),
                        cost=type(qp.cost)(*map(pair, other.cost, qp.cost)),
                        lb=pair(other.lb, qp.lb), ub=pair(other.ub, qp.ub), x0=pair(other.x0, qp.x0))
    for b, want in ((0, other), (1, qp)):
        for x, y in zip(oracle.stack_boxqp(boxqp_lane(batch, b)), oracle.stack_boxqp(want)):
            assert np.array_equal(x, y)


@pytest.fixture
def needs_native():
    """Skip where the native core can be neither found nor built (no g++);
    decided when the test runs, not when the file is imported."""
    if not native.native_available():
        pytest.skip("native core not buildable (no g++)")


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("seed", [2, 3, 11])
def test_native_matches_numpy_oracle(seed):
    stacked = joracle.stack_boxqp(_random_qp(seed))
    ref = oracle.osqp_ref_solve(*stacked)
    nat = native.osqp_native_solve(*stacked)
    assert nat.converged and ref.converged
    np.testing.assert_allclose(nat.x, ref.x, atol=1e-9)
    assert nat.iters == ref.iters


@pytest.mark.usefixtures("needs_native")
def test_native_infinite_bounds_and_nonconvergence():
    P, q, A, l, u = joracle.stack_boxqp(_random_qp(5))
    l2, u2 = l.copy(), u.copy()
    l2[-3:], u2[-3:] = -np.inf, np.inf
    nat = native.osqp_native_solve(P, q, A, l2, u2)
    assert nat.converged and np.all(np.isfinite(nat.x))
    # two parallel rows that demand different values: primal infeasible
    P, q, A, l, u = joracle.stack_boxqp(_random_qp(6))
    A2 = np.vstack([A, A[-1:]])
    l2 = np.concatenate([l, [u[-1] + 5.0]])
    u2 = np.concatenate([u, [u[-1] + 6.0]])
    nat = native.osqp_native_solve(P, q, A2, l2, u2, oracle.OsqpRefSettings(max_iter=300))
    assert not nat.converged and np.all(np.isfinite(nat.x))


def test_native_missing_library_raises(monkeypatch):
    def missing(lib, target):
        raise native.NativeLibUnavailable(f"{lib} not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "find_native_lib", missing)
    assert not native.native_available()
    with pytest.raises(native.NativeUnavailable):
        native.osqp_native_solve(np.eye(1), np.zeros(1), np.eye(1), np.zeros(1), np.ones(1))


def _lanes_carry(c, idx):
    """Batch-first MPCCarry of lanes idx of a batch-last carry."""
    fb = lambda t: t[..., idx].movedim(-1, 0)
    return MPCCarry(X_pred=fb(c.X_pred), U_pred=fb(c.U_pred), s=fb(c.s), lam=fb(c.lam),
                    u_prev=fb(c.u_prev), rho=c.rho[idx])


def _oracle_du(qp, u, conv):
    """(|u - U_oracle[0]| per lane, converged on both sides per lane) for
    the lanes of a batch-first QP; the oracle must converge on every one."""
    du, both = [], []
    for b in range(qp.x0.shape[0]):
        lane = boxqp_lane(qp, b)
        ref = oracle.osqp_ref_solve(*oracle.stack_boxqp(lane), oracle.OsqpRefSettings())
        assert ref.converged
        du.append(float(np.abs(u[b].double().numpy() - oracle.unstack_solution(lane, ref.x)[1][0]).max()))
        both.append(bool(conv[b]))
    return du, both


def _gate(label, du, both):
    """chip_smoke.py's [oracle] gate of cells (c)-(e): the lane-checks
    converged on both sides within the rung, and at least 90% of them."""
    du, both = np.array(du), np.array(both)
    print(f"oracle rung, {label}: max |du| {du[both].max():.3e} over {both.sum()} of {du.size} lane-checks "
          f"converged on both sides (the others' max {du[~both].max() if (~both).any() else 0.0:.3e})")
    assert both.sum() >= 0.9 * du.size and du[both].max() < RUNG


def _sinusoidal_table(track, ds=0.05):
    """tests/test_torch_closed_loop.py's racing line e_y = 0.1 sin(6 pi s / L),
    vx 1.5 +- 0.3."""
    L = float(track.length)
    n = int(round(L / ds))
    w = 2 * np.pi * 3 * np.arange(n) * (L / n) / L
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return RefTable(ds=t(L / n), length=t(L), vx=t(1.5 + 0.3 * np.sin(w)), ey=t(0.1 * np.sin(w)),
                    delta=t(0.02 * np.cos(w)))


def _megastep_rung(N, track, x_ref, T, until_lap=False):
    """The plain megastep at B=1 at the bench solver config from x0 = [1, 0,
    0, 0, 0, 0.05]; every 5th step's QP to the oracle. Returns (max |du|,
    checks, final s)."""
    p, cfg = VehicleParams(), MPCConfig(N=N, model="dynamic")
    car = megastep_init(p, cfg, track, torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.05]]))
    prm = megastep_params(p, 1, device="cpu")
    L = float(track.length)
    worst, checks = 0.0, 0
    for t in range(T):
        if t % 5 == 0:
            if until_lap and float(car.x[4, 0]) > L:
                break
            qp = mpc_prepare(p, cfg, track, car.x.T, x_ref, _lanes_carry(car, [0]))[0]
        car_n, u0, diag = megastep_plain(cfg, BENCH, track, prm, x_ref, car)
        if t % 5 == 0:
            worst = max(worst, *_oracle_du(qp, u0.T, diag[2] > 0.5)[0])
            checks += 1
        car = car_n
    return worst, checks, float(car.x[4, 0])


def test_oracle_rung_plain_megastep_racetrack():
    track = racetrack(device="cpu")
    worst, checks, _ = _megastep_rung(20, track, constant_refs(MPCConfig(N=20), 1.5, device="cpu"), 35)
    print(f"oracle rung, plain megastep N=20 racetrack: max |du| {worst:.3e} over {checks} checks")
    assert checks == 7 and worst < RUNG


def test_oracle_rung_plain_racestep():
    """B=2 cars of the composed protocol (Pacejka, initial_table, plant mu
    0.5 and 1.2, seed mu 0.85, sensor noise from a seed); the tracker's QP
    of step t is mpc_prepare at the pre-step carry's mu-hat, at the new
    carry's filtered state, with the pre-step carry's warm start."""
    B, track = 2, racetrack(device="cpu")
    p, cfg = VehicleParams(), MPCConfig(N=20, model="dynamic", tire="pacejka")
    p_nom = p.replace(mu=0.85)
    table = initial_table(track, ds=0.05, vx0=1.5)
    x0 = torch.zeros((B, 6))
    x0[:, 0], x0[:, 4] = 1.5, torch.tensor([0.0, 0.5 * float(track.length)])
    mu_true = torch.tensor([0.5, 1.2])
    prm = megastep_params(p_nom, B, device="cpu")
    ekq, ekr = torch.tensor(DEFAULT_EKF_Q), torch.tensor(SIGMA) ** 2
    rng = np.random.default_rng(7)
    car = racestep_init(p, cfg, track, x0, 0.85)
    du, both = [], []
    for t in range(35):
        noise = torch.tensor(np.asarray(SIGMA, np.float32)[:, None] * rng.standard_normal((6, B)).astype(np.float32))
        new, u0, diag, _ = racestep_plain(cfg, BENCH, track, prm, table, car, noise, mu_true, ekq, ekr,
                                          sim_tire="pacejka")
        if t % 5 == 0:
            qp = mpc_prepare(p_nom.replace(mu=car.fr[0]), cfg, track, new.ekx.T, table,
                             _lanes_carry(car, list(range(B))))[0]
            d, c = _oracle_du(qp, u0.T, diag[2] > 0.5)
            du, both = du + d, both + c
        car = new
    assert len(du) == 7 * B
    _gate(f"plain racestep B={B} N=20", du, both)


@pytest.mark.parametrize("backend", ["fused", "admm"])
def test_oracle_rung_mpc_step_routes(backend):
    """The fused route (cell 3's fixed count) and the admm route (cell 1's
    admm steps) of mpc_step_batched on CPU tensors (their plain versions),
    on four lanes of a 2 x 2 grid (e_y +-0.1, mu 0.7 and 1.0)."""
    p, cfg, track = VehicleParams(), MPCConfig(N=20), racetrack(device="cpu")
    scfg = SolverConfig(max_iter=20, rho_interval=0, backend=backend, early_exit=False, check_termination=2,
                        polish=False, certify_infeasibility=False)
    scen = make_scenario_grid(p, cfg, n_ey=2, n_mu=2, ey_span=0.1, vx0=1.5, device="cpu")
    x_ref = constant_refs(cfg, 1.8, device="cpu")
    car, x = mpc_init(scen.params, cfg, track, scen.x0), scen.x0
    du, both = [], []
    for t in range(35):
        u, car_n, diag = mpc_step_batched(scen.params, cfg, scfg, track, x, x_ref, car)
        if t % 5 == 0:
            qp = mpc_prepare(scen.params, cfg, track, x, x_ref, car)[0]
            d, c = _oracle_du(qp, u, diag.converged)
            du, both = du + d, both + c
        x, car = plant_step(scen.params, cfg, track, x, u, n_sub=4), car_n
    assert len(du) == 7 * 4
    _gate(f"{backend} route B=4 N=20", du, both)


def test_oracle_imports_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle\n"
        "import autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.native\n"
        "bad = sorted(n for n in set(sys.modules) - before if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'autonomous_racing_lpv_mpp_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print(sorted(autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted(joracle.__all__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cells_cpu():
    """chip_smoke.py main()'s setup of cells 1-3 at B=4 on the CPU (a 2 x 2
    grid stands for the 64 x 64 one; cell 3 shares cell 1's grid)."""
    p, cfg, track = VehicleParams(), MPCConfig(N=20), racetrack(device="cpu")
    scen = make_scenario_grid(p, cfg, n_ey=2, n_mu=2, ey_span=0.1, vx0=1.5, device="cpu")
    B, p_nom, sig = scen.batch, p.replace(mu=0.85), torch.tensor(SIGMA)
    x0r = torch.zeros((B, 6))
    x0r[:, 0], x0r[:, 4] = 1.5, torch.arange(B) * (float(track.length) / B)
    return types.SimpleNamespace(
        p=p, cfg=cfg, track=track, x_ref=constant_refs(cfg, 1.8, device="cpu"), scfg=BENCH, scen=scen,
        prm=megastep_params(scen.params, B, device="cpu"),
        scfg_admm=SolverConfig(max_iter=20, rho_interval=0, backend="admm", polish=False,
                               certify_infeasibility=False),
        rcfg=MPCConfig(N=20, model="dynamic", tire="pacejka"), rprm=megastep_params(p_nom, B, device="cpu"),
        table=initial_table(track, ds=0.05, vx0=1.5), x0r=x0r, mu_b=torch.linspace(0.5, 1.2, B), p_nom=p_nom,
        sig=sig, ekq=torch.tensor(DEFAULT_EKF_Q), ekr=sig ** 2, bscen=scen,
        fused_fixed=SolverConfig(max_iter=20, rho_interval=0, backend="fused", early_exit=False, check_termination=2,
                                 certify_infeasibility=False))


def _first_step(cs, rung, c):
    """One step of the rung's route from the cell's first state as
    chip_smoke.py's [oracle] drives it (the wrappers take their plain
    versions on CPU tensors): (what oracle_plain_of replays step 0 from,
    u0 (B, 2), converged (B,))."""
    if rung in ("c", "e-admm"):
        car = megastep_init(c.scen.params, c.cfg, c.track, c.scen.x0)
        if rung == "c":
            _, u0, dg = megastep(c.cfg, c.scfg, c.track, c.prm, c.x_ref, car, n_sub=4)
            return car, u0.T, dg[2] > 0.5
        xs, ca = car.x.T.contiguous(), cs.carry_lanes(car, slice(None))
        u, _, dg = mpc_step_batched(c.scen.params, c.cfg, c.scfg_admm, c.track, xs, c.x_ref, ca)
        return (xs, ca), u, dg.converged
    if rung == "d":
        rcar = racestep_init(c.p, c.rcfg, c.track, c.x0r, 0.85)
        noise = c.sig[:, None] * torch.randn((6, c.scen.batch), generator=torch.Generator().manual_seed(1))
        _, u0, dg, _ = racestep(c.rcfg, c.scfg, c.track, c.rprm, c.table, rcar, noise, c.mu_b, c.ekq, c.ekr,
                                **cs.RACE_KW)
        return (rcar, noise), u0.T, dg[2] > 0.5
    fcar = mpc_init(c.bscen.params, c.cfg, c.track, c.bscen.x0)
    u, _, d = mpc_step_batched(c.bscen.params, c.cfg, c.fused_fixed, c.track, c.bscen.x0, c.x_ref, fcar)
    return (c.bscen.x0, fcar), u, d.converged


@pytest.mark.parametrize("rung", ["c", "d", "e-fused", "e-admm"])
def test_chip_smoke_oracle_over_bound_branch(rung, capsys):
    """chip_smoke.py's oracle_gate on lanes 0 and B-1 of the rung's first
    step, with oracle answers set 1e-3 from the route's u0: the plain version
    from the saved carry is (B, 2) by global lane and 1e-3 off too, so each
    lane gets the bound max(5e-4, 1e-3 + 2e-4) and passes. With the oracle
    1e-5 from plain and the last lane's kernel u0 moved by 1e-3, the gate
    fails as a kernel fault."""
    cs, c = _chip_smoke(), _cells_cpu()
    B = c.scen.batch
    carry0, u, conv = _first_step(cs, rung, c)
    plain_of = cs.oracle_plain_of(rung, c, {0: carry0})
    u_plain = plain_of(0)
    assert u_plain.shape == (B, 2)
    lanes = [0, B - 1]
    assert all(bool(conv[b]) for b in lanes)
    rows = [(0, b, u[b].double().numpy(), True) for b in lanes]

    s = cs.oracle_gate(rung, rows, [(r[2] + 1e-3, True, False, 70, None) for r in rows], plain_of)
    assert [a["lane"] for a in s["algorithmic_lanes"]] == lanes
    for a in s["algorithmic_lanes"]:
        assert abs(a["du"] - 1e-3) < 1e-9 and abs(a["du_plain"] - 1e-3) < 1e-6
        assert a["bound"] == max(cs.ORACLE_TOL, a["du_plain"] + cs.ORACLE_KERNEL_TOL)

    out = [(u_plain[b].double().numpy() + 1e-5, True, False, 70, None) for b in lanes]
    rows[-1] = (0, B - 1, rows[-1][2] + 1e-3, True)
    with pytest.raises(SystemExit):
        cs.oracle_gate(rung, rows, out, plain_of)
    assert f"step 0 lane {B - 1}: the plain version is within" in capsys.readouterr().err


@pytest.mark.slow
def test_headline_oval_lap_plain_megastep():
    """tests/test_headline_oracle.py on the port: one oval lap at N=12, T=210."""
    track = oval_track(device="cpu")
    worst, checks, s_end = _megastep_rung(12, track, constant_refs(MPCConfig(N=12), 1.5, device="cpu"), 210)
    print(f"oracle headline lap, plain megastep N=12 oval: max |du| {worst:.3e} over {checks} checks")
    assert s_end > float(track.length)
    assert checks >= 40 and worst < RUNG


@pytest.mark.slow
def test_racetrack_lap_plain_megastep_sinusoidal_table():
    track = racetrack(device="cpu")
    worst, checks, s_end = _megastep_rung(20, track, _sinusoidal_table(track), 1200, until_lap=True)
    print(f"oracle racetrack lap, plain megastep N=20, sinusoidal table: max |du| {worst:.3e} over {checks} checks")
    assert s_end > float(track.length)
    assert checks >= 40 and worst < RUNG

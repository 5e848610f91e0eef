"""The fused assembly + solve and the kinematic model of the port vs the JAX
package (CPU; the JAX fused and megastep kernels in interpret mode).

- ``mpc_prepare_light`` vs JAX: 1e-6.
- ``fused_solve_plain`` vs JAX ``fused_mpc_solve`` on the same prepared
  inputs (B=6, N=8, racetrack, a perturbed dual warm start): dynamic with
  linear and Pacejka tires and kinematic, fixed count and early exit. U and
  X 2e-4, r_prim 1e-4, done-at equal, rho 5% on lanes whose dual residual is
  above 1e-6 (the bounds of tests/test_torch_admm.py: below that the dual
  residual is float noise).
- Three closed-loop steps of ``mpc_step_batched(backend="fused")`` +
  ``plant_step`` vs JAX, dynamic and kinematic: u 2e-4, x 5e-4
  (tests/test_megastep.py).
- The kinematic ``megastep_plain`` vs the port's fused composition and vs
  the JAX kinematic megastep: u 2e-4, x and X_pred 5e-4.
- Early exit keeps done-at exact (test_cache_and_ee.py's semantics).
- The kinematic stage math vs JAX: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autonomous_racing_lpv_mpp_mpc_tpu.ops.fused_kernel as jfk
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_step_batched as jmpc_step_batched
from autonomous_racing_lpv_mpp_mpc_tpu.loop import plant_step as jplant_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop.mpc import mpc_prepare_light as jprepare_light
from autonomous_racing_lpv_mpp_mpc_tpu.ops import stage_math as jsm
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep as jmegastep
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_init as jmegastep_init
from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_params as jmegastep_params
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    MPCCarry, mpc_init, mpc_prepare_light, mpc_step_batched, plant_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    fused_mpc_solve, fused_solve_plain, megastep_init, megastep_params, megastep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import stage_math as psm

B, N = 6, 8
CPU = "cpu"
T = lambda a: convert.tensor(a, CPU)


def _jcfg(model, tire="linear", n=N):
    return JMPCConfig(N=n, model=model, tire=tire, weights=JMPCWeights.for_model(model))


def _x0(model, rng, b=B):
    """Lanes spread along the lap with offsets in e_y, e_psi and speed."""
    s_i, ey_i = jsm.model_s_ey(model)
    ep_i = 3 if model == "dynamic" else 1
    x0 = np.zeros((b, 6 if model == "dynamic" else 4), np.float32)
    x0[:, 0] = rng.uniform(1.0, 1.6, b)
    x0[:, s_i] = rng.uniform(0.0, 20.0, b)
    x0[:, ey_i] = rng.uniform(-0.15, 0.15, b)
    x0[:, ep_i] = rng.uniform(-0.1, 0.1, b)
    return x0


def _prepared(model, tire="linear", seed=0):
    """Prepared inputs of the first step: JAX's and the port's."""
    rng = np.random.default_rng(seed)
    jcfg, jt = _jcfg(model, tire), jrace()
    mu = rng.uniform(0.7, 1.0, B).astype(np.float32)
    p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (B,)), JVehicleParams()).replace(mu=jnp.asarray(mu))
    x0 = _x0(model, rng)
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, jcfg, jt, x))(p_b, jnp.asarray(x0))
    lam = rng.normal(0.0, 0.3, np.shape(carry.lam)).astype(np.float32)
    carry = carry._replace(lam=jnp.asarray(lam), rho=jnp.full((B,), 0.3, jnp.float32))
    x_ref = jconstant_refs(jcfg, 1.8)
    jins = jax.vmap(lambda pp, x, c: jprepare_light(pp, jcfg, jt, x, x_ref, c))(
        p_b, jnp.asarray(x0), carry)
    port = (convert.vehicle_params(p_b, CPU), convert.mpc_config(jcfg), convert.track(jt, CPU),
            T(x0), T(x_ref), convert.mpc_carry(carry, CPU))
    return jcfg, p_b, jins, carry, port


def _fused_args(ins, rho):
    Xs, Us, kap, xr, lb, ub, x0a, warm = ins
    return (Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], rho)


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_prepare_light_matches_jax(model):
    _, _, jins, _, (p, cfg, track, x0, x_ref, carry) = _prepared(model)
    pins = mpc_prepare_light(p, cfg, track, x0, x_ref, carry)
    flat = lambda ins: list(ins[:7]) + list(ins[7])
    for name, got, want in zip(("X_sched", "U_sched", "kappas", "x_ref", "lb", "ub", "x0a",
                                "s_w", "lam_w", "Xa_w", "U_w"), flat(pins), flat(jins)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early-exit"])
@pytest.mark.parametrize("model,tire", [("dynamic", "linear"), ("dynamic", "pacejka"),
                                        ("kinematic", "linear")])
def test_fused_plain_matches_jax(model, tire, early_exit):
    jcfg, p_b, jins, carry, (p, cfg, _, _, _, _) = _prepared(model, tire, seed=1)
    jscfg = JSolverConfig(max_iter=20, rho_interval=0, backend="fused", early_exit=early_exit,
                          check_termination=2)
    ref = jfk.fused_mpc_solve(jcfg, jscfg, p_b, *_fused_args(jins, carry.rho), interpret=True)
    args = [T(a) for a in _fused_args(jins, carry.rho)]
    sol = fused_mpc_solve(cfg, convert.solver_config(jscfg), p, *args)
    assert fused_mpc_solve.launches == 0     # CPU tensors never launch the kernel
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), atol=2e-4, rtol=0)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(ref.X), atol=2e-4, rtol=0)
    np.testing.assert_allclose(sol.r_prim.numpy(), np.asarray(ref.r_prim), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(ref.converged))
    live = np.asarray(ref.r_dual) > 1e-6
    np.testing.assert_allclose(sol.rho.numpy()[live], np.asarray(ref.rho)[live], rtol=0.05)


def _jax_composed(jcfg, p_b, x0, n_steps, monkeypatch):
    orig = jfk.fused_mpc_solve
    monkeypatch.setattr(jfk, "fused_mpc_solve", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jscfg = JSolverConfig(max_iter=15, rho_interval=0, backend="fused")
    jt, x_ref = jrace(), jconstant_refs(jcfg, 1.6)
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, jcfg, jt, x))(p_b, jnp.asarray(x0))
    xs, us, xh = jnp.asarray(x0), [], []
    for _ in range(n_steps):
        u, carry, _ = jmpc_step_batched(p_b, jcfg, jscfg, jt, xs, x_ref, carry)
        xs = jax.vmap(lambda pp, x, uu: jplant_step(pp, jcfg, jt, x, uu, n_sub=4))(p_b, xs, u)
        us.append(np.asarray(u))
        xh.append(np.asarray(xs))
    return jscfg, np.stack(us), np.stack(xh), carry


def _port_composed(jcfg, jscfg, p_b, x0, n_steps):
    p, cfg, track = convert.vehicle_params(p_b, CPU), convert.mpc_config(jcfg), convert.track(jrace(), CPU)
    scfg = convert.solver_config(jscfg).replace(certify_infeasibility=False)
    x_ref = T(jconstant_refs(jcfg, 1.6))
    x = T(x0)
    carry = mpc_init(p, cfg, track, x)
    us, xh = [], []
    for _ in range(n_steps):
        u, carry, _ = mpc_step_batched(p, cfg, scfg, track, x, x_ref, carry)
        x = plant_step(p, cfg, track, x, u, n_sub=4)
        us.append(u.numpy())
        xh.append(x.numpy())
    return np.stack(us), np.stack(xh), carry


def _closed_loop_case(model):
    p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (4,)), JVehicleParams())
    x0 = _x0(model, np.random.default_rng(3), b=4)
    return _jcfg(model), p_b, x0


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_fused_closed_loop_matches_jax(model, monkeypatch):
    jcfg, p_b, x0 = _closed_loop_case(model)
    jscfg, ju, jx, jc = _jax_composed(jcfg, p_b, x0, 3, monkeypatch)
    pu, px, pc = _port_composed(jcfg, jscfg, p_b, x0, 3)
    np.testing.assert_allclose(pu, ju, atol=2e-4, rtol=0)
    np.testing.assert_allclose(px, jx, atol=5e-4, rtol=0)
    np.testing.assert_allclose(pc.X_pred.numpy(), np.asarray(jc.X_pred), atol=5e-4, rtol=0)


def test_kinematic_megastep_matches_composed_and_jax():
    """BASELINE config 1's model on the megastep: 3 closed-loop steps of the
    port's kinematic megastep_plain == the port's fused composition, and ==
    the JAX kinematic megastep."""
    jcfg, p_b, x0 = _closed_loop_case("kinematic")
    jscfg = JSolverConfig(max_iter=15, rho_interval=0, backend="fused")
    cu, cx, cc = _port_composed(jcfg, jscfg, p_b, x0, 3)

    jt, x_ref = jrace(), jconstant_refs(jcfg, 1.6)
    jprm = jmegastep_params(p_b, 4)
    step = jax.jit(lambda c: jmegastep(jcfg, jscfg, jt, jprm, x_ref, c, n_sub=4, interpret=True))
    jc = jmegastep_init(p_b, jcfg, jt, jnp.asarray(x0))
    p, cfg, track = convert.vehicle_params(p_b, CPU), convert.mpc_config(jcfg), convert.track(jt, CPU)
    scfg = convert.solver_config(jscfg)
    mc = megastep_init(p, cfg, track, T(x0))
    assert tuple(mc.x.shape) == (4, 4)
    prm = megastep_params(p, 4, device=CPU)
    mu, mx, ju, jx = [], [], [], []
    for _ in range(3):
        mc, u0, _ = megastep_plain(cfg, scfg, track, prm, T(x_ref), mc)
        jc, ju0, _ = step(jc)
        mu.append(u0.T.numpy())
        mx.append(mc.x.T.numpy())
        ju.append(np.asarray(ju0).T)
        jx.append(np.asarray(jc.x).T)
    for ref_u, ref_x, ref_X in ((cu, cx, cc.X_pred.numpy()),
                                (np.stack(ju), np.stack(jx), np.moveaxis(np.asarray(jc.X_pred), -1, 0))):
        np.testing.assert_allclose(np.stack(mu), ref_u, atol=2e-4, rtol=0)
        np.testing.assert_allclose(np.stack(mx), ref_x, atol=5e-4, rtol=0)
        np.testing.assert_allclose(mc.X_pred.permute(2, 0, 1).numpy(), ref_X, atol=5e-4, rtol=0)


def test_fused_early_exit_semantics():
    """Early exit over chunks of 5 keeps done-at exact (the fused body tests
    termination after every iteration): the same done-at as the fixed
    count and as the JAX early exit, converged lanes, U within the
    termination tolerance (5e-3) of the fixed count, every lane done
    before max_iter."""
    jcfg = JMPCConfig(N=8, model="dynamic")
    jt, x_ref = jrace(), jconstant_refs(jcfg, 1.6)
    p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (4,)), JVehicleParams())
    x0 = np.tile(np.array([1.2, 0.0, 0.0, 0.0, 0.0, 0.05], np.float32), (4, 1))
    x0[:, 4] = [0.3, 2.7, 6.1, 9.4]
    carry = jax.vmap(lambda pp, x: jmpc_init(pp, jcfg, jt, x))(p_b, jnp.asarray(x0))
    jins = jax.vmap(lambda pp, x, c: jprepare_light(pp, jcfg, jt, x, x_ref, c))(
        p_b, jnp.asarray(x0), carry)
    fix = JSolverConfig(max_iter=40, rho_interval=0, backend="fused")
    ee = fix.replace(early_exit=True, check_termination=5)
    p, cfg = convert.vehicle_params(p_b, CPU), convert.mpc_config(jcfg)
    args = [T(a) for a in _fused_args(jins, carry.rho)]
    sol_fix = fused_solve_plain(cfg, convert.solver_config(fix), p, *args)
    sol_ee = fused_solve_plain(cfg, convert.solver_config(ee), p, *args)
    ref_ee = jfk.fused_mpc_solve(jcfg, ee, p_b, *_fused_args(jins, carry.rho), interpret=True)
    assert bool(sol_fix.converged.all()) and bool(sol_ee.converged.all())
    np.testing.assert_array_equal(sol_ee.iters.numpy(), sol_fix.iters.numpy())
    np.testing.assert_array_equal(sol_ee.iters.numpy(), np.asarray(ref_ee.iters))
    np.testing.assert_allclose(sol_ee.U.numpy(), sol_fix.U.numpy(), atol=5e-3, rtol=0)
    np.testing.assert_allclose(sol_ee.U.numpy(), np.asarray(ref_ee.U), atol=2e-4, rtol=0)
    assert int(sol_ee.iters.max()) < 40


def test_kinematic_stage_math_matches_jax():
    rng = np.random.default_rng(5)
    n = 64
    x = np.stack([rng.uniform(0.02, 3.5, n), rng.uniform(-0.5, 0.5, n), rng.uniform(0.0, 40.0, n),
                  rng.uniform(-0.45, 0.45, n)]).astype(np.float32)
    u = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-2.0, 3.0, n)]).astype(np.float32)
    kap = rng.choice([-1.0, 0.0, 0.77, 1.3], n).astype(np.float32)
    prm = np.tile(np.array([2.424, 0.02, 0.125, 0.125, 57.5, 67.5, 1.0, 9.81, 0.05, 0.1],
                           np.float32)[:, None], (1, n))
    prm[6] = rng.uniform(0.5, 1.2, n)
    jpv, ppv = jsm.unpack_params(jnp.asarray(prm)), psm.unpack_params(torch.tensor(prm))
    na = jsm.KIN_NA
    sel = np.zeros((na, 2), np.float32)
    sel[4, 0] = sel[5, 1] = 1.0
    jA, jB = jsm.stage_aug_ab(jnp.asarray(x), jnp.asarray(u), jnp.asarray(kap), jpv,
                              jnp.eye(na, dtype=jnp.float32)[:, :, None], jnp.eye(2, dtype=jnp.float32),
                              jnp.asarray(sel), dt=1.0 / 30.0, tire="linear", model="kinematic")
    pA, pB = psm.stage_aug_ab(torch.tensor(x), torch.tensor(u), torch.tensor(kap), ppv,
                              dt=1.0 / 30.0, tire="linear", model="kinematic")
    np.testing.assert_allclose(pA.numpy(), np.asarray(jA), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pB.numpy(), np.asarray(jB), atol=1e-6, rtol=0)
    jf = jsm.f_kinematic_bl(jpv, jnp.asarray(x), jnp.asarray(u), jnp.asarray(kap))
    pf = psm.f_model_bl("kinematic", ppv, torch.tensor(x), torch.tensor(u), torch.tensor(kap), "linear")
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=1e-6, rtol=1e-6)
    assert psm.model_dims("kinematic") == (4, 6) and psm.model_s_ey("kinematic") == (2, 3)


def test_fused_backend_converts_and_rejects_unported_options():
    """The JAX "fused" backend maps to the port's. With SolverConfig's
    defaults (certificate on) the fused path runs and certifies nothing, as
    the JAX fused route, which hands no assembled QP to the certificate;
    with polish it polishes the kernel's solution on the re-assembled QP."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import mpc_prepare
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import polish_solution

    _, _, _, _, (p, cfg, track, x0, x_ref, carry) = _prepared("dynamic")
    scfg = convert.solver_config(JSolverConfig(backend="fused"))
    assert scfg.backend == "fused" and scfg.certify_infeasibility and not scfg.polish
    u, new, diag = mpc_step_batched(p, cfg, scfg, track, x0, x_ref, carry)
    assert isinstance(new, MPCCarry) and u.shape == (B, 2) and bool(torch.isfinite(u).all())
    assert diag.iters.dtype == torch.int32 and not bool(diag.certified_infeasible.any())
    pscfg = scfg.replace(polish=True)
    up, _, diagp = mpc_step_batched(p, cfg, pscfg, track, x0, x_ref, carry)
    ins = mpc_prepare_light(p, cfg, track, x0, x_ref, carry)
    sol = polish_solution(mpc_prepare(p, cfg, track, x0, x_ref, carry)[0], pscfg,
                          fused_mpc_solve(cfg, pscfg, p, *_fused_args(ins, carry.rho)))
    usable = sol.converged | ((sol.r_prim < scfg.eps_fallback) & (sol.r_dual < scfg.eps_fallback))
    assert bool(usable.all())
    assert torch.equal(up, sol.U[:, 0]) and torch.equal(diagp.r_prim, sol.r_prim)


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_launch_shape_fits_a_block(model):
    """The group kernels' launch shape (fused, racestep): the ADMM operands
    of a block's lanes stay in shared memory within what one H100 block may
    hold for every horizon the main paths and the tests use (N up to 40),
    in the count of group_core.cuh's OpsLayout; a long horizon (N=60, or 80
    for the smaller kinematic stage) takes the device-memory layout. A vote
    group of 128 lanes is one cluster. Three blocks share an H100 SM's
    233,472 B (each its dynamic shared memory, the traced instantiation's
    static section counters and the 1,024 B the card reserves per block)
    at the dynamic model's N=14 and the kinematic N=10, not at the dynamic
    N=20 or the kinematic N=28."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_kernel as fk
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import profiling

    src = (_cuda.CSRC / "group_core.cuh").read_text()
    assert src.split("struct OpsLayout")[1].split("total = o;")[0].count("o +=") == 9
    # per stage: Ad (the pattern's 4 or 2 computed columns), Bd, Hux (nx
    # columns), Hiv, d, qt, rt, X, U; qt and X have one more row
    per_stage, extra = {"dynamic": (24 + 12 + 12 + 4 + 2 + 8 + 2 + 8 + 2, 16),
                        "kinematic": (8 + 8 + 8 + 4 + 2 + 6 + 2 + 6 + 2, 12)}[model]
    # the shape the kernels are built for (csrc/arl_sync.cuh)
    sync = (_cuda.CSRC / "arl_sync.cuh").read_text()
    assert f"LANE_THREADS = {fk.THREADS_PER_LANE};" in sync
    assert f"BLOCK_LANES = {fk.LANES_PER_BLOCK};" in sync
    assert fk.THREADS_PER_LANE * fk.LANES_PER_BLOCK <= 128
    for n in range(1, 41):
        sh = fk.launch_shape(n, model)
        assert fk.ops_floats(n, model) == per_stage * n + extra
        assert sh.ops_in_smem and sh.smem_bytes == fk.LANES_PER_BLOCK * 4 * fk.ops_floats(n, model)
        assert 0 < sh.smem_bytes <= 232_448 - fk.STATIC_SMEM
        assert sh.cluster * fk.LANES_PER_BLOCK == fk.GROUP and sh.cluster <= 8
        assert sh.ints() == [1, sh.smem_bytes]
    long = fk.launch_shape({"dynamic": 60, "kinematic": 80}[model], model)
    assert not long.ops_in_smem and long.smem_bytes == 0 and long.ints() == [0, 0]
    # group_core.cuh's SecBlock: a 32-bit slot per lane and section, and a count
    sec_block = fk.LANES_PER_BLOCK * len(profiling.SECTIONS) * 4 + 4
    three = lambda n: 3 * (fk.launch_shape(n, model).smem_bytes + sec_block + 1_024) <= 233_472
    fits3 = {"dynamic": {14: True, 20: False}, "kinematic": {10: True, 28: False}}[model]
    assert {n: three(n) for n in fits3} == fits3

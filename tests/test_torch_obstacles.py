"""The port's obstacle path vs the JAX package on the CPU: opponent blocks,
obstacle corridors in the tracker's bounds, the closed loop around parked
obstacles and the megastep's corridor operand. (The composed runner with
per-lane tables and moving blocks is held against JAX's in
tests/test_torch_race.py.)

Inputs are made with numpy from a seed and handed to both sides.
Tolerances:

- corridors, block curvatures, tracker bounds and QP assembly with
  obstacles: 1e-6 (elementwise functions, as tests/test_torch_components.py);
- blocks and traces: exact (the same float32 arithmetic);
- ``closed_loop(obstacles=)``: 2e-4 over 20 steps, and the megastep's plain
  version with the corridor operand against the JAX ``mpc_step(obstacles=)``
  + ``plant_step`` chain: 2e-4 over 3 steps (tests/test_racestep.py's
  bound for the same chain).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.engine import assembly as jasm
from autonomous_racing_lpv_mpp_mpc_tpu.loop import closed_loop as jclosed_loop
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_init as jmpc_init
from autonomous_racing_lpv_mpp_mpc_tpu.loop import mpc_step as jmpc_step
from autonomous_racing_lpv_mpp_mpc_tpu.loop import plant_step as jplant_step
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import assembly as tasm
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import closed_loop, constant_refs, corridor_eyb
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep, megastep_init, megastep_params, megastep_plain

# the packages' ``opponents`` names the constructor; the modules by path
jopp = importlib.import_module("autonomous_racing_lpv_mpp_mpc_tpu.planner.opponents")
topp = importlib.import_module("autonomous_racing_lpv_mpp_mpc_tpu_torch.planner.opponents")

ELEM = dict(atol=1e-6, rtol=1e-6)
T = lambda a: torch.tensor(np.asarray(a, np.float32))
DUMMY = jopp.DUMMY_BLOCK

# Block sets on the racetrack, each padded to 5 rows with dummy rows (L 31.73 m, e_y within +-0.4; curvature +1.0
# on [1.0, 2.6], -1.0 on [2.6, 5.7], 0 on [7.3, 9.3], 0.77 on [9.3, 11.3]).
BLOCKS = {
    # two blocks among inert padding rows
    "dummy rows": [[1.0, 2.2, -0.25, 0.1], DUMMY, [6.0, 7.0, -0.1, 0.3], DUMMY, DUMMY],
    # overlapping blocks whose widest usable sides are opposite: the
    # corridor inverts on the overlap and collapses to its midpoint
    "opposite overlap": [[3.0, 4.5, -0.3, 0.05], [3.5, 5.0, -0.05, 0.3]],
    # blocks reaching past the track edge on either side
    "track edge": [[8.0, 9.0, 0.2, 0.45], [9.5, 11.0, -0.5, 0.35]],
    # a centred block in the kappa = 1 corner (the inside is not steerable,
    # so the corridor takes the outside) and one split at the finish line
    "sharp corner": [[1.2, 2.2, -0.1, 0.1], [31.0, 31.734512, -0.2, 0.0], [0.0, 0.6, -0.2, 0.0]],
}


def _sched(track, n_lanes, N, seed):
    """Scheduled states (B, N+1, 6) whose s sweep the whole lap, e_y and
    speed from a seed."""
    rng = np.random.default_rng(seed)
    L = float(track.length)
    X = np.zeros((n_lanes, N + 1, 6), np.float32)
    s0 = np.linspace(0.0, L, n_lanes, endpoint=False, dtype=np.float32)
    X[..., 4] = s0[:, None] + 0.05 * np.arange(N + 1, dtype=np.float32)[None]
    X[..., 0] = rng.uniform(0.8, 2.0, (n_lanes, N + 1))
    X[..., 5] = rng.uniform(-0.2, 0.2, (n_lanes, N + 1))
    return X


@functools.cache
def _jax_side():
    """The JAX racetrack, config and jitted batch forms of the tracker
    bounds (per obstacle margin) and the QP assembly, shared by the cases."""
    jt, jcfg = jrace(), JMPCConfig(N=8)
    bounds = {m: jax.jit(jax.vmap(lambda pp, Xs, blk, m=m: jasm.tracker_bounds(pp, jcfg, jt, Xs, obstacles=blk,
                                                                              obs_margin=m), (0, 0, None)))
              for m in (0.0, 0.05)}
    boxqp = jax.jit(jax.vmap(lambda pp, x, up, Xs, Us, xr, blk: jasm.build_boxqp(pp, jcfg, jt, x, up, Xs, Us, xr,
                                                                                 obstacles=blk),
                             (0, 0, 0, 0, 0, None, None)))
    return jt, jcfg, bounds, boxqp


@pytest.mark.parametrize("case", list(BLOCKS))
def test_corridor_and_bounds_match_jax(case):
    jt, jcfg, jbounds, jboxqp = _jax_side()
    jp = JVehicleParams()
    tt, cfg = convert.track(jt, device="cpu"), convert.mpc_config(jcfg)
    blocks = topp.pad_blocks(BLOCKS[case], 5)          # one shape: one JAX compile for all cases
    half = jcfg.bounds.ey_max

    # the block curvatures and the steerable cap
    jkb = jasm.block_curvatures(jt, jnp.asarray(blocks))
    tkb = tasm.block_curvatures(tt, T(blocks))
    np.testing.assert_array_equal(tkb.numpy(), np.asarray(jkb))
    jkc = jasm.steerable_curvature(jp, jcfg.bounds.delta_max)
    tkc = tasm.steerable_curvature(convert.vehicle_params(jp, device="cpu"), cfg.bounds.delta_max)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **ELEM)

    # the corridor along the whole lap, with and without the curvature rule
    sm = np.linspace(0.0, float(jt.length), 4000, endpoint=False, dtype=np.float32).reshape(8, 500)
    lo0, hi0 = np.full_like(sm, -half), np.full_like(sm, half)
    for kw_j, kw_t in (({}, {}), (dict(kappa_blk=jkb, kappa_cap=jkc), dict(kappa_blk=tkb, kappa_cap=tkc))):
        jlo, jhi = jasm.corridor_from_blocks(jnp.asarray(sm), jnp.asarray(lo0), jnp.asarray(hi0),
                                             jnp.asarray(blocks), 0.05, half, **kw_j)
        tlo, thi = tasm.corridor_from_blocks(T(sm), T(lo0), T(hi0), T(blocks), 0.05, half, **kw_t)
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), **ELEM)
        np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), **ELEM)
    assert (tlo.numpy() > -half).any() or (thi.numpy() < half).any()      # the blocks bound
    if case == "opposite overlap":
        assert (tlo.numpy() == thi.numpy()).any()                           # collapsed to the midpoint

    # the tracker's stage bounds with obstacles (per-lane vehicle params)
    n_lanes = 6
    jp_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_lanes,) + jnp.shape(a)), jp)
    X = _sched(jt, n_lanes, jcfg.N, seed=0)
    p_b = convert.vehicle_params(jp_b, device="cpu")
    for margin in (0.0, 0.05):
        jlb, jub = jbounds[margin](jp_b, X, blocks)
        tlb, tub = tasm.tracker_bounds(p_b, cfg, tt, T(X), obstacles=blocks, obs_margin=margin)
        np.testing.assert_allclose(tlb.numpy(), np.asarray(jlb), **ELEM)
        np.testing.assert_allclose(tub.numpy(), np.asarray(jub), **ELEM)

    # the assembled QP with obstacles
    U = np.random.default_rng(1).uniform(-0.2, 0.2, (n_lanes, jcfg.N, 2)).astype(np.float32)
    x0, u_prev = X[:, 0], U[:, 0]
    xr = jconstant_refs(jcfg, 1.8)
    jqp = jboxqp(jp_b, x0, u_prev, X, U, xr, blocks)
    tqp = tasm.build_boxqp(p_b, cfg, tt, T(x0), T(u_prev), T(X), T(U), T(xr), obstacles=T(blocks))
    for name in ("lb", "ub"):
        np.testing.assert_allclose(getattr(tqp, name).numpy(), np.asarray(getattr(jqp, name)), **ELEM)
    np.testing.assert_allclose(tqp.cost.q.numpy(), np.asarray(jqp.cost.q), **ELEM)


def _opponents():
    """A slow car, a fast one about to cross the finish line, a reversing
    one and one fast enough to sweep the whole lap of the oval."""
    return dict(s0=[1.0, 9.9, 5.0, 2.0], e_y=[0.1, -0.15, 0.0, 0.2], v=[0.8, 1.5, -0.7, 120.0])


def test_sweep_and_pad_blocks_match_jax():
    jt = joval()
    tt = convert.track(jt, device="cpu")
    kw = _opponents()
    jo, to = jopp.opponents(**kw), topp.opponents(**kw, device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(to)["v"], np.asarray(jo.v))
    for t0, t1 in ((0.0, 0.5), (3.0, 5.3), (12.0, 12.1)):
        np.testing.assert_array_equal(topp.opponent_s_at(tt, to, t0).numpy(),
                                      np.asarray(jopp.opponent_s_at(jt, jo, t0)))
        jb = jopp.sweep_blocks(jt, jo, t0, t1, ego_length=0.3, ego_width=0.15)
        tb = topp.sweep_blocks(tt, to, t0, t1, ego_length=0.3, ego_width=0.15)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(topp.pad_blocks(tb, 8), jopp.pad_blocks(jb, 8))
    # the last sweep holds a wrap split (the first car), the whole lap (the
    # fastest) and the reversing car's own arc, not its complement
    L = np.float32(jt.length)
    centre = lambda ey: tb[np.isclose(0.5 * (tb[:, 2] + tb[:, 3]), ey)]
    split, lap, rev = centre(0.1), centre(0.2), centre(0.0)
    assert tb.shape[0] == 5
    assert split.shape[0] == 2 and split[0, 1] == L and split[1, 0] == 0.0
    assert lap.shape[0] == 1 and lap[0, 0] == 0.0 and lap[0, 1] == L
    assert rev.shape[0] == 1 and 0.0 < rev[0, 1] - rev[0, 0] < 1.0
    np.testing.assert_array_equal(topp.pad_blocks(None, 3), jopp.pad_blocks(None, 3))
    with pytest.raises(ValueError, match="exceed"):
        topp.pad_blocks(tb, 2)
    jfn = jopp.opponents_obstacle_fn(jt, jo, 1.0 / 30.0, 60)
    tfn = topp.opponents_obstacle_fn(tt, to, 1.0 / 30.0, 60)
    for step in (0, 60, 420):
        np.testing.assert_array_equal(tfn(step), np.asarray(jfn(step)))
    empty = topp.opponents([], [], [], device="cpu")
    assert topp.opponents_obstacle_fn(tt, empty, 0.1, 10)(0) is None


def test_collision_and_gap_traces_match_jax():
    jt = joval()
    tt = convert.track(jt, device="cpu")
    kw = _opponents()
    jo, to = jopp.opponents(**kw), topp.opponents(**kw, device="cpu")
    rng = np.random.default_rng(2)
    X = np.zeros((3, 40, 6), np.float32)
    X[..., 4] = np.cumsum(rng.uniform(0.0, 0.1, (3, 40)), axis=1) + np.array([0.6, 9.5, 4.8])[:, None]
    X[..., 5] = rng.uniform(-0.3, 0.3, (3, 40))
    dt = 1.0 / 30.0
    jc = jax.vmap(lambda x: jopp.collision_trace(jt, jo, x, dt))(X)
    jg = jax.vmap(lambda x: jopp.min_gap_trace(jt, jo, x, dt))(X)
    tc = topp.collision_trace(tt, to, T(X), dt)
    tg = topp.min_gap_trace(tt, to, T(X), dt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tc.any() and not tc.all()
    np.testing.assert_array_equal(topp.collision_trace(tt, to, T(X[0]), dt).numpy(), np.asarray(jc[0]))


def test_closed_loop_with_obstacles_matches_jax():
    """Two cars spawned behind a parked block on a straight, 20 steps: the
    block steers them up to pass above it.
    (The corridor makes the first solves harder: at 20 iterations without
    rho adaptation they stop unconverged and the step keeps its warm
    start, so the solver gets 40 with adaptation.)"""
    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8), jrace()
    jscfg = JSolverConfig(max_iter=40)
    blocks = np.asarray([[7.6, 8.6, -0.3, 0.05], DUMMY], np.float32)
    x0 = np.array([[1.3, 0.0, 0.0, 0.0, 7.3, 0.0], [1.3, 0.0, 0.0, 0.0, 7.2, -0.1]], np.float32)
    jlog = jax.jit(jax.vmap(lambda x: jclosed_loop(jp, jcfg, jscfg, jt, x, jconstant_refs(jcfg, 1.6), T=20,
                                                   n_sub=4, obstacles=jnp.asarray(blocks))))(jnp.asarray(x0))
    cfg, tt = convert.mpc_config(jcfg), convert.track(jt, device="cpu")
    scfg = convert.solver_config(jscfg).replace(certify_infeasibility=False)
    log = closed_loop(VehicleParams(), cfg, scfg, tt, T(x0), constant_refs(cfg, 1.6, device="cpu"), T=20, n_sub=4,
                      obstacles=blocks)
    np.testing.assert_allclose(log.U.numpy(), np.asarray(jlog.U).swapaxes(0, 1), atol=2e-4, rtol=0)
    np.testing.assert_allclose(log.X.numpy(), np.asarray(jlog.X).swapaxes(0, 1), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(log.converged.numpy(), np.asarray(jlog.converged).T)
    # on the straight, with no lateral reference, the first car would hold
    # e_y = 0 exactly without the block
    assert float(log.X[-1, 0, 5]) > 2e-2 and (log.X[-1, :, 4] > 7.9).all()


def test_megastep_corridor_matches_jax_mpc_step():
    """The corridor operand on the fast path: the megastep's plain version
    with per-stage e_y bounds from ``corridor_from_blocks`` equals the JAX
    tracker (``mpc_step(obstacles=)``) + plant chain step for step, and
    the corridor binds (the JAX package's megastep-vs-XLA corridor test)."""
    n_lanes = 3
    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8, model="dynamic"), jrace()
    jscfg = JSolverConfig(max_iter=15, rho_interval=0)
    xr = jconstant_refs(jcfg, 1.5)
    blocks = np.asarray([[1.0, 2.2, -0.25, 0.1], [6.0, 7.0, -0.1, 0.3]], np.float32)
    x0 = np.zeros((n_lanes, 6), np.float32)
    x0[:, 0] = 1.3
    x0[:, 4] = [0.2, 1.5, 5.4]

    step = jax.jit(jax.vmap(lambda x, c: jmpc_step(jp, jcfg, jscfg, jt, x, xr, c, obstacles=jnp.asarray(blocks))))
    plant = jax.jit(jax.vmap(lambda x, u: jplant_step(jp, jcfg, jt, x, u, n_sub=4)))
    carry = jax.vmap(lambda x: jmpc_init(jp, jcfg, jt, x))(jnp.asarray(x0))
    xs, us_ref, xs_ref = jnp.asarray(x0), [], []
    for _ in range(3):
        u, carry, _ = step(xs, carry)
        xs = plant(xs, u)
        us_ref.append(np.asarray(u))
        xs_ref.append(np.asarray(xs))

    p, cfg, tt = VehicleParams(), convert.mpc_config(jcfg), convert.track(jt, device="cpu")
    scfg = convert.solver_config(jscfg)
    eyb_of = corridor_eyb(p, cfg, tt, blocks, device="cpu")
    prm = megastep_params(p, n_lanes, device="cpu")
    mc = megastep_init(p, cfg, tt, T(x0))
    x_ref = T(xr)
    for k in range(3):
        mc, u0, _ = megastep(cfg, scfg, tt, prm, x_ref, mc, n_sub=4, eyb=eyb_of(mc.x[4], mc.X_pred[:, 4]))
        np.testing.assert_allclose(u0.numpy().T, us_ref[k], atol=2e-4, rtol=0)
        np.testing.assert_allclose(mc.x.numpy().T, xs_ref[k], atol=2e-4, rtol=0)
    # the corridor bound: the lane spawned before block 0 is steered above
    # its band, which the run without a corridor is not
    assert float(mc.x[5, 1]) > -0.05
    free = megastep_init(p, cfg, tt, T(x0))
    for _ in range(3):
        free, _, _ = megastep_plain(cfg, scfg, tt, prm, x_ref, free, n_sub=4)
    assert (free.x - mc.x).abs().max() > 1e-3
    assert megastep.launches == 0

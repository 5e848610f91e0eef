"""Port hygiene and the kernel-vs-plain tests that need an NVIDIA GPU.

- Importing every module of the port leaves no JAX in the process.
- The wrappers route by device: CPU tensors to the plain version, CUDA
  tensors to the kernel, anything else raises; without a card, asking for
  the kernels or for CUDA tensors raises, and CPU calls count no launches.
- Tests marked ``cuda`` hold each kernel against its plain version on the
  card (tolerances of chip_smoke.py); without a card they skip. This file
  imports no JAX, so it runs on a machine with a card and no JAX.
"""

import contextlib
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import (
    MPCConfig, MPCWeights, SolverConfig, VehicleParams,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    DEFAULT_EKF_Q, constant_refs, corridor_eyb, initial_table, mpc_init, mpc_prepare, mpc_prepare_light,
    mpc_step_batched, plant_step,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import admm_kernel as ak
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep_kernel as mk
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import racestep_kernel as rk
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import admm_kernel_solve, admm_solve_plain
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import (
    core_workspace, fused_mpc_solve, fused_solve_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
    MegaCarry, megastep, megastep_init, megastep_params, megastep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.racestep_kernel import (
    RaceMegaCarry, racestep, racestep_init, racestep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import RefTable, pad_blocks
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack

PKG = "autonomous_racing_lpv_mpp_mpc_tpu_torch"
_SIGMA = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
_EKF_Q = np.asarray(DEFAULT_EKF_Q, np.float32)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'autonomous_racing_lpv_mpp_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20        # every module was imported


def _small_case(device="cpu", N=8, n_ey=4, n_mu=2):
    p, cfg = VehicleParams(), MPCConfig(N=N)
    track = racetrack(device=device)
    scen = make_scenario_grid(p, cfg, n_ey=n_ey, n_mu=n_mu, vx0=1.5, device=device)
    x_ref = constant_refs(cfg, 1.8, device=device)
    return p, cfg, track, scen, x_ref


def test_wrappers_route_by_device():
    p, cfg, track, scen, x_ref = _small_case()
    carry = mpc_init(scen.params, cfg, track, scen.x0)
    qp, warm, _ = mpc_prepare(scen.params, cfg, track, scen.x0, x_ref, carry)
    scfg = SolverConfig(max_iter=10, rho_interval=0)
    admm_kernel_solve(qp, scfg, warm, carry.rho)
    mc = megastep_init(scen.params, cfg, track, scen.x0)
    prm = megastep_params(scen.params, scen.batch, device="cpu")
    megastep(cfg, scfg, track, prm, x_ref, mc)
    assert admm_kernel_solve.launches == 0 and megastep.launches == 0

    meta = lambda t: torch.empty_like(t, device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        admm_kernel_solve(qp._replace(x0=meta(qp.x0)), scfg)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        megastep(cfg, scfg, track, prm, x_ref, MegaCarry(*(meta(t) for t in mc)))
    # the discretization cache: cache_build without a MegaCache raises; with
    # one the CPU call returns the new cache and counts no launch
    scfg_c = scfg.replace(cache_build=True)
    with pytest.raises(ValueError, match="MegaCache"):
        megastep(cfg, scfg_c, track, prm, x_ref, mc)
    out = megastep(cfg, scfg_c, track, prm, x_ref, mc, cache=mk.megacache_init(cfg, scfg_c, scen.batch, "cpu"))
    assert len(out) == 4 and isinstance(out[3], mk.MegaCache) and megastep.cached_launches == 0
    # the e_y corridor operand: the box's own bounds change nothing, a
    # narrower corridor does, and a misshapen one raises
    box = torch.tensor([-cfg.bounds.ey_max, cfg.bounds.ey_max]).reshape(1, 2, 1)
    box = box.expand(cfg.N + 1, 2, scen.batch).contiguous()
    c0, u0, _ = megastep(cfg, scfg, track, prm, x_ref, mc)
    c1, u1, _ = megastep(cfg, scfg, track, prm, x_ref, mc, eyb=box)
    c2, u2, _ = megastep(cfg, scfg, track, prm, x_ref, mc, eyb=0.1 * box)
    assert torch.equal(u0, u1) and torch.equal(c0.x, c1.x) and torch.equal(c0.s, c1.s)
    assert (u0 - u2).abs().max() > 1e-3
    with pytest.raises(ValueError, match="eyb has shape"):
        megastep(cfg, scfg, track, prm, x_ref, mc, eyb=box[:-1])
    assert megastep.launches == 0


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        racetrack(device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        make_scenario_grid(VehicleParams(), MPCConfig(), device="cuda")
    # the default device is the card: without one, the constructors raise
    for make in (racetrack, lambda: make_scenario_grid(VehicleParams(), MPCConfig()),
                 lambda: constant_refs(MPCConfig(), 1.5),
                 lambda: megastep_params(VehicleParams(), 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    _cuda.library.cache_clear()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cuda.library()
    assert admm_kernel_solve.launches == 0 and megastep.launches == 0


def test_kernel_sources_and_workspace_layout():
    """The library name follows the sources' content; the tracker core's
    workspace formula matches the per-lane layout of its CUDA source
    (mpc_core.cuh, shared by the megastep, the racestep and the fused
    kernel)."""
    names = {p.name for p in _cuda._sources()}
    assert {"arl_common.cuh", "mpc_core.cuh", "admm_kernel.cu", "megastep_kernel.cu",
            "racestep_kernel.cu", "fused_kernel.cu"} <= names
    assert len(_cuda.source_hash()) == 16
    src = (_cuda.CSRC / "mpc_core.cuh").read_text()
    terms = src.split("struct WsLayout")[1].split("total = o;")[0].count("o +=")
    assert terms == 14
    # per stage: Xs 6, Us 2, kap 1, lb/ub 12, Ad 24 (the pattern's 4 computed
    # columns), Bd 12, q0 6, K 16, Hiv 4, Hux 16, d 2, Xsol 8, Usol 2; the
    # N+1-row arrays add one more row
    for N in (1, 8, 12, 20):
        assert core_workspace(N) == 111 * N + (6 + 1 + 12 + 6 + 8)
        # kinematic: Xs 4, Us 2, kap 1, lb/ub 12, Ad 8 (2 columns), Bd 8, q0 4,
        # K 12, Hiv 4, Hux 12, d 2, Xsol 6, Usol 2 per stage
        assert core_workspace(N, "kinematic") == 77 * N + (4 + 1 + 12 + 4 + 6)


def test_admm_launch_shape_from_N_and_na():
    """The solver-only kernel's layout: the most QPs per block (16 at most)
    whose operand slices fit in a block's shared memory, else 16 QPs per
    block with the operands in device memory; the slice size matches the
    per-QP layout of its CUDA source (AdmmLayout)."""
    src = (_cuda.CSRC / "admm_kernel.cu").read_text()
    assert src.split("struct AdmmLayout")[1].split("total = o;")[0].count("o +=") == 13
    # per stage: A 64, B 16, c 8, r 2, Hux 16, Hiv 4, Vc 8, d 2, rt 2, U 2;
    # q, qt, X 8 each on N+1 stages (na=8); na=6: 36, 12, 6, 2, 12, 4, 6, 2, 2, 2
    assert ak.admm_ops_floats(20, 8) == 124 * 20 + 24 * 21
    assert ak.admm_ops_floats(10, 6) == 84 * 10 + 18 * 11
    assert ak.admm_launch_shape(20, 8) == (16, 16 * 2984 * 4, True)
    assert ak.admm_launch_shape(10, 6) == (16, 16 * 1038 * 4, True)
    assert ak.admm_launch_shape(20, 6) == (16, 16 * 2058 * 4, True)
    assert ak.admm_launch_shape(40, 8) == (8, 8 * 5944 * 4, True)
    assert ak.admm_launch_shape(100, 8) == (2, 2 * ak.admm_ops_floats(100, 8) * 4, True)
    assert ak.admm_launch_shape(500, 8) == (16, 0, False)
    for N in (1, 8, 20, 40, 100, 500):
        for na in (6, 8):
            sh = ak.admm_launch_shape(N, na)
            assert sh.ints() == [sh.lanes, int(sh.ops_in_smem), sh.smem_bytes]
            assert sh.smem_bytes <= 232_448 - 1_024


def test_admm_kernel_width_check():
    """The solver-only kernel takes (na, nu, nc) = (8, 2, 6) and (6, 2, 6);
    the kernel route raises on any other width before it reaches the card,
    and on a taken width it needs the card (no fallback)."""
    ak.check_widths(8, 2, 6)
    ak.check_widths(6, 2, 6)
    for dims in ((4, 2, 6), (7, 2, 6), (10, 2, 6), (8, 3, 6), (8, 2, 5), (6, 1, 6)):
        with pytest.raises(ValueError, match="takes"):
            ak.check_widths(*dims)
    p, cfg, track, scen, x_ref = _small_case()
    carry = mpc_init(scen.params, cfg, track, scen.x0)
    qp, warm, _ = mpc_prepare(scen.params, cfg, track, scen.x0, x_ref, carry)
    scfg = SolverConfig(max_iter=5, rho_interval=0)
    wide = qp._replace(Dx=torch.zeros((6, 9)))
    with pytest.raises(ValueError, match="takes"):
        ak._admm_cuda(wide, scfg, warm, carry.rho)
    if not torch.cuda.is_available():
        _cuda.library.cache_clear()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ak._admm_cuda(qp, scfg, warm, carry.rho)
    assert admm_kernel_solve.launches == 0


def test_one_tracker_core():
    """ops/csrc holds one tracker core, the group core: no one-thread
    prepare, factor, z_update, admm_iteration or mpc_core is left, the
    header of parameters and layout defines no device code, and every
    kernel of the tracker runs the group core."""
    import re

    srcs = {p.name: p.read_text() for p in _cuda._sources()}
    one_thread = re.compile(r"\b(void|Resid)\s+(prepare|factor|z_update|admm_iteration|mpc_core)\s*\(")
    for name, text in srcs.items():
        assert not one_thread.search(text), name
        assert "__syncthreads_and" not in text or name == "arl_sync.cuh", name
    assert "__device__" not in srcs["mpc_core.cuh"].split("struct WsLayout")[0]
    assert "__device__ __forceinline__ void" not in srcs["mpc_core.cuh"]
    for name in ("megastep_kernel.cu", "racestep_kernel.cu", "fused_kernel.cu", "admm_kernel.cu"):
        assert '#include "group_core.cuh"' in srcs[name], name
    for name in ("megastep_kernel.cu", "racestep_kernel.cu"):
        assert "mpc_core_g(" in srcs[name], name


_PAD = 4096   # floats past each output that a kernel must leave untouched


@contextlib.contextmanager
def _nan_padded_outputs(monkeypatch):
    """Every torch.empty of the wrapper becomes a NaN-filled buffer with a
    pad of _PAD NaNs behind it; yields the list of pads. A lane past B would
    write past its array's last row, into the pad."""
    pads, real = [], torch.empty

    def empty(shape, **kw):
        n = math.prod(shape)
        buf = real((n + _PAD,), **kw).fill_(float("nan"))
        pads.append(buf[n:])
        return buf[:n].view(shape)

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", empty)
        yield pads


def _untouched(pads):
    return all(bool(torch.isnan(pad).all()) for pad in pads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 20])
def test_admm_kernel_matches_plain_on_card(cuda_device, N):
    p, cfg, track, scen, x_ref = _small_case(cuda_device, N=N, n_ey=20, n_mu=15)
    carry = mpc_init(scen.params, cfg, track, scen.x0)
    qp, warm, _ = mpc_prepare(scen.params, cfg, track, scen.x0, x_ref, carry)
    scfg = SolverConfig(max_iter=20, rho_interval=0)
    ref = admm_solve_plain(qp, scfg, warm, carry.rho)
    before = admm_kernel_solve.launches
    sol = admm_kernel_solve(qp, scfg, warm, carry.rho)
    torch.cuda.synchronize()
    assert admm_kernel_solve.launches == before + 1
    assert (sol.U - ref.U).abs().max().item() <= 2e-4
    assert (sol.X - ref.X).abs().max().item() <= 2e-4
    assert (sol.r_prim - ref.r_prim).abs().max().item() <= 1e-4
    assert (sol.iters - ref.iters).abs().max().item() <= 1


# corridor blocks ahead of the scenario grid's start on the racetrack, and
# spread over the lap for cars spread over it
_MEGA_BLOCKS = [[1.0, 2.0, -0.45, -0.1]]
_RACE_BLOCKS = [[3.0, 4.2, -0.25, 0.1], [8.0, 9.0, -0.1, 0.3], [20.0, 21.5, -0.4, 0.0]]


@pytest.mark.cuda
@pytest.mark.parametrize("refs", ["constant", "pacejka-per-lane"])
@pytest.mark.parametrize("eyb", [False, True])
@pytest.mark.parametrize("early_exit,tol_u,tol_x", [(False, 2e-4, 5e-4), (True, 5e-3, 5e-3)])
def test_megastep_kernel_matches_plain_on_card(cuda_device, early_exit, tol_u, tol_x, eyb, refs):
    """5 steps, with and without an e_y corridor (each step's made once
    from the plain carry and handed to both); "pacejka-per-lane" is the lap
    learner's instantiation: N=10, Pacejka controller and plant, and (N+1,
    nx, B) references sampled from one table per lane along the plain
    carry's schedule (``batched_refs_from_tables``)."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.lap_learning import (
        batched_refs_from_tables, per_lane_table,
    )

    lap = refs == "pacejka-per-lane"
    p, cfg, track, scen, x_ref = _small_case(cuda_device, N=10 if lap else 20, n_ey=20, n_mu=15)
    if lap:
        cfg = cfg.replace(tire="pacejka")
        tab = per_lane_table(initial_table(track, ds=0.05, vx0=1.0), scen.batch)
        lane = torch.linspace(0.0, 1.0, scen.batch, device=cuda_device)[:, None]
        node = torch.arange(tab.vx.shape[1], device=cuda_device) / 7.0
        tab = tab.replace(vx=tab.vx * (1.0 + 0.8 * lane), ey=0.08 * lane * torch.sin(node))
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=early_exit, check_termination=2)
    prm = megastep_params(scen.params, scen.batch, device=cuda_device)
    ck = cp = megastep_init(scen.params, cfg, track, scen.x0)
    eyb_of = corridor_eyb(p, cfg, track, pad_blocks(_MEGA_BLOCKS, 8), device=cuda_device) if eyb else None
    before = megastep.launches
    for _ in range(5):
        e = eyb_of(cp.x[4], cp.X_pred[:, 4]) if eyb else None
        if lap:
            x_ref = batched_refs_from_tables(cfg, tab, torch.cat([cp.x[4][None], cp.X_pred[2:, 4],
                                                                  cp.X_pred[-1:, 4]]))
        ck, uk, _ = megastep(cfg, scfg, track, prm, x_ref, ck, eyb=e)
        cp, up, _ = megastep_plain(cfg, scfg, track, prm, x_ref, cp, eyb=e)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= tol_u
        assert (ck.x - cp.x).abs().max().item() <= tol_x
    assert megastep.launches == before + 5


def _fused_case(device, model, N, n_ey, n_mu, warm_steps=10):
    """Prepared inputs of the fused solve after a few fused-path steps."""
    cfg = MPCConfig(N=N, model=model, weights=MPCWeights.for_model(model))
    track = racetrack(device=device) if model == "dynamic" else oval_track(device=device)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=n_ey, n_mu=n_mu, vx0=1.5, device=device)
    x_ref = constant_refs(cfg, 1.8 if model == "dynamic" else 1.5, device=device)
    scfg = SolverConfig(max_iter=20, rho_interval=0, backend="fused", check_termination=2,
                        certify_infeasibility=False)
    carry, x = mpc_init(scen.params, cfg, track, scen.x0), scen.x0
    for _ in range(warm_steps):
        u, carry, _ = mpc_step_batched(scen.params, cfg, scfg, track, x, x_ref, carry)
        x = plant_step(scen.params, cfg, track, x, u, n_sub=4)
    Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(scen.params, cfg, track, x, x_ref, carry)
    return cfg, scfg, (scen.params, Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], carry.rho)


def test_fused_wrapper_routes_by_device():
    """CPU tensors take the plain version and count no launch; other
    devices raise; the kernel route never falls back to the plain version."""
    cfg, scfg, args = _fused_case("cpu", "kinematic", N=6, n_ey=2, n_mu=2, warm_steps=1)
    sol = fused_mpc_solve(cfg, scfg, *args)
    assert fused_mpc_solve.launches == 0 and sol.U.shape == (4, 6, 2)
    meta = [torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        fused_mpc_solve(cfg, scfg, *meta)
    with pytest.raises(NotImplementedError):
        fused_mpc_solve(cfg.replace(discretization="euler"), scfg, *args)
    if not torch.cuda.is_available():
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_kernel as fk

        with pytest.raises(RuntimeError, match="no CUDA device"):
            fk._fused_cuda(cfg, scfg, *args)
    assert fused_mpc_solve.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 300, 4096 + 37])
@pytest.mark.parametrize("model,N", [("dynamic", 20), ("kinematic", 10)])
def test_fused_kernel_matches_plain_on_card(cuda_device, model, N, B, monkeypatch):
    """One fused solve at B lanes (ragged batches: a partial vote group, a
    partial last cluster) on inputs prepared after 10 fused-path steps: 2e-4
    on lanes converged on both sides, 5e-3 on every lane, done-at within one
    iteration; early exit within 5e-3. Every output is written and nothing
    past B is."""
    n_ey, n_mu = (20, 15) if B == 300 else (B, 1)
    cfg, scfg, args = _fused_case(cuda_device, model, N, n_ey=n_ey, n_mu=n_mu)
    for early_exit in (False, True):
        sc = scfg.replace(early_exit=early_exit)
        before = fused_mpc_solve.launches
        with _nan_padded_outputs(monkeypatch) as pads:
            sk = fused_mpc_solve(cfg, sc, *args)
            torch.cuda.synchronize()
        sp = fused_solve_plain(cfg, sc, *args)
        torch.cuda.synchronize()
        assert fused_mpc_solve.launches == before + 1
        assert _untouched(pads)
        assert all(bool(torch.isfinite(t).all()) for t in (sk.X, sk.U, sk.s, sk.lam, sk.r_prim, sk.rho))
        lane = torch.maximum((sk.U - sp.U).abs().amax(dim=(1, 2)), (sk.X - sp.X).abs().amax(dim=(1, 2)))
        assert lane.shape == (B,) and lane.max().item() <= 5e-3
        if not early_exit:
            both = sk.converged & sp.converged
            assert int(both.sum()) >= 0.9 * lane.shape[0]
            assert lane[both].max().item() <= 2e-4
            assert (sk.iters - sp.iters).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit,tol_u,tol_x", [(False, 2e-4, 5e-4), (True, 5e-3, 5e-3)])
def test_kinematic_megastep_matches_plain_on_card(cuda_device, early_exit, tol_u, tol_x):
    cfg = MPCConfig(N=10, model="kinematic", weights=MPCWeights.for_model("kinematic"))
    track = oval_track(device=cuda_device)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=20, n_mu=15, vx0=0.5, device=cuda_device)
    x_ref = constant_refs(cfg, 1.5, device=cuda_device)
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=early_exit, check_termination=2)
    prm = megastep_params(scen.params, scen.batch, device=cuda_device)
    ck = cp = megastep_init(scen.params, cfg, track, scen.x0)
    for _ in range(5):
        ck, uk, _ = megastep(cfg, scfg, track, prm, x_ref, ck)
        cp, up, _ = megastep_plain(cfg, scfg, track, prm, x_ref, cp)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= tol_u
        assert (ck.x - cp.x).abs().max().item() <= tol_x


def _mega_case(device, model, B):
    """The megastep at B lanes: the dynamic bench protocol (N=20,
    racetrack) or BASELINE config 1 (kinematic, N=10, oval)."""
    kin = model == "kinematic"
    cfg = MPCConfig(N=10 if kin else 20, model=model, weights=MPCWeights.for_model(model))
    track = oval_track(device=device) if kin else racetrack(device=device)
    n_ey, n_mu = (20, 15) if B == 300 else (B, 1)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=n_ey, n_mu=n_mu, vx0=0.5 if kin else 1.5,
                              device=device)
    x_ref = constant_refs(cfg, 1.5 if kin else 1.8, device=device)
    prm = megastep_params(scen.params, scen.batch, device=device)
    return cfg, track, x_ref, prm, megastep_init(scen.params, cfg, track, scen.x0)


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("B", [1, 37, 300, 4096 + 37])
@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_megastep_ragged_batches_on_card(cuda_device, model, B, early_exit, monkeypatch):
    """Three megastep steps at B lanes (ragged batches: a partial vote
    group, a partial last cluster), both models, with and without early
    exit: u 2e-4 / x 5e-4 of plain at a fixed count, 5e-3 with early exit.
    Every output is written and nothing past B is."""
    cfg, track, x_ref, prm, ck = _mega_case(cuda_device, model, B)
    cp = ck
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=early_exit, check_termination=2)
    tol_u, tol_x = (5e-3, 5e-3) if early_exit else (2e-4, 5e-4)
    before = megastep.launches
    for _ in range(3):
        with _nan_padded_outputs(monkeypatch) as pads:
            ck, uk, dk = megastep(cfg, scfg, track, prm, x_ref, ck)
            torch.cuda.synchronize()
        assert _untouched(pads)
        assert all(bool(torch.isfinite(t).all()) for t in (*ck, uk, dk))
        cp, up, _ = megastep_plain(cfg, scfg, track, prm, x_ref, cp)
        torch.cuda.synchronize()
        assert uk.shape == (2, B)
        assert (uk - up).abs().max().item() <= tol_u
        assert (ck.x - cp.x).abs().max().item() <= tol_x
    assert megastep.launches == before + 3


def _admm_case(device, na, B, N=None):
    """The first step's tracker QPs at B lanes: na=8 the dynamic bicycle on
    the racetrack (N=20), na=6 the kinematic one on the oval (N=10)."""
    kin = na == 6
    cfg = MPCConfig(N=N or (10 if kin else 20), model="kinematic" if kin else "dynamic",
                    weights=MPCWeights.for_model("kinematic" if kin else "dynamic"))
    track = oval_track(device=device) if kin else racetrack(device=device)
    n_ey, n_mu = (20, 15) if B == 300 else (B, 1)
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=n_ey, n_mu=n_mu, vx0=0.5 if kin else 1.5,
                              device=device)
    x_ref = constant_refs(cfg, 1.5 if kin else 1.8, device=device)
    carry = mpc_init(scen.params, cfg, track, scen.x0)
    qp, warm, _ = mpc_prepare(scen.params, cfg, track, scen.x0, x_ref, carry)
    return qp, warm, carry.rho


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "device", "8 per block"])
@pytest.mark.parametrize("B", [1, 37, 300, 4096 + 37])
@pytest.mark.parametrize("na", [8, 6])
def test_admm_kernel_widths_and_layouts_on_card(cuda_device, na, B, layout, monkeypatch):
    """The solver-only kernel at both widths and ragged B, with its operands
    in shared memory (16 or 8 QPs per block) or in device memory: U, X 2e-4
    and r_prim 1e-4 of plain, done-at within 1; every output is written and
    nothing past B is."""
    qp, warm, rho = _admm_case(cuda_device, na, B)
    N = qp.dyn.A.shape[1]
    floats = ak.admm_ops_floats(N, na)
    shapes = {"shared": ak.admm_launch_shape, "device": lambda N, na: ak.AdmmShape(16, 0, False),
              "8 per block": lambda N, na: ak.AdmmShape(8, 8 * floats * 4, True)}
    scfg = SolverConfig(max_iter=20, rho_interval=0)
    before = admm_kernel_solve.launches
    with monkeypatch.context() as m:
        m.setattr(ak, "admm_launch_shape", shapes[layout])
        with _nan_padded_outputs(monkeypatch) as pads:
            sol = admm_kernel_solve(qp, scfg, warm, rho)
            torch.cuda.synchronize()
    assert _untouched(pads)
    assert admm_kernel_solve.launches == before + 1
    ref = admm_solve_plain(qp, scfg, warm, rho)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in (sol.X, sol.U, sol.s, sol.lam, sol.r_prim, sol.rho))
    assert sol.U.shape == (B, N, 2) and sol.X.shape == (B, N + 1, na)
    assert (sol.U - ref.U).abs().max().item() <= 2e-4
    assert (sol.X - ref.X).abs().max().item() <= 2e-4
    assert (sol.r_prim - ref.r_prim).abs().max().item() <= 1e-4
    assert (sol.iters - ref.iters).abs().max().item() <= 1


def test_racestep_wrapper_routes_by_device():
    """CPU tensors take the plain version and count no launch; a carry on
    another device raises; CUDA tensors cannot be made without a card; the
    parts left out raise."""
    track = oval_track(device="cpu")
    cfg = MPCConfig(N=8, model="dynamic", tire="pacejka")
    scfg = SolverConfig(max_iter=10)
    x0 = torch.zeros((2, 6))
    x0[:, 0] = 1.2
    car = racestep_init(VehicleParams(), cfg, track, x0, 0.8)
    prm = megastep_params(VehicleParams(mu=0.8), 2, device="cpu")
    args = (torch.zeros((6, 2)), torch.full((2,), 0.8), _EKF_Q, _SIGMA ** 2)
    racestep(cfg, scfg, track, prm, constant_refs(cfg, 1.2, device="cpu"), car, *args)
    assert racestep.launches == 0
    meta = RaceMegaCarry(*(torch.empty_like(t, device="meta") for t in car))
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        racestep(cfg, scfg, track, prm, constant_refs(cfg, 1.2, device="cpu"), meta, *args)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            racestep_init(VehicleParams(), cfg, track, x0.to("cuda"), 0.8)
        # the kernel route itself never falls back to the plain version
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rk._racestep_cuda(cfg, scfg, track, prm, constant_refs(cfg, 1.2, device="cpu"), car, *args, 10, 4, None,
                              True, True, 0.0, 0.995, 0.05, 3.0, None)
    # the e_y corridor operand: the box's own bounds change nothing, a
    # corridor that excludes the cars' line does
    refs = constant_refs(cfg, 1.2, device="cpu")
    box = torch.tensor([-cfg.bounds.ey_max, cfg.bounds.ey_max]).reshape(1, 2, 1).expand(9, 2, 2).contiguous()
    base = racestep(cfg, scfg, track, prm, refs, car, *args)
    same = racestep(cfg, scfg, track, prm, refs, car, *args, eyb=box)
    above = box.clone()
    above[:, 0] = 0.1
    narrow = racestep(cfg, scfg, track, prm, refs, car, *args, eyb=above)
    assert all(torch.equal(a, b) for a, b in zip((*base[0], *base[1:]), (*same[0], *same[1:])))
    assert (base[1] - narrow[1]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="eyb has shape"):
        racestep(cfg, scfg, track, prm, refs, car, *args, eyb=box[:, :, :1])
    with pytest.raises(NotImplementedError):
        racestep(cfg.replace(model="kinematic"), scfg, track, prm, constant_refs(cfg, 1.2, device="cpu"), car, *args)
    # per-lane tables: every lane given the shared table's rows reads what
    # the shared table gives; a table for another number of lanes raises
    shared = initial_table(track)
    shared = shared.replace(ey=0.05 * torch.sin(torch.arange(shared.vx.shape[0]) * 0.1))
    lanes = lambda t, nb: t.replace(**{f: getattr(t, f).expand((nb,) + getattr(t, f).shape).contiguous()
                                       for f in ("ds", "length", "vx", "ey", "delta")})
    a = racestep(cfg, scfg, track, prm, shared, car, *args)
    b = racestep(cfg, scfg, track, prm, lanes(shared, 2), car, *args)
    assert all(torch.equal(x, y) for x, y in zip((*a[0], *a[1:]), (*b[0], *b[1:])))
    with pytest.raises(ValueError, match="per-lane tables have 3 lanes"):
        racestep(cfg, scfg, track, prm, lanes(shared, 3), car, *args)
    # the core's workspace (Ad: its 4 computed columns a stage) and the racestep's rows
    assert rk.racestep_workspace(20) == 111 * 20 + 33 + 21 * 6
    assert racestep.launches == 0


def _race_case(device, Bc):
    track = racetrack(device=device)
    cfg = MPCConfig(N=20, model="dynamic", tire="pacejka")
    x0 = torch.zeros((Bc, 6), device=device)
    x0[:, 0] = 1.5
    x0[:, 4] = torch.arange(Bc, device=device) * (float(track.length) / Bc)
    mu_b = torch.linspace(0.5, 1.2, Bc, device=device)
    prm = megastep_params(VehicleParams(mu=0.85), Bc, device=device)
    return track, cfg, x0, mu_b, prm


def _lane_tables(track, Bc):
    """Per-lane tables of main path 5's size: each lane its own vx level
    (1.425-1.575) and a racing line of its own phase."""
    shared = initial_table(track, ds=0.05, vx0=1.5)
    n, dev = shared.vx.shape[0], shared.vx.device
    w = torch.arange(n, device=dev) * (2 * math.pi * 3 / n)
    lane = torch.arange(Bc, device=dev)[:, None]
    return RefTable(ds=shared.ds.expand(Bc), length=shared.length.expand(Bc),
                    vx=(1.5 * (0.95 + 0.1 * lane / Bc)).expand(Bc, n).contiguous(),
                    ey=0.05 * torch.sin(w[None] + 0.1 * lane), delta=torch.zeros((Bc, n), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("Bc", [1, 37, 130, 300, 4096 + 37])
@pytest.mark.parametrize("refs,gate", [("table", 0.0), ("constant", 3.0), ("per_lane", 0.0), ("per_lane+eyb", 0.0),
                                       ("table+eyb", 0.0)])
def test_racestep_kernel_matches_plain_on_card(cuda_device, refs, gate, Bc, early_exit, monkeypatch):
    """The racetrack protocol at Bc lanes (ragged batches: B=130 leaves a
    partial block and vote group, for the per-lane tables' stride), N=20,
    5 steps with and without early exit, with shared, constant or per-lane
    references and with or without an obstacle corridor (each step's made
    once from the plain carry and handed to both); the bounds of
    chip_smoke.py on the lanes that converged throughout (5e-3 with early
    exit), 5e-3 on every lane. Every output is written and nothing past Bc
    is.

    Per-lane tables and corridors start many cars off their line or outside
    their corridor, so on these first steps many lanes stop unconverged
    (half must converge throughout, 90% otherwise), and on those the two
    versions' carries drift apart by the unconverged solve's sensitivity,
    up to a flipped limp-home choice. There, as in chip_smoke.py's
    [race-eyb], every lane is held to the converged-lane bounds one step at
    a time from plain's carry instead."""
    track, cfg, x0, mu_b, prm = _race_case(cuda_device, Bc)
    scfg = SolverConfig(max_iter=20, rho_interval=0, check_termination=2, early_exit=early_exit)
    ref = {"constant": lambda: constant_refs(cfg, 1.5, device=cuda_device),
           "per_lane": lambda: _lane_tables(track, Bc), "per_lane+eyb": lambda: _lane_tables(track, Bc)}.get(
        refs, lambda: initial_table(track, ds=0.05, vx0=1.5))()
    eyb_of = (corridor_eyb(VehicleParams(), cfg, track, pad_blocks(_RACE_BLOCKS, 8), device=cuda_device)
              if refs.endswith("eyb") else None)
    one_step = refs not in ("table", "constant")
    sig = torch.tensor(_SIGMA, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ck = cp = racestep_init(VehicleParams(), cfg, track, x0, 0.85)
    before = racestep.launches
    conv = torch.ones(Bc, dtype=torch.bool, device=cuda_device)
    worst, worst_step = {}, {}

    def widen(acc, key, x, y):
        d = (x - y).abs().reshape(-1, Bc).amax(dim=0)
        acc[key] = torch.maximum(acc[key], d) if key in acc else d

    for _ in range(5):
        noise = sig[:, None] * torch.randn((6, Bc), generator=gen, device=cuda_device)
        a = (cfg, scfg, track, prm, ref)
        e = None if eyb_of is None else eyb_of(cp.ekx[4], cp.X_pred[:, 4])
        with _nan_padded_outputs(monkeypatch) as pads:
            ck, uk, dk, zk = racestep(*a, ck, noise, mu_b, _EKF_Q, _SIGMA ** 2, gate_sigma=gate, eyb=e)
            torch.cuda.synchronize()
        assert _untouched(pads)
        assert all(bool(torch.isfinite(t).all()) for t in (*ck, uk, dk, zk))
        if one_step:
            cs, us, _, zs = racestep(*a, cp, noise, mu_b, _EKF_Q, _SIGMA ** 2, gate_sigma=gate, eyb=e)
        cp, up, dp, zp = racestep_plain(*a, cp, noise, mu_b, _EKF_Q, _SIGMA ** 2, gate_sigma=gate, eyb=e)
        torch.cuda.synchronize()
        conv &= (dk[2] > 0.5) & (dp[2] > 0.5)
        for key, x, y in (("u0", uk, up), ("z", zk, zp), ("xg", ck.xg, cp.xg), ("ekx", ck.ekx, cp.ekx),
                          ("X_pred", ck.X_pred, cp.X_pred), ("fr", ck.fr, cp.fr)):
            widen(worst, key, x, y)
        if one_step:
            for key, x, y in (("u0", us, up), ("z", zs, zp), ("xg", cs.xg, cp.xg), ("ekx", cs.ekx, cp.ekx),
                              ("X_pred", cs.X_pred, cp.X_pred), ("fr", cs.fr, cp.fr)):
                widen(worst_step, key, x, y)
    assert racestep.launches == before + (10 if one_step else 5)
    assert int(conv.sum()) >= (0.5 if one_step else 0.9) * Bc
    for key, tol in (("u0", 2e-4), ("z", 5e-4), ("xg", 5e-4), ("ekx", 5e-4), ("X_pred", 5e-4), ("fr", 1e-4)):
        tol = 5e-3 if early_exit else tol
        if bool(conv.any()):
            assert worst[key][conv].max().item() <= tol, key
        if one_step:
            assert worst_step[key].max().item() <= tol, key
        else:
            assert worst[key].max().item() <= 5e-3, key


@pytest.mark.cuda
def test_racestep_measurement_at_window_edges_on_card(cuda_device):
    """Cars placed on the node at each edge of the +-win_cells window of
    their EKF hint, and half-way between the edge node and its inner
    neighbour (equal distances: ties go to the smallest cell id): the
    kernel's strided search finds the plain version's node."""
    track, cfg, _, _, _ = _race_case(cuda_device, 1)
    W = rk._win_cells(track, 3.0)
    Xt, Yt, _ = rk._pose_tables(track, cuda_device)
    n, ds = track.n_cells, float(track.ds_host)
    hint = torch.tensor([300, 301, 302, 303, 304, 305, 306, 307], device=cuda_device)
    edge = torch.tensor([W, -W, W, -W, W - 1, 1 - W, W, -W], device=cuda_device)
    c = torch.remainder(hint + edge, n)
    inner = torch.remainder(c - torch.sign(edge), n)
    mid = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], device=cuda_device, dtype=torch.bool)
    X = torch.where(mid, 0.5 * (Xt[c] + Xt[inner]), Xt[c])
    Y = torch.where(mid, 0.5 * (Yt[c] + Yt[inner]), Yt[c])
    Bc = hint.shape[0]
    x0 = torch.zeros((Bc, 6), device=cuda_device)
    x0[:, 0] = 1.5
    x0[:, 4] = (hint.to(torch.float32) + 0.5) * ds
    car = racestep_init(VehicleParams(), cfg, track, x0, 0.85)
    car = car._replace(xg=torch.stack([car.xg[0], car.xg[1], car.xg[2], X, Y, car.xg[5]]).contiguous())
    prm = megastep_params(VehicleParams(mu=0.85), Bc, device=cuda_device)
    scfg = SolverConfig(max_iter=20, rho_interval=0, check_termination=2)
    a = (cfg, scfg, track, prm, constant_refs(cfg, 1.5, device=cuda_device), car,
         torch.zeros((6, Bc), device=cuda_device), torch.full((Bc,), 0.85, device=cuda_device),
         _EKF_Q, _SIGMA ** 2)
    _, _, _, zk = racestep(*a)
    _, _, _, zp = racestep_plain(*a)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(zk).all())
    assert (zk - zp).abs().max().item() <= 5e-4
    # the measured s lies within a cell of the node found
    assert (zk[4] - zp[4]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 4096 + 37])
def test_group_kernels_operands_in_device_memory_on_card(cuda_device, B, monkeypatch):
    """The group kernels with their ADMM operands in the device-memory
    workspace (the layout launch_shape picks for long horizons) give the
    shared-memory layout's results exactly: two megastep steps and one fused
    solve per model with and without early exit, and 3 racestep steps. A fused solve past the
    shared-memory limit (N=56) takes that layout and stays within 5e-3 of
    plain."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_kernel as fk

    shape_of = fk.launch_shape
    in_device_memory = lambda N, model="dynamic": shape_of(N, model)._replace(smem_bytes=0, ops_in_smem=False)

    def both_layouts(run):
        a = run()
        with monkeypatch.context() as m:
            m.setattr(fk, "launch_shape", in_device_memory)
            m.setattr(rk, "launch_shape", in_device_memory)
            b = run()
        torch.cuda.synchronize()
        return a, b

    def both_layouts_mega(run):
        a = run()
        with monkeypatch.context() as m:
            m.setattr(mk, "launch_shape", in_device_memory)
            b = run()
        torch.cuda.synchronize()
        return a, b

    for model in ("dynamic", "kinematic"):
        cfg, track, x_ref, prm, car = _mega_case(cuda_device, model, B)
        for early_exit in (False, True):
            sc = SolverConfig(max_iter=20, rho_interval=0, early_exit=early_exit, check_termination=2)
            c = car
            for _ in range(2):
                a, b = both_layouts_mega(lambda: megastep(cfg, sc, track, prm, x_ref, c))
                assert all(torch.equal(x, y) for x, y in zip((*a[0], *a[1:]), (*b[0], *b[1:]))), (model, early_exit)
                c = a[0]

    for model, N in (("dynamic", 20), ("kinematic", 10)):
        cfg, scfg, args = _fused_case(cuda_device, model, N, n_ey=B, n_mu=1)
        for early_exit in (False, True):
            sc = scfg.replace(early_exit=early_exit)
            a, b = both_layouts(lambda: fused_mpc_solve(cfg, sc, *args))
            for name in ("X", "U", "s", "lam", "r_prim", "rho", "iters"):
                assert torch.equal(getattr(a, name), getattr(b, name)), (model, early_exit, name)

    track, cfg, x0, mu_b, prm = _race_case(cuda_device, B)
    scfg = SolverConfig(max_iter=20, rho_interval=0, check_termination=2, early_exit=True)
    ref = initial_table(track, ds=0.05, vx0=1.5)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    noise = torch.tensor(_SIGMA, device=cuda_device)[:, None] * torch.randn((6, B), generator=gen, device=cuda_device)
    car = racestep_init(VehicleParams(), cfg, track, x0, 0.85)
    for _ in range(3):
        a, b = both_layouts(lambda: racestep(cfg, scfg, track, prm, ref, car, noise, mu_b, _EKF_Q, _SIGMA ** 2))
        assert all(torch.equal(x, y) for x, y in zip((*a[0], *a[1:]), (*b[0], *b[1:])))
        car = a[0]

    assert not shape_of(56).ops_in_smem
    cfg, scfg, args = _fused_case(cuda_device, "dynamic", 56, n_ey=B, n_mu=1, warm_steps=2)
    sk = fused_mpc_solve(cfg, scfg, *args)
    sp = fused_solve_plain(cfg, scfg, *args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sk.X).all())
    assert max((sk.U - sp.U).abs().max().item(), (sk.X - sp.X).abs().max().item()) <= 5e-3


@pytest.mark.cuda
def test_group_kernels_take_any_sequence_of_horizons_on_card(cuda_device):
    """The group kernels' shared memory per block follows N: on one kernel,
    a long horizon after a shorter one (N = 20, 10, 20) still launches, and
    each result agrees with its plain version (the megastep, the fused
    kernel, the racestep and the solver-only kernel)."""
    p, _, track, scen, _ = _small_case(cuda_device, n_ey=37, n_mu=1)
    scfg = SolverConfig(max_iter=20, rho_interval=0, check_termination=2)
    prm = megastep_params(scen.params, scen.batch, device=cuda_device)
    for N in (20, 10, 20):
        cfg = MPCConfig(N=N)
        x_ref = constant_refs(cfg, 1.8, device=cuda_device)
        car = megastep_init(scen.params, cfg, track, scen.x0)
        ck, uk, _ = megastep(cfg, scfg, track, prm, x_ref, car)
        cp, up, _ = megastep_plain(cfg, scfg, track, prm, x_ref, car)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= 5e-3, N
        assert (ck.x - cp.x).abs().max().item() <= 5e-3, N
    for N in (20, 10, 20):
        qp, warm, rho = _admm_case(cuda_device, 8, 37, N=N)
        sol = admm_kernel_solve(qp, scfg, warm, rho)
        ref = admm_solve_plain(qp, scfg, warm, rho)
        torch.cuda.synchronize()
        assert (sol.U - ref.U).abs().max().item() <= 2e-4, N
    for N in (20, 10, 20):
        cfg, scfg, args = _fused_case(cuda_device, "dynamic", N, n_ey=37, n_mu=1, warm_steps=2)
        sk = fused_mpc_solve(cfg, scfg, *args)
        sp = fused_solve_plain(cfg, scfg, *args)
        torch.cuda.synchronize()
        assert max((sk.U - sp.U).abs().max().item(), (sk.X - sp.X).abs().max().item()) <= 5e-3, N
    track, _, x0, mu_b, prm = _race_case(cuda_device, 37)
    scfg = SolverConfig(max_iter=20, rho_interval=0, check_termination=2)
    noise = torch.zeros((6, 37), device=cuda_device)
    for N in (20, 10, 20):
        cfg = MPCConfig(N=N, model="dynamic", tire="pacejka")
        car = racestep_init(VehicleParams(), cfg, track, x0, 0.85)
        a = (cfg, scfg, track, prm, constant_refs(cfg, 1.5, device=cuda_device), car, noise, mu_b,
             _EKF_Q, _SIGMA ** 2)
        ck, uk, _, _ = racestep(*a)
        cp, up, _, _ = racestep_plain(*a)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= 5e-3, N
        assert (ck.xg - cp.xg).abs().max().item() <= 5e-3, N


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("Bc", [1, 4096])
def test_racestep_at_race_horizon_matches_plain_on_card(cuda_device, Bc, early_exit):
    """The race presets' racestep, N=12 with Pacejka tyres, at path 6's
    width (B=4096) and at race_loop's one car (B=1: one real lane and 127
    padding lanes in the 128-lane vote), 5 noisy steps on a table, each step
    from plain's carry: chip_smoke.py's bounds on every lane (5e-3 with
    early exit). Each version on its own carry is not compared: at N=12 a
    lane can sit at the friction RLS's excitation gate, which 1e-6 apart
    states put on opposite sides (chip_smoke.py, section 5e)."""
    track, _, x0, mu_b, prm = _race_case(cuda_device, Bc)
    cfg = MPCConfig(N=12, model="dynamic", tire="pacejka")
    scfg = SolverConfig(max_iter=40, rho_interval=0, check_termination=2, early_exit=early_exit)
    table = initial_table(track, ds=0.05, vx0=1.5)
    sig = torch.tensor(_SIGMA, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    cp = racestep_init(VehicleParams(), cfg, track, x0, 0.85)
    before = racestep.launches
    worst, n_conv = {}, Bc
    for _ in range(5):
        noise = sig[:, None] * torch.randn((6, Bc), generator=gen, device=cuda_device)
        a = (cfg, scfg, track, prm, table)
        ck, uk, dk, zk = racestep(*a, cp, noise, mu_b, _EKF_Q, _SIGMA ** 2)
        cp_next, up, dp, zp = racestep_plain(*a, cp, noise, mu_b, _EKF_Q, _SIGMA ** 2)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in (*ck, uk, dk, zk))
        n_conv = min(n_conv, int(((dk[2] > 0.5) & (dp[2] > 0.5)).sum()))
        for key, x, y in (("u0", uk, up), ("z", zk, zp), ("xg", ck.xg, cp_next.xg), ("ekx", ck.ekx, cp_next.ekx),
                          ("X_pred", ck.X_pred, cp_next.X_pred), ("fr", ck.fr, cp_next.fr)):
            worst[key] = max(worst.get(key, 0.0), (x - y).abs().max().item())
        cp = cp_next
    assert racestep.launches == before + 5
    assert n_conv >= 0.9 * Bc
    for key, tol in (("u0", 2e-4), ("z", 5e-4), ("xg", 5e-4), ("ekx", 5e-4), ("X_pred", 5e-4), ("fr", 1e-4)):
        assert worst[key] <= (5e-3 if early_exit else tol), key


@pytest.mark.cuda
def test_graphed_plan_matches_eager_on_card(cuda_device):
    """plan_mpp on the card replays one CUDA graph per rho chunk: the same
    plan as every launch eager (the graph replays the same kernels), the
    graph captured once per QP shape and reused by the next plan."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPPConfig
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import plan_mpp
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import admm as admm_mod

    track = oval_track(device=cuda_device)
    pcfg = MPPConfig.for_model("dynamic", H=64, n_sqp=2)
    p = VehicleParams(mu=0.7)
    tab_e, d_e = plan_mpp(p, pcfg, track, graphed=False)
    n_graphs = len(admm_mod._CHUNK_GRAPHS)
    tab_g, d_g = plan_mpp(p, pcfg, track)
    assert len(admm_mod._CHUNK_GRAPHS) <= n_graphs + 1
    tab_g2, _ = plan_mpp(p, pcfg, track, obstacles=pad_blocks(np.array([[4.0, 5.0, -0.4, 0.1]]), 8))
    assert len(admm_mod._CHUNK_GRAPHS) <= n_graphs + 1           # moving blocks reuse the graph
    torch.cuda.synchronize()
    for name in ("vx", "ey", "delta"):
        assert (getattr(tab_g, name) - getattr(tab_e, name)).abs().max().item() <= 5e-3, name
        assert bool(torch.isfinite(getattr(tab_g2, name)).all())
    assert d_g.converged.tolist() == d_e.converged.tolist()
    assert abs(float(d_g.progress) - float(d_e.progress)) <= 1e-3 * abs(float(d_e.progress))

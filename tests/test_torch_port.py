"""Port hygiene and the kernel-vs-plain tests that need an NVIDIA GPU.

- Importing every module of the port leaves no JAX in the process.
- The wrappers route by device: CPU tensors to the plain version, CUDA
  tensors to the kernel, anything else raises; without a card, asking for
  the kernels or for CUDA tensors raises, and CPU calls count no launches.
- Tests marked ``cuda`` hold each kernel against its plain version on the
  card (tolerances of chip_smoke.py); without a card they skip.
"""

import subprocess
import sys

import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs, mpc_init, mpc_prepare
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import admm_kernel_solve, admm_solve_plain
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
    MegaCarry, megastep, megastep_init, megastep_params, megastep_plain, megastep_workspace,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

PKG = "autonomous_racing_lpv_mpp_mpc_tpu_torch"


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
    prm = megastep_params(scen.params, scen.batch)
    megastep(cfg, scfg, track, prm, x_ref, mc)
    assert admm_kernel_solve.launches == 0 and megastep.launches == 0

    meta = lambda t: torch.empty_like(t, device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        admm_kernel_solve(qp._replace(x0=meta(qp.x0)), scfg)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        megastep(cfg, scfg, track, prm, x_ref, MegaCarry(*(meta(t) for t in mc)))
    with pytest.raises(NotImplementedError):
        megastep(cfg, scfg.replace(cache_build=True), track, prm, x_ref, mc)
    with pytest.raises(NotImplementedError):
        megastep(cfg.replace(model="kinematic"), scfg, track, prm, x_ref, mc)


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        racetrack(device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        make_scenario_grid(VehicleParams(), MPCConfig(), device="cuda")
    _cuda.library.cache_clear()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cuda.library()
    assert admm_kernel_solve.launches == 0 and megastep.launches == 0


def test_kernel_sources_and_workspace_layout():
    """The library name follows the sources' content; the megastep's
    workspace formula matches the per-lane layout in the CUDA source."""
    names = {p.name for p in _cuda._sources()}
    assert {"arl_common.cuh", "admm_kernel.cu", "megastep_kernel.cu"} <= names
    assert len(_cuda.source_hash()) == 16
    src = (_cuda.CSRC / "megastep_kernel.cu").read_text()
    terms = src.split("struct WsLayout")[1].split("total = o;")[0].count("o +=")
    assert terms == 14
    # per stage: Xs 6, Us 2, kap 1, lb/ub 12, Ad 36, Bd 12, q0 6, K 16,
    # Hiv 4, Hux 16, d 2, Xsol 8, Usol 2; the N+1-row arrays add one more row
    for N in (1, 8, 12, 20):
        assert megastep_workspace(N) == 123 * N + (6 + 1 + 12 + 6 + 8)


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


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit,tol_u,tol_x", [(False, 2e-4, 5e-4), (True, 5e-3, 5e-3)])
def test_megastep_kernel_matches_plain_on_card(cuda_device, early_exit, tol_u, tol_x):
    p, cfg, track, scen, x_ref = _small_case(cuda_device, N=20, n_ey=20, n_mu=15)
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=early_exit, check_termination=2)
    prm = megastep_params(scen.params, scen.batch, device=cuda_device)
    ck = cp = megastep_init(scen.params, cfg, track, scen.x0)
    before = megastep.launches
    for _ in range(5):
        ck, uk, _ = megastep(cfg, scfg, track, prm, x_ref, ck)
        cp, up, _ = megastep_plain(cfg, scfg, track, prm, x_ref, cp)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= tol_u
        assert (ck.x - cp.x).abs().max().item() <= tol_x
    assert megastep.launches == before + 5

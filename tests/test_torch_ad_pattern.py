"""The structural pattern of the discretized Ad that the group kernels keep
(``csrc/arl_common.cuh``, each model's ``AD_PATTERN``): the kernels keep
only the columns with computed ('x') entries; every other column is a unit
column at every stage. The CPU tests hold the plain stage build to the pattern at
seeded schedules, the clamps included, and the Python layout helpers to its
count; the ``cuda`` test reads the clusters per wave that the compact
operand slices give the megastep and the fused kernel. This file imports no
JAX, so the card runs it with ``--noconftest``."""

import math
import re
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, MPCWeights, SolverConfig, VehicleParams  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.stage_math import (  # noqa: E402
    DENOM_EPS, VX_EPS, model_dims, stack_params, stage_aug_ab, unpack_params,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import profiling  # noqa: E402

TRAITS = {"dynamic": "struct Dynamic", "kinematic": "struct Kinematic"}


def header_pattern(model: str) -> list:
    """The rows of ``model``'s AD_PATTERN as arl_common.cuh spells them."""
    src = (_cuda.CSRC / "arl_common.cuh").read_text()
    body = src.split(TRAITS[model] + " {")[1].split("AD_PATTERN[] =")[1].split(";")[0]
    return re.findall(r'"([^"]*)"', body)


def schedules(model: str, B: int, seed: int):
    """(x (nx, B), u (NU, B), kappa (B,), mu (B,)) drawn from the seed, with
    lanes at the stage build's clamps: vx at and below VX_EPS, 1 - kappa
    e_y at and below DENOM_EPS, |e_psi| at and near pi/2."""
    g = torch.Generator().manual_seed(seed)
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=g)
    vx, epsi, ey, kap = uni(-0.5, 4.0), uni(-1.6, 1.6), uni(-0.6, 0.6), uni(-2.0, 2.0)
    q = B // 8
    vx[:q] = torch.tensor([VX_EPS, 0.5 * VX_EPS, 0.0, -0.3]).repeat(q // 4 + 1)[:q]
    ey[q:2 * q], kap[q:2 * q] = 0.5, (1.0 - DENOM_EPS) / 0.5 + uni(-0.2, 1.0)[:q].clamp_min(0.0)
    edge = torch.tensor([math.pi / 2, -math.pi / 2, math.pi / 2 - 1e-3, -math.pi / 2 + 1e-3])
    epsi[2 * q:3 * q] = edge.repeat(q // 4 + 1)[:q]
    if model == "kinematic":
        x = torch.stack([vx, epsi, uni(0.0, 20.0), ey])
    else:
        x = torch.stack([vx, uni(-0.5, 0.5), uni(-2.0, 2.0), epsi, uni(0.0, 20.0), ey])
    u = torch.stack([uni(-0.4, 0.4), uni(-3.0, 3.0)])
    return x, u, kap, uni(0.3, 1.2)


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_pattern_is_square_and_its_computed_columns_lead(model):
    nx, _ = model_dims(model)
    rows = header_pattern(model)
    assert len(rows) == nx and all(len(r) == nx and set(r) <= set("x01") for r in rows)
    # the columns with computed entries lead (AdMap keeps them per stage)
    cols = ["".join(r[j] for r in rows) for j in range(nx)]
    lead = fk.AD_COLUMNS[model]
    assert all("x" in c for c in cols[:lead]) and not any("x" in c for c in cols[lead:])
    assert fk.ad_floats(14, model) == 14 * lead * nx
    # every later column is a unit column (AdMap's fix-ups)
    assert all(c.count("1") == 1 and set(c) == {"0", "1"} for c in cols[lead:])


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
@pytest.mark.parametrize("model,tire", [("dynamic", "linear"), ("dynamic", "pacejka"), ("kinematic", "linear")])
def test_plain_stage_build_keeps_the_pattern(model, tire, seed):
    """Exactly 0.0 and 1.0 at the pattern's fixed entries in every lane, and
    each computed entry nonzero in some lane."""
    B = 4096
    nx, _ = model_dims(model)
    x, u, kap, mu = schedules(model, B, seed)
    pv = unpack_params(stack_params(VehicleParams(mu=mu), B, "cpu"))
    Aa, _ = stage_aug_ab(x, u, kap, pv, dt=1.0 / 30.0, tire=tire, model=model)
    Ad = Aa[:nx, :nx]
    assert bool(torch.isfinite(Ad).all())
    for i, row in enumerate(header_pattern(model)):
        for j, c in enumerate(row):
            if c == "x":
                assert bool((Ad[i, j] != 0.0).any()), (i, j)
            else:
                assert bool((Ad[i, j] == float(c)).all()), (i, j, c)


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_n14_holds_more_clusters_per_wave_than_n20_on_card(cuda_device):
    """At cell 2's N=14 (dynamic, Pacejka) the megastep and the fused kernel
    hold at least 1.4 times the clusters per wave of N=20: three blocks of
    the compact operand slices share an SM where two did."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs, mpc_init, mpc_prepare_light
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_mpc_solve, megastep, megastep_init, megastep_params
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

    track = racetrack(device=cuda_device)
    scfg = SolverConfig(max_iter=10, rho_interval=0, check_termination=2, certify_infeasibility=False)
    dev = cuda_device.index if cuda_device.index is not None else torch.cuda.current_device()
    for N in (14, 20):
        cfg = MPCConfig(N=N, tire="pacejka", weights=MPCWeights.for_model("dynamic"))
        scen = make_scenario_grid(VehicleParams(), cfg, n_ey=256, n_mu=1, vx0=1.5, device=cuda_device)
        x_ref = constant_refs(cfg, 1.8, device=cuda_device)
        prm = megastep_params(scen.params, scen.batch, device=cuda_device)
        megastep(cfg, scfg, track, prm, x_ref, megastep_init(scen.params, cfg, track, scen.x0))
        carry = mpc_init(scen.params, cfg, track, scen.x0)
        Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(scen.params, cfg, track, scen.x0, x_ref, carry)
        fused_mpc_solve(cfg, scfg.replace(backend="fused"), scen.params, Xs, Us, kap, xr, lb, ub, x0a,
                        warm[0], warm[1], carry.rho)
    torch.cuda.synchronize()
    smem = {N: fk.launch_shape(N).smem_bytes for N in (14, 20)}
    assert smem[14] == fk.LANES_PER_BLOCK * 4 * (14 * 74 + 16)
    for kernel in ("megastep_kernel", "fused_kernel"):
        fits = profiling.clusters_per_wave(kernel)
        assert fits[(dev, smem[14])] >= 1.4 * fits[(dev, smem[20])] > 0, (kernel, fits)

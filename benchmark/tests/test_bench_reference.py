"""The reference agrees with the port's plain route on the CPU at a tiny
size, on both routes, from the port's own carries and from its start."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import tracker as ref
from benchmark.reference.track import curvature_lookup, track_table

SEED = 2**31 + 99


@pytest.mark.parametrize("cell", ["tiny4.mega-ee", "tiny5.mega-fixed60", "tiny5.fused"])
def test_reference_matches_the_plain_route(tiny, cell):
    res = harness.run_cell(cell, SEED, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                           max_steps=11)
    n = res["_numbers"]
    assert n["lane_steps_compared"] == 3 * 256
    assert n["groups_split"] == 0.0 and n["doneat_gap"] == 0.0 and n["init_gap"] == 0.0
    assert n["u0_max"] <= 1e-6 and n["x_max"] <= 1e-6 and n["pred_max"] <= 1e-6
    assert res["attempted"] == 11 * 256 and res["failed"] == 0


def test_initial_carry_matches_the_port():
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core.config import MPCConfig, VehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.mpc import mpc_init
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

    import json
    from conftest import BENCH

    cfg_d = json.loads((BENCH / "configs" / "baseline4-dyn-n20-b4096.json").read_text())
    S = ref.setup_from_config(cfg_d)
    g = torch.Generator().manual_seed(3)
    x0 = torch.zeros((64, 6))
    x0[:, 0], x0[:, 4], x0[:, 5] = 1.5, 31.0 * torch.rand(64, generator=g), 0.5 * torch.rand(64, generator=g) - 0.25
    mu = 0.7 + 0.3 * torch.rand(64, generator=g)
    c = mpc_init(VehicleParams(mu=mu), MPCConfig(N=S.N), racetrack(device="cpu"), x0)
    want = ref.initial_carry(S, ref.vehicle_rows(S, mu), curvature_lookup(track_table("racetrack", 0.02, "cpu"), "div"),
                             x0.T.contiguous())
    assert torch.allclose(c.X_pred.permute(1, 2, 0), want["X_pred"], atol=1e-6)
    assert torch.equal(c.rho, want["rho"]) and not c.s.any() and not c.lam.any()


def test_track_table_matches_the_port():
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

    t = racetrack(device="cpu")
    mine = track_table("racetrack", 0.02, "cpu")
    assert torch.equal(t.kappa, mine["kappa"]) and torch.equal(t.length, mine["length"])
    assert torch.equal(t.ds, mine["ds"])

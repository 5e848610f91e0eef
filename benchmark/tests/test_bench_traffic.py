"""The scenario stream: seeded, repeatable, inside the grid's cells."""

import json

import torch

from benchmark.traffic import ScenarioStream
from conftest import BENCH

CONFIG = json.loads((BENCH / "configs" / "baseline4-dyn-n20-b4096.json").read_text())
SEED = 2**31 + 12345


def sweeps(seed, n=3):
    st = ScenarioStream(CONFIG, seed, "cpu", 31.5)
    return [st.next() for _ in range(n)]


def test_a_seed_repeats_and_seeds_differ():
    a, b, c = sweeps(SEED), sweeps(SEED), sweeps(SEED + 1)
    for x, y in zip(a, b):
        assert torch.equal(x.x0, y.x0) and torch.equal(x.mu, y.mu)
    assert not torch.equal(a[0].x0, c[0].x0)
    assert not torch.equal(a[0].x0, a[1].x0)       # each sweep fresh draws


def test_each_lane_inside_its_grid_cell():
    g = CONFIG["grid"]
    s = sweeps(SEED, n=1)[0]
    B = g["n_ey"] * g["n_mu"]
    lane = torch.arange(B)
    i_ey, i_mu = lane // g["n_mu"], lane % g["n_mu"]
    w_ey = 2 * g["ey_span"] / g["n_ey"]
    lo, hi = g["mu_range"]
    w_mu = (hi - lo) / g["n_mu"]
    ey, mu = s.x0[:, 5], s.mu
    assert torch.all(ey >= -g["ey_span"] + i_ey * w_ey - 1e-6)
    assert torch.all(ey <= -g["ey_span"] + (i_ey + 1) * w_ey + 1e-6)
    assert torch.all(mu >= lo + i_mu * w_mu - 1e-6) and torch.all(mu <= lo + (i_mu + 1) * w_mu + 1e-6)
    assert torch.all(s.x0[:, 4] >= 0) and torch.all(s.x0[:, 4] < 31.5)
    assert torch.all(s.x0[:, 0] == g["vx0"]) and torch.all(s.x0[:, 1:4] == 0)
    assert float(s.x0[:, 4].std()) > 5.0          # spread over the lap


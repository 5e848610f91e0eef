"""The race cell (``racebench-pacejka-n20-b4096.composed``): held to its
own reference (``reference/race.py``) through the harness. On the CPU at a
tiny size of its own (256 lanes, N=6, the port's plain racestep):
``correct`` is true, a route with a fault planted in one section makes it
false, and the TF32 control fails the cell's limits. On the card (marked
``cuda``) the control fails them at the cell's own size, on three seeds."""

import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, harness
from conftest import BENCH, REPO

CELL = "racebench-pacejka-n20-b4096.composed"
TINY = "tinyrace.composed"


@pytest.fixture
def tiny_race(tmp_path) -> Path:
    """A copy of the benchmark's folder with the race cell at 256 lanes,
    N=6 and 5-step sweeps beside the real one, its traffic and limits."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    work = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{work['config']}.json").read_text())
    cfg.update(name="tinyrace", N=6, batch=256, sweep_steps=5, grid=dict(cfg["grid"], n_ey=8, n_mu=32))
    (dst / "configs" / "tinyrace.json").write_text(json.dumps(cfg))
    work.update(name=TINY, config="tinyrace", warm_steps=2, check=dict(work["check"], steps=3, groups=2))
    (dst / "workloads" / f"{TINY}.json").write_text(json.dumps(work))
    return dst


class FrozenFilter:
    """The race route with the EKF's covariance left as it was (a section's
    output not written)."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, a):
        return getattr(self.inner, a)

    def step(self, state):
        new = self.inner.step(state)
        return (new[0]._replace(ekP=state[0].ekP),) + new[1:]


def limits(root, cell):
    return json.loads((root / "workloads" / f"{cell}.json").read_text())["check"]["limits"]


def run(root, seed, **kw):
    return harness.run_cell(TINY, seed, 60, False, "cpu", t_start=time.perf_counter(), root=root,
                            max_steps=9, **kw)


def test_race_cell_is_correct_and_its_control_is_not(tiny_race):
    res = run(tiny_race, 2**31 + 31, controls=("tf32",))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 9 * 256
    assert {"z_max", "ekx_max", "ekP_max", "rls_max", "xg_max", "u0_max"} <= set(res["checks"])
    assert not check.verdict(res["_controls"]["tf32"], limits(tiny_race, TINY))[0]


def test_a_fault_in_one_section_makes_the_race_cell_incorrect(tiny_race):
    config = json.loads((tiny_race / "configs" / "tinyrace.json").read_text())
    ctx = SimpleNamespace(config=config, device=torch.device("cpu"), trace=False, seed=2**31 + 32)
    route = harness.plugin("routes", "racestep", tiny_race).make(ctx)
    res = run(tiny_race, 2**31 + 32, route=FrozenFilter(route))
    assert not res["correct"]
    assert res["checks"]["ekP_max"]["value"] > res["checks"]["ekP_max"]["limit"]


@pytest.mark.cuda
def test_race_control_fails_on_the_card(cuda_device):
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        res = harness.run_cell(CELL, seed, 2.0, False, cuda_device, t_start=time.perf_counter(),
                               controls=("tf32",))
        assert res["correct"], res["checks"]
        assert not check.verdict(res["_controls"]["tf32"], limits(BENCH, CELL))[0], res["_controls"]

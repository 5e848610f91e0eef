"""The comparison catches a broken timed path: the harness drives a tiny
cell on the CPU with the program's step broken underneath, and ``correct``
comes out false. The faults a closed-loop sweep on one chip can have: a
step that returns its state unchanged, half of the batch left out, an
answer (one lane's control) altered where it is produced. (There is no
exchange between chips to leave out.)"""

import time

import pytest
import torch

from benchmark import harness

SEED = 2**31 + 4242


def _lanes_mask(t, B, lead_batch):
    m = torch.arange(B) < B // 2
    return m.reshape((B,) + (1,) * (t.dim() - 1)) if lead_batch else m


def stale(route, prev, new):
    if route == "mega":
        c = prev[0]
        return c, new[1], c.u_prev, new[3]
    return prev[0], prev[1], new[2], prev[1].u_prev, new[4]


def half(route, prev, new):
    if route == "mega":
        c0, c1 = prev[0], new[0]
        B = c1.x.shape[-1]
        c = type(c1)(*(torch.where(torch.arange(B) < B // 2, b, a) for a, b in zip(c0, c1)))
        return c, new[1], c.u_prev, new[3]
    B = new[0].shape[0]
    x = torch.where(_lanes_mask(new[0], B, True), new[0], prev[0])
    c = type(new[1])(*(torch.where(_lanes_mask(b, B, True), b, a) for a, b in zip(prev[1], new[1])))
    return x, c, new[2], c.u_prev, new[4]


def altered(route, prev, new):
    if route == "mega":
        u = new[2].clone()
        u[0, 3] += 0.05
        return new[0]._replace(u_prev=u), new[1], u, new[3]
    u = new[3].clone()
    u[3, 0] += 0.05
    return new[0], new[1]._replace(u_prev=u), new[2], u, new[4]


class Broken:
    """The cell's route with its step broken by ``fault``."""

    def __init__(self, inner, name, fault):
        self.inner, self.name, self.fault = inner, name, fault

    def __getattr__(self, a):
        return getattr(self.inner, a)

    def step(self, state):
        return self.fault(self.name, state, self.inner.step(state))


def run(tiny, cell, route_name, fault=None):
    import json
    from types import SimpleNamespace

    work = json.loads((tiny / "workloads" / f"{cell}.json").read_text())
    config = json.loads((tiny / "configs" / f"{work['config']}.json").read_text())
    inner = harness.plugin("routes", route_name, tiny).make(
        SimpleNamespace(config=config, device=torch.device("cpu"), trace=False))
    route = inner if fault is None else Broken(inner, route_name, fault)
    return harness.run_cell(cell, SEED, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                            max_steps=9, route=route)


CELLS = [("tiny4.mega-ee", "mega"), ("tiny5.fused", "fused")]


@pytest.mark.parametrize("cell, route", CELLS)
def test_sound_run_is_correct(tiny, cell, route):
    res = run(tiny, cell, route)
    assert res["correct"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [stale, half, altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell, route", CELLS)
def test_fault_is_not_correct(tiny, cell, route, fault):
    res = run(tiny, cell, route, fault)
    assert not res["correct"], res["checks"]

"""A cell, a route, a metric and a reference added as new files are found
by name, and no file that was there is edited."""

import hashlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

NEW_ROUTE = '''"""A route added as a file: the megastep, reached through this file."""
from pathlib import Path

from benchmark import harness


def make(ctx):
    return harness.plugin("routes", "mega", Path(__file__).resolve().parents[1]).make(ctx)
'''
NEW_METRIC = '''"""Steps completed in the window (a metric added as a file)."""


def read(run):
    return float(run.steps)
'''

SPEED_ROUTE = '''"""A route added as a file: the megastep, with one more output, each
lane's speed after the step."""
from pathlib import Path

import torch

from benchmark import harness


class WithSpeed:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, a):
        return getattr(self.inner, a)

    def outputs(self, state):
        out = self.inner.outputs(state)
        out["speed"] = torch.hypot(out["x"][0], out["x"][1])
        return out


def make(ctx):
    return WithSpeed(harness.plugin("routes", "mega", Path(__file__).resolve().parents[1]).make(ctx))
'''
SPEED_REFERENCE = '''"""A reference added as a file: the tracker's comparison, and the speed
the route reports held against the next state's, which the tracker's
``x_max`` holds against the reference."""
from pathlib import Path

import torch

from benchmark import check, harness

tracker = harness.plugin("reference", "tracker", Path(__file__).resolve().parents[1])
GROUP, setup_from_config, track = tracker.GROUP, tracker.setup_from_config, tracker.track


def compare(ctx, S, table, route, samples, scen, lanes, controls):
    numbers, ctl, info = tracker.compare(ctx, S, table, route, samples, scen, lanes, controls)
    gap = 0.0
    for _, state, _ in samples:
        out = check.take(route.outputs(state), lanes)
        gap = max(gap, float((out["speed"] - torch.hypot(out["x"][0], out["x"][1])).abs().max()))
    numbers["speed_gap"] = gap
    return numbers, ctl, info
'''


def digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tiny):
    before = digest(tiny)
    (tiny / "routes" / "mega_again.py").write_text(NEW_ROUTE)
    (tiny / "metrics" / "steps_done.py").write_text(NEW_METRIC)
    work = json.loads((tiny / "workloads" / "tiny4.mega-ee.json").read_text())
    work.update(name="tiny4.again", route="mega_again")
    (tiny / "workloads" / "tiny4.again.json").write_text(json.dumps(work))
    bench = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["tiny4.again"]})
    res = harness.run_cell("tiny4.again", 2**31 + 5, 60, False, "cpu", t_start=time.perf_counter(),
                           root=tiny, bench=bench, max_steps=7)
    assert res["correct"]
    assert res["metrics"]["steps_done"] == {"value": 7.0, "unit": "steps"}
    assert set(res["metrics"]) == {"steps_done", "solves_per_s", "setup_s"}
    after = digest(tiny)
    assert all(after[p] == h for p, h in before.items())


def add_speed_cell(tiny, reference="tracker_speed"):
    """The route, the reference and the workload of a cell held to its own
    reference, added as new files; returns the cell's name."""
    (tiny / "routes" / "mega_speed.py").write_text(SPEED_ROUTE)
    (tiny / "reference" / "tracker_speed.py").write_text(SPEED_REFERENCE)
    work = json.loads((tiny / "workloads" / "tiny4.mega-ee.json").read_text())
    work["check"]["reference"] = reference
    work["check"]["limits"]["speed_gap"] = 1e-4
    work.update(name="tiny4.speed", route="mega_speed")
    (tiny / "workloads" / "tiny4.speed.json").write_text(json.dumps(work))
    return "tiny4.speed"


class FastLane3:
    """The route with lane 3's reported speed raised where it is produced."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, a):
        return getattr(self.inner, a)

    def outputs(self, state):
        out = self.inner.outputs(state)
        out["speed"] = out["speed"].clone()
        out["speed"][3] += 0.05
        return out


def test_a_reference_added_as_a_file_is_found_by_name(tiny):
    before = digest(tiny)
    cell = add_speed_cell(tiny)
    res = harness.run_cell(cell, 2**31 + 8, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                           max_steps=7)
    assert res["correct"], res["checks"]
    assert res["checks"]["speed_gap"] == {"value": 0.0, "limit": 1e-4}
    assert set(res["checks"]) == {"init_gap", "groups_split", "u0_p99", "u0_max", "x_max", "pred_max",
                                  "doneat_split", "speed_gap"}

    config = json.loads((tiny / "configs" / "tiny4.json").read_text())
    route = harness.plugin("routes", "mega_speed", tiny).make(
        SimpleNamespace(config=config, device=torch.device("cpu"), trace=False, seed=2**31 + 8))
    bad = harness.run_cell(cell, 2**31 + 8, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                           max_steps=7, route=FastLane3(route))
    assert not bad["correct"]
    assert bad["checks"]["speed_gap"]["value"] > 1e-4
    assert all(c["value"] <= c["limit"] for k, c in bad["checks"].items() if k != "speed_gap")
    after = digest(tiny)
    assert all(after[p] == h for p, h in before.items())


def test_a_missing_reference_is_named(tiny):
    cell = add_speed_cell(tiny, reference="no_such_reference")
    with pytest.raises(FileNotFoundError, match="no reference named 'no_such_reference'"):
        harness.run_cell(cell, 2**31 + 9, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                         max_steps=7)


def test_traced_run_reads_the_per_layer_metrics(tiny):
    """A traced run on the CPU: an untraced first half, then the traced
    window; the device is named as in the untraced run, the result holds
    the cell's per-layer metrics that find something to read, and the
    numbers compared come last."""
    bench = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if "baseline4-dyn-n20-b4096.mega-ee" in m.get("workloads", []):
            m["workloads"].append("tiny4.mega-ee")
    res = harness.run_cell("tiny4.mega-ee", 2**31 + 6, 60, True, "cpu", t_start=time.perf_counter(),
                           root=tiny, bench=bench, max_steps=7)
    assert res["correct"]
    assert res["device"]["kind"] == "cpu" and res["device"]["window_s"] > 0
    assert res["attempted"] == 2 * 7 * 256
    assert set(res["metrics"]) == {"admm_iters_mean", "device_idle_pct"}   # no card: no roofline, no peak
    assert res["metrics"]["device_idle_pct"]["value"] == 100.0
    assert 1.0 <= res["metrics"]["admm_iters_mean"]["value"] <= 20.0
    assert "breakdown" in res and list(res)[-1] == "checks"

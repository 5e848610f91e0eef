"""A cell, a route and a metric added as new files are found by name, and
no file that was there is edited."""

import hashlib
import json
import time

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

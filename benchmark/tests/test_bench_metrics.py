"""The metric readers on a synthetic trace that holds a host stall."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, peaks, trace
from benchmark.counts import megastep_kernel
from benchmark.reference import tracker as ref
from conftest import BENCH

MS = 1_000_000   # ns


class Ev:
    def __init__(self, name, kind, start_ms, dur_ms, corr=0, linked=0):
        self._n, self._k, self._s, self._d = name, kind, int(start_ms * MS), int(dur_ms * MS)
        self._c, self._l = corr, linked

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._k}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def stalled_trace():
    """A 10 ms window: five 1 ms megastep kernels back to back at 0-5 ms,
    the host stalled in a span 5-9 ms, one more kernel at 9-10 ms; the
    host span's own projection on the device timeline is not a kernel."""
    evs = [Ev(trace.WINDOW_SPAN, "CPU", 0, 10)]
    evs += [Ev("void megastep_kernel<Dynamic, true, false>(...)", "CUDA", t, 1) for t in (0, 1, 2, 3, 4, 9)]
    evs += [Ev("mega.megastep", "CPU", 5, 4), Ev("aten::empty", "CPU", 6, 2), Ev("mega.megastep", "CUDA", 5, 4)]
    return trace.summarize(evs)


def run_of(tr, step_ms, config="baseline4-dyn-n20-b4096", **kw):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    base = dict(trace=tr, step_ms=np.asarray(step_ms), steps=len(step_ms), lanes=cfg["batch"],
                window_s=0.010, plain_steps=2 * len(step_ms), plain_s=0.010, setup_s=1.5, config=cfg, setup=ref.setup_from_config(cfg),
                iters_sum=8.0 * cfg["batch"] * len(step_ms), conv_sum=0.0, n_cells=1590,
                device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return SimpleNamespace(**base)


def test_trace_union_gaps_and_host_label():
    tr = stalled_trace()
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.006)
    assert len(tr.ops) == 6                       # the span's projection is left out
    assert tr.idle_by_host[0][0] == "mega.megastep > aten::empty"
    assert tr.idle_by_host[0][1] == pytest.approx(0.004)


def test_the_harness_own_device_work_is_left_out():
    """A done-at sum launched inside the harness's own span, and the
    span's projection on the device's timeline, are neither operations nor
    busy time; the program's kernel launched beside it stays."""
    evs = [Ev(trace.WINDOW_SPAN, "CPU", 0, 10),
           Ev("megastep_kernel", "CUDA", 0, 4, linked=11), Ev("aten::empty", "CPU", 0, 0.1, corr=11),
           Ev(trace.OWN_SPAN, "CPU", 0.5, 0.5, corr=20), Ev("aten::add_", "CPU", 0.6, 0.2, corr=21),
           Ev("vectorized_elementwise_kernel<add>", "CUDA", 4, 1, linked=21),
           Ev(trace.OWN_SPAN, "CUDA", 4, 1),
           Ev("vectorized_elementwise_kernel<add>", "CUDA", 6, 1, linked=30), Ev("aten::add_", "CPU", 1.2, 0.2, corr=30)]
    tr = trace.summarize(evs)
    assert [n for n, _, _ in tr.ops] == ["megastep_kernel", "vectorized_elementwise_kernel<add>"]
    assert tr.own_ops == 1
    assert tr.busy_s == pytest.approx(0.005)


def test_idle_share():
    read = harness.plugin("metrics", "device_idle_pct").read
    assert read(run_of(stalled_trace(), [1.0] * 6)) == pytest.approx(40.0)
    assert read(run_of(None, [1.0] * 6)) is None


def test_roofline_share_against_the_counts():
    tr = stalled_trace()
    run = run_of(tr, [1.0] * 6)
    ops, nbytes = megastep_kernel.per_launch(run.setup, run.lanes, 8.0, run.n_cells)
    want = 100 * peaks.bound_s(ops, nbytes, peaks.for_device(run.device_kind)) / 1e-3
    assert harness.plugin("metrics", "megastep_roofline").read(run) == pytest.approx(want)
    assert harness.plugin("metrics", "fused_roofline").read(run) is None   # no such kernel traced
    assert harness.plugin("metrics", "megastep_roofline").read(run_of(tr, [1.0], device_kind="cpu")) is None


def test_p95_of_every_step_holds_the_stall():
    steps = [1.0] * 95 + [5.0] * 5                  # the stall lands in the steps that waited
    read = harness.plugin("metrics", "step_ms_p95").read
    assert read(run_of(None, steps)) == pytest.approx(float(np.percentile(steps, 95)))
    assert read(run_of(None, [1.0] * 90 + [5.0] * 10)) == pytest.approx(5.0)
    assert harness.plugin("metrics", "step_ms_p95.fused").read(run_of(None, steps)) == read(run_of(None, steps))


def test_counts_and_rates():
    run = run_of(stalled_trace(), [1.0] * 6)
    assert harness.plugin("metrics", "solves_per_s").read(run) == pytest.approx(6 * 4096 / 0.010)
    assert harness.plugin("metrics", "launches_per_step.fused").read(run) == pytest.approx(1.0)
    assert harness.plugin("metrics", "admm_iters_mean").read(run) == pytest.approx(8.0)
    mfu = harness.plugin("metrics", "step_mfu").read(run)
    assert 0.0 < mfu < 100.0
    # read from the untraced first half: twice the steps in the same time
    assert mfu == pytest.approx(2 * harness.plugin("metrics", "step_mfu").read(run_of(stalled_trace(), [1.0] * 6,
                                                                                    plain_steps=6)))

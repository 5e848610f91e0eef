"""The frozen counts give the figures the port's smoke script printed at
the cells' shapes (PERF.md §6, the kernel table)."""

import json

import pytest

from benchmark import peaks
from benchmark.counts import fused_kernel, megastep_kernel
from benchmark.reference import tracker as ref
from conftest import BENCH


def setup(name):
    return ref.setup_from_config(json.loads((BENCH / "configs" / f"{name}.json").read_text()))


def test_megastep_per_lane_at_n20():
    ops, nbytes = megastep_kernel.per_launch(setup("baseline4-dyn-n20-b4096"), 1, 7.91, 0)
    assert ops / 1e6 == pytest.approx(0.120, abs=1e-3) and round(nbytes / 1e3, 1) == 4.0


def test_fused_per_lane_at_n20():
    ops, nbytes = fused_kernel.per_launch(setup("baseline4-dyn-n20-b4096"), 1, 20, 0)
    assert ops / 1e6 == pytest.approx(0.213, abs=1e-3) and round(nbytes / 1e3, 1) == 5.2


@pytest.mark.parametrize("counts, ms", [(megastep_kernel, 0.720), (fused_kernel, 0.719)])
def test_config5_bounds_per_launch(counts, ms):
    S = setup("baseline5-dyn-n14-b131072")
    ops, nbytes = counts.per_launch(S, 131072, 60, 1584)
    pk = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert round(peaks.bound_s(ops, nbytes, pk) * 1e3, 3) == ms

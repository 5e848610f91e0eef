"""The comparison's control comes out not correct: the reference computed
with TF32 products (the precision below the configuration's float32 with
TF32 off), put in the program's place from the same carries, fails the
cell's limits, while the program passes them.

On the CPU at a tiny size; on the card at each cell's own size on three
seeds (marked ``cuda``: ``python -m pytest benchmark/tests -m cuda`` on a
machine with the card)."""

import json
import time

import pytest

from benchmark import check, harness
from conftest import BENCH

CELLS = ["baseline4-dyn-n20-b4096.mega-ee", "baseline5-dyn-n14-b131072.mega-fixed60",
         "baseline5-dyn-n14-b131072.fused"]


def limits(cell, root=BENCH):
    return json.loads((root / "workloads" / f"{cell}.json").read_text())["check"]["limits"]


@pytest.mark.parametrize("cell", ["tiny4.mega-ee", "tiny5.mega-fixed60", "tiny5.fused"])
def test_control_fails_at_a_tiny_size(tiny, cell):
    res = harness.run_cell(cell, 2**31 + 77, 60, False, "cpu", t_start=time.perf_counter(), root=tiny,
                           max_steps=9, controls=("tf32",))
    assert res["correct"]
    assert not check.verdict(res["_controls"]["tf32"], limits(cell, tiny))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda_device, cell):
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        res = harness.run_cell(cell, seed, 2.0, False, cuda_device, t_start=time.perf_counter(),
                               controls=("tf32",))
        assert res["correct"], res["checks"]
        assert not check.verdict(res["_controls"]["tf32"], limits(cell))[0], res["_controls"]

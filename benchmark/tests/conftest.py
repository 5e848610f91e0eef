"""Shared fixtures of the benchmark's tests: a copy of the benchmark's
folder with tiny cells beside the real ones (CPU-sized: 256 lanes, short
horizons), and the card for the tests marked ``cuda``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "benchmark"
TINY_CELLS = {
    # tiny cell: (its configuration's source cell, configuration changes, route)
    "tiny4.mega-ee": ("baseline4-dyn-n20-b4096.mega-ee", {"N": 8}, "mega"),
    "tiny5.mega-fixed60": ("baseline5-dyn-n14-b131072.mega-fixed60", {"N": 6, "max_iter": 12}, "mega"),
    "tiny5.fused": ("baseline5-dyn-n14-b131072.fused", {"N": 6, "max_iter": 12}, "fused"),
}


def make_tiny(root: Path) -> Path:
    """Copy the benchmark's folder and BENCHMARK.json under ``root`` and add
    the tiny cells, each with its source cell's traffic and limits."""
    dst = root / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, (src, change, route) in TINY_CELLS.items():
        work = json.loads((BENCH / "workloads" / f"{src}.json").read_text())
        cfg = json.loads((BENCH / "configs" / f"{work['config']}.json").read_text())
        cfg_name = name.split(".")[0]
        cfg.update(name=cfg_name, N=change["N"], batch=256, sweep_steps=5,
                   grid=dict(cfg["grid"], n_ey=8, n_mu=32))
        if "max_iter" in change:
            cfg["solver"]["max_iter"] = change["max_iter"]
        (dst / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
        work.update(name=name, config=cfg_name, route=route, warm_steps=2,
                    check=dict(work["check"], steps=3, groups=2))
        (dst / "workloads" / f"{name}.json").write_text(json.dumps(work))
    return dst


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_tiny(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"

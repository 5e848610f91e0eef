"""The composed race step against the benchmark's plain reference
(``benchmark/reference/race.py``) on the CPU: the port's ``racestep`` on
CPU tensors (its plain version) through the benchmark's route, at N=6 on
128 lanes from random initial states, three steps with seeded noise, each
section held from the program's own inputs; a planted fault that the
comparison must catch; and the reference, with the benchmark modules it
imports, imports nothing of the port or of JAX. This file imports no JAX."""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import check, harness  # noqa: E402
from benchmark.reference import race  # noqa: E402
from benchmark.traffic import Scenarios  # noqa: E402

CELL = "racebench-pacejka-n20-b4096.composed"
B, N, SEED = 128, 6, 2**31 + 1234

# The port's plain racestep and the reference take the same float32
# operations in the same order on the same device, so every section agrees
# to the bit; the bound leaves room only for a product that one side's
# einsum groups otherwise (a few ulps of numbers of order 1-30).
TOL = 1e-5


def cell_config():
    work = json.loads((REPO / "benchmark" / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((REPO / "benchmark" / "configs" / f"{work['config']}.json").read_text())
    config.update(N=N, batch=B)
    return config, work["check"]["limits"]


def scenarios(config):
    """Random initial Frenet states and friction on the lap, seeded."""
    g = torch.Generator().manual_seed(SEED)
    u = torch.rand((7, B), generator=g)
    x0 = torch.stack([1.0 + u[0], 0.1 * (u[1] - 0.5), 0.4 * (u[2] - 0.5), 0.2 * (u[3] - 0.5),
                      30.0 * u[4], 0.4 * (u[5] - 0.5)], dim=1)
    lo, hi = config["grid"]["mu_range"]
    return Scenarios(x0=x0.contiguous(), mu=(lo + (hi - lo) * u[6]).contiguous())


def planted(samples, fault):
    """The driven steps with a fault planted where each step's outputs are
    produced: the RLS update left out (mu-hat and its P as they were), or
    the measurement reported without the step's noise."""
    out = []
    for prev, state, sweep in samples:
        new, noise = state[0], state[5]
        if fault == "rls_skipped":
            state = (new._replace(fr=prev[0].fr),) + state[1:]
        elif fault == "noise_not_added":
            state = state[:4] + (state[4] - noise,) + state[5:]
        else:
            raise ValueError(fault)
        out.append((prev, state, sweep))
    return out


@pytest.fixture(scope="module")
def driven():
    """The route at the cell's numbers (N=6, 128 lanes) from random initial
    states, three steps, and what the comparison needs besides."""
    config, limits = cell_config()
    ctx = SimpleNamespace(config=config, device=torch.device("cpu"), trace=False, seed=SEED)
    route = harness.plugin("routes", "racestep").make(ctx)
    scen = scenarios(config)
    samples, state = [], route.start(scen)
    for _ in range(3):
        prev, state = state, route.step(state)
        samples.append((prev, state, 0))
    S, table = race.setup_from_config(config), race.track(config, "cpu")
    lanes = check.lanes_of([0], B, race.GROUP, "cpu")
    compare = lambda smp: race.compare(ctx, S, table, route, smp, [scen], lanes, ())[0]
    return samples, compare, limits


def test_port_racestep_matches_the_reference(driven):
    samples, compare, limits = driven
    n = compare(samples)
    assert n["lane_steps_compared"] == 3 * B
    assert n["groups_split"] == 0.0 and n["doneat_split"] == 0.0
    for k in ("init_gap", "z_max", "ekx_max", "ekP_max", "rls_max", "xg_max", "u0_max", "pred_max"):
        assert n[k] <= TOL, (k, n[k])
    assert check.verdict(n, limits)[0]


@pytest.mark.parametrize("fault", ["rls_skipped", "noise_not_added"])
def test_comparison_catches_a_planted_fault(driven, fault):
    samples, compare, limits = driven
    ok, rows = check.verdict(compare(planted(samples, fault)), limits)
    assert not ok
    caught = {k for k, v, lim in rows if not v <= lim}
    assert caught >= {"rls_skipped": {"rls_max"}, "noise_not_added": {"z_max"}}[fault], rows


def imports_of(path: Path, seen: set) -> set:
    """Top-level names of every module that ``path`` imports (statements and
    ``importlib.import_module`` of a plain string), following the
    benchmark's own modules into their files."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module
                else [str(node.args[0].value)] if (isinstance(node, ast.Call)
                                                   and getattr(node.func, "attr", "") == "import_module"
                                                   and node.args and isinstance(node.args[0], ast.Constant))
                else [])
        for mod in mods:
            names.add(mod.split(".")[0])
            for f in (REPO.joinpath(*mod.split(".")).with_suffix(".py"),
                      REPO.joinpath(*mod.split("."), "__init__.py")):
                if mod.split(".")[0] == "benchmark" and f.is_file() and f not in seen:
                    seen.add(f)
                    names |= imports_of(f, seen)
    return names


def test_reference_loads_nothing_of_the_port_or_jax():
    names = imports_of(REPO / "benchmark" / "reference" / "race.py", set())
    assert {"torch", "benchmark"} <= names
    assert "autonomous_racing_lpv_mpp_mpc_tpu_torch" not in names
    assert harness.forbidden_modules(names) == []

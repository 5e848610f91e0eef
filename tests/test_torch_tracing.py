"""The port's tracing (``utils.profiling``): on exactly while a profiler
records, the stage spans of the step, the kernels' section counters and the
benchmark's per-layer metrics that read them. The CPU tests run anywhere;
the ``cuda`` tests hold the counters on the card at the benchmark cells'
shapes (every output bitwise the same with the counters on, the counts
against the kernels' own outputs). This file imports no JAX, so the card
runs it with ``--noconftest``."""

import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness, program  # noqa: E402
from benchmark.reference.track import track_table  # noqa: E402
from benchmark.traffic import ScenarioStream  # noqa: E402

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs, mpc_init, mpc_step_batched, plant_step  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep_init  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import profiling  # noqa: E402

CSRC = REPO / "autonomous_racing_lpv_mpp_mpc_tpu_torch" / "ops" / "csrc"


def host_spans(prof) -> dict:
    """{name: [(start_ns, end_ns)]} of the session's host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU"):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def small_batch(B=4, N=6):
    track = oval_track(device="cpu")
    x0 = torch.zeros((B, 6))
    x0[:, 0] = 1.0
    x0[:, 5] = torch.linspace(-0.1, 0.1, B)
    return VehicleParams(), MPCConfig(N=N), track, x0


def test_tracing_is_off_without_a_profiler():
    assert profiling.tracing() is False
    on = profiling.tracing()
    assert profiling.span("mpc.prepare", on) is profiling.span("plant.step", on)
    with profiling.span("mpc.prepare", on) as s:
        assert s is None
    assert profiling.section_buffer("megastep_kernel", "cpu", on) is None


def test_fused_route_step_records_its_stage_spans_inside_the_callers():
    p, cfg, track, x0 = small_batch()
    scfg = SolverConfig(max_iter=12, backend="fused")
    x_ref = constant_refs(cfg, 1.2, device="cpu")
    carry = mpc_init(p, cfg, track, x0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing() is True
        with record_function("test.outer"):
            u, carry, _ = mpc_step_batched(p, cfg, scfg, track, x0, x_ref, carry)
            plant_step(p, cfg, track, x0, u, n_sub=4)
    assert profiling.tracing() is False
    spans = host_spans(prof)
    (o0, o1), = spans["test.outer"]
    for name in ("mpc.prepare", "mpc.post", "plant.step"):
        assert len(spans[name]) == 1, name
        s0, s1 = spans[name][0]
        assert o0 <= s0 <= s1 <= o1, name
    assert spans["mpc.prepare"][0][1] <= spans["mpc.post"][0][0] <= spans["plant.step"][0][0]


def test_megastep_init_records_its_span_around_mpc_init():
    p, cfg, track, x0 = small_batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        megastep_init(p, cfg, track, x0)
    spans = host_spans(prof)
    (m0, m1), = spans["megastep.init"]
    (i0, i1), = spans["mpc.init"]
    assert m0 <= i0 <= i1 <= m1


def enum_names(source: str, enum: str, prefix: str, last: str) -> tuple:
    """The entries of a C++ enum, its prefix taken off, lower case, the
    count at its end checked and left out."""
    body = re.search(rf"enum {enum} : int \{{(.*?)\}};", (CSRC / source).read_text(), re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == last
    return tuple(n.removeprefix(prefix).lower() for n in names[:-1])


def test_section_table_is_the_kernels_enum_in_order():
    assert enum_names("group_core.cuh", "Sec", "SEC_", "N_SEC") == profiling.SECTIONS


def test_race_section_table_is_the_racesteps_enum_in_order():
    assert enum_names("racestep_kernel.cu", "RaceSec", "RSEC_", "N_RACE_SEC") == profiling.RACE_SECTIONS


def test_racestep_counts_its_own_sections_after_the_cores():
    assert profiling.section_names("racestep_kernel") == profiling.SECTIONS + profiling.RACE_SECTIONS
    assert profiling.section_names("megastep_kernel") == profiling.SECTIONS


def test_section_buffer_is_one_per_kernel_and_device_and_reads_as_totals(monkeypatch):
    monkeypatch.setattr(profiling, "_SECTION_BUFFERS", {})
    assert profiling.sections("megastep_kernel") == {}
    buf = profiling.section_buffer("megastep_kernel", "cpu", True)
    assert buf.dtype == torch.int64 and buf.shape == (len(profiling.SECTIONS),) and int(buf.sum()) == 0
    assert profiling.section_buffer("megastep_kernel", torch.device("cpu"), True) is buf
    assert profiling.section_buffer("fused_kernel", "cpu", True) is not buf
    buf += torch.arange(len(profiling.SECTIONS))
    assert profiling.sections("megastep_kernel") == {n: i for i, n in enumerate(profiling.SECTIONS)}
    assert set(profiling.sections("fused_kernel").values()) == {0}
    race = profiling.section_buffer("racestep_kernel", "cpu", True)
    assert race.shape == (len(profiling.SECTIONS) + len(profiling.RACE_SECTIONS),)
    race += 1
    assert profiling.sections("racestep_kernel") == dict.fromkeys(profiling.section_names("racestep_kernel"), 1)
    profiling.reset_sections()
    assert set(profiling.sections("megastep_kernel").values()) == {0}
    assert set(profiling.sections("racestep_kernel").values()) == {0}


FAKE = dict(prepare=700, factor=900, sweep=3000, stage_pass=2000, vote=1000, finish=300, plant=100,
            lane_steps=2, lane_iters=30, lane_doneat=15, measure=400, ekf=1200, rls=100, refs=300)
READERS = {   # metric: (the kernel it reads, its value on FAKE)
    "megastep_admm_kcycles": ("megastep_kernel", 3.0),
    "megastep_stage_pass_kcycles": ("megastep_kernel", 1.0),
    "megastep_admm_useful_pct": ("megastep_kernel", 50.0),
    "fused_admm_kcycles": ("fused_kernel", 3.0),
    "racestep_admm_kcycles": ("racestep_kernel", 3.0),
    "racestep_estimate_kcycles": ("racestep_kernel", 1.0),
}


@pytest.mark.parametrize("case", ["counts", "no_counts", "no_sections"])
@pytest.mark.parametrize("metric", list(READERS))
def test_section_reader(metric, case, monkeypatch):
    kernel, want = READERS[metric]
    if case == "no_sections":      # a port that keeps no section counters
        monkeypatch.delattr(profiling, "sections")
    else:
        fake = FAKE if case == "counts" else {}
        monkeypatch.setattr(profiling, "sections", lambda k: dict(fake) if k == kernel else {})
    value = harness.plugin("metrics", metric).read(SimpleNamespace())
    assert value == (pytest.approx(want) if case == "counts" else None)


@pytest.mark.parametrize("case", ["fits", "no_fits", "no_reader"])
@pytest.mark.parametrize("metric,kernel", [("megastep_clusters_per_wave", "megastep_kernel"),
                                           ("fused_clusters_per_wave", "fused_kernel"),
                                           ("racestep_clusters_per_wave", "racestep_kernel")])
def test_clusters_per_wave_reader(metric, kernel, case, monkeypatch):
    """The occupancy metrics read the fewest clusters per wave the kernel's
    launches kept, and nothing where it kept none or the port has no such
    reader (the parent of the compact operand slices)."""
    if case == "no_reader":
        monkeypatch.delattr(profiling, "clusters_per_wave")
    else:
        fake = {(0, 61_056): 45, (0, 86_784): 30} if case == "fits" else {}
        monkeypatch.setattr(profiling, "clusters_per_wave", lambda k: dict(fake) if k == kernel else {})
    value = harness.plugin("metrics", metric).read(SimpleNamespace())
    assert value == (30.0 if case == "fits" else None)


def test_clusters_per_wave_is_empty_before_the_library_loads():
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        _cuda.library.cache_clear()
        assert profiling.clusters_per_wave("megastep_kernel") == {}
    assert profiling.clusters_per_wave("no_such_kernel") == {}


# ---- on the card, at the benchmark cells' shapes -----------------------------

CARD_CELLS = {   # cell: steps stepped twice, with the counters off and on
    "baseline4-dyn-n20-b4096.mega-ee": 6,
    "baseline5-dyn-n14-b131072.mega-fixed60": 2,
    "baseline5-dyn-n14-b131072.fused": 2,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def drive(route, state, steps):
    outs = []
    for _ in range(steps):
        state = route.step(state)
        outs.append(route.outputs(state))
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CARD_CELLS))
def test_section_counters_leave_outputs_bitwise_and_count_the_lanes(cell, cuda_device, monkeypatch):
    bench = REPO / "benchmark"
    work = json.loads((bench / "workloads" / f"{cell}.json").read_text())
    config = json.loads((bench / "configs" / f"{work['config']}.json").read_text())
    program.build_kernels()
    route = harness.plugin("routes", work["route"]).make(SimpleNamespace(config=config, device=cuda_device,
                                                                         trace=False))
    length = float(track_table(config["track"], float(config["track_ds"]), cuda_device)["length"])
    state0 = route.start(ScenarioStream(config, 2**31 + 17, cuda_device, length).next())
    steps, B, sv = CARD_CELLS[cell], int(config["batch"]), config["solver"]

    off = drive(route, state0, steps)
    monkeypatch.setattr(profiling, "tracing", lambda: True)
    profiling.reset_sections()
    launches0 = route.launches()
    on = drive(route, state0, steps)
    launches = route.launches() - launches0
    tot = profiling.sections(route.kernel)

    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
    assert launches == steps
    assert tot["lane_steps"] == B * launches
    assert tot["lane_doneat"] == int(sum(float(o["iters"].double().sum()) for o in on))
    if sv["early_exit"]:
        assert tot["lane_doneat"] <= tot["lane_iters"] <= sv["max_iter"] * tot["lane_steps"]
    else:
        assert tot["lane_iters"] == sv["max_iter"] * tot["lane_steps"]
    for name in ("prepare", "factor", "sweep", "stage_pass", "vote", "finish"):
        assert tot[name] > 0, name
    assert (tot["plant"] > 0) == (route.kernel == "megastep_kernel")


@pytest.mark.cuda
def test_racestep_section_counters_leave_outputs_bitwise_and_count_the_lanes(cuda_device, monkeypatch):
    """The race cell's racestep: the traced instantiation's outputs bitwise
    the untraced one's from the same start and noise stream, its counters
    the active lanes'."""
    bench = REPO / "benchmark"
    work = json.loads((bench / "workloads" / "racebench-pacejka-n20-b4096.composed.json").read_text())
    config = json.loads((bench / "configs" / f"{work['config']}.json").read_text())
    program.build_kernels()
    ctx = SimpleNamespace(config=config, device=cuda_device, trace=False, seed=2**31 + 17)
    length = float(track_table(config["track"], float(config["track_ds"]), cuda_device)["length"])
    scen = ScenarioStream(config, 2**31 + 17, cuda_device, length).next()
    steps, B, sv = 4, int(config["batch"]), config["solver"]

    def run():
        route = harness.plugin("routes", work["route"]).make(ctx)   # the noise stream from its start
        return route, drive(route, route.start(scen), steps)

    _, off = run()
    monkeypatch.setattr(profiling, "tracing", lambda: True)
    profiling.reset_sections()
    launches0 = harness.plugin("routes", work["route"]).make(ctx).launches()
    route, on = run()
    tot = profiling.sections(route.kernel)

    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
    assert route.launches() - launches0 == steps
    assert tot["lane_steps"] == B * steps
    assert tot["lane_doneat"] == int(sum(float(o["iters"].double().sum()) for o in on))
    assert tot["lane_doneat"] <= tot["lane_iters"] <= sv["max_iter"] * tot["lane_steps"]
    for name in profiling.SECTIONS[:7] + profiling.RACE_SECTIONS:
        assert tot[name] > 0, name

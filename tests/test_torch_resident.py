"""The group kernels' two launch paths (``ops/csrc/arl_sync.cuh``,
``launch_group``): a 128-lane group as a thread block cluster voting
through distributed shared memory, or, where the launch votes, holds more
groups than the card holds clusters at once and fits the card whole, as 8
co-resident blocks of a cooperative launch voting through device memory.
The CPU tests hold the fit table's reader; the ``cuda`` tests hold the
co-resident launch's outputs bitwise to the clustered launch's at the
benchmark cells' shapes. This file imports no JAX, so the card runs it
with ``--noconftest``."""

import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness, program  # noqa: E402
from benchmark.reference.track import track_table  # noqa: E402
from benchmark.traffic import ScenarioStream  # noqa: E402

from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import profiling  # noqa: E402

CSRC = REPO / "autonomous_racing_lpv_mpp_mpc_tpu_torch" / "ops" / "csrc"
SMEM20 = fk.launch_shape(20).smem_bytes


class FakeLibrary:
    """``arl_cluster_fits`` over a fixed table: {kernel: [(device, smem,
    groups, resident)]}."""

    def __init__(self, table):
        self.table = table

    def arl_cluster_fits(self, name, out, cap):
        rows = self.table.get(name.decode(), [])
        for i, row in enumerate(rows[:cap]):
            out[4 * i:4 * i + 4] = list(row)
        return len(rows)


def fake_library(monkeypatch, table):
    lib = FakeLibrary(table)
    load = lambda: lib  # noqa: E731
    load.cache_info = lambda: SimpleNamespace(currsize=1)
    monkeypatch.setattr(_cuda, "library", load)


def test_group_fits_keeps_each_path_apart(monkeypatch):
    fake_library(monkeypatch, {"racestep_kernel": [(0, SMEM20, 30, 0), (0, SMEM20, 33, 1),
                                                   (0, SMEM20, 34, 1), (0, 61_056, 45, 0)]})
    assert profiling.group_fits("racestep_kernel") == {(0, SMEM20, False): 30, (0, SMEM20, True): 33,
                                                       (0, 61_056, False): 45}
    assert profiling.clusters_per_wave("racestep_kernel") == {(0, SMEM20): 30, (0, 61_056): 45}
    assert profiling.group_fits("megastep_kernel") == {}


@pytest.mark.parametrize("metric,kernel", [("megastep_clusters_per_wave", "megastep_kernel"),
                                           ("racestep_clusters_per_wave", "racestep_kernel"),
                                           ("fused_clusters_per_wave", "fused_kernel")])
def test_co_resident_launch_reads_as_the_groups_it_holds_at_once(metric, kernel, monkeypatch):
    """A run whose only launches at a shape were co-resident reads the
    groups the card holds at once through the benchmark's metric; one that
    also launched the shape as clusters reads the fewer."""
    fake_library(monkeypatch, {kernel: [(0, SMEM20, 33, 1)]})
    assert harness.plugin("metrics", metric).read(SimpleNamespace()) == 33.0
    fake_library(monkeypatch, {kernel: [(0, SMEM20, 33, 1), (0, SMEM20, 30, 0)]})
    assert harness.plugin("metrics", metric).read(SimpleNamespace()) == 30.0


def test_group_fits_reads_at_most_the_buffer(monkeypatch):
    fake_library(monkeypatch, {"megastep_kernel": [(0, 1_000 + i, 30, i % 2) for i in range(70)]})
    fits = profiling.group_fits("megastep_kernel")
    assert len(fits) == 64 and fits[(0, 1_063, True)] == 30 and (0, 1_064, False) not in fits


def test_group_kernels_launch_through_the_path_choice():
    """Every uncached group-kernel launch goes through launch_group with
    its clustered instantiation and the co-resident one (the same template
    arguments and the vote slots) and the launch's early exit; only the
    cached megastep (max_all, a cluster's) stays clustered."""
    calls = {}
    for src in ("megastep_kernel.cu", "racestep_kernel.cu", "fused_kernel.cu"):
        text = (CSRC / src).read_text()
        calls[src] = (re.findall(r"launch_group\((\w+)<([^>]*)>,\s*(\w+)<([^>]*)>", text),
                      re.findall(r"launch_clustered\((\w+)<([^>]*)>", text))
    for src, (grouped, clustered) in calls.items():
        assert len(grouped) == 2, src             # traced and untraced
        for k1, a1, k2, a2 in grouped:
            assert k1 == k2 == src[:-3] and a2 == a1 + ", VoteSlot*", (a1, a2)
    assert calls["megastep_kernel.cu"][1] == [("megastep_kernel", "M, SM, true, false")]
    assert calls["racestep_kernel.cu"][1] == calls["fused_kernel.cu"][1] == []
    for src in calls:
        assert (CSRC / src).read_text().count("P.C.early_exit != 0") == 2, src


# ---- on the card, at the benchmark cells' shapes -----------------------------

CELLS = ["baseline4-dyn-n20-b4096.mega-ee", "racebench-pacejka-n20-b4096.composed"]
CUT = 3_840      # 30 groups: one wave of clusters at N=20
STEPS = 24
SEED = 2**31 + 29


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


class Cell:
    """One cell's step at its configuration, callable on the first ``nb``
    lanes of its start (each lane's carry, parameters and noise cut to
    them)."""

    def __init__(self, name, device):
        bench = REPO / "benchmark"
        work = json.loads((bench / "workloads" / f"{name}.json").read_text())
        config = json.loads((bench / "configs" / f"{work['config']}.json").read_text())
        program.build_kernels()
        ctx = SimpleNamespace(config=config, device=device, trace=False, seed=SEED)
        self.route = harness.plugin("routes", work["route"]).make(ctx)
        length = float(track_table(config["track"], float(config["track_ds"]), device)["length"])
        scen = ScenarioStream(config, SEED, device, length).next()
        self.B, self.race = int(config["batch"]), self.route.kernel == "racestep_kernel"
        self.start = self.route.start(scen)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        sigma = self.route.sigma if self.race else 0.0
        self.noise = sigma * torch.randn((STEPS, 6, self.B), generator=gen, device=device)

    def carry(self, nb):
        c = self.start[0]
        return type(c)(*(t[..., :nb].contiguous() for t in c))

    def step(self, carry, nb, k):
        r = self.route
        if self.race:
            new, u0, diag, z = r.rk.racestep(r.cfg, r.scfg, r.track, r.prm[:, :nb].contiguous(), r.table,
                                             carry, self.noise[k, :, :nb].contiguous(),
                                             self.start[1][:nb].contiguous(), r.q, r.r, **r.kw)
            outs = dict(new._asdict(), u0=u0, diag=diag, z=z)
        else:
            prm = self.start[1][:, :nb].contiguous()
            new, u0, diag = r.mk.megastep(r.cfg, r.scfg, r.track, prm, r.x_ref, carry, n_sub=r.n_sub,
                                          sim_tire=r.sim_tire)
            outs = dict(new._asdict(), u0=u0, diag=diag)
        return new, outs

    def launches(self):
        return self.route.launches()


def fit(kernel, resident):
    dev = torch.cuda.current_device()
    return profiling.group_fits(kernel).get((dev, SMEM20, resident))


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_co_resident_outputs_are_the_clustered_launchs_bitwise(cell, traced, cuda_device, monkeypatch):
    """B=4,096 (32 groups, co-resident) against the same start cut to its
    first 3,840 lanes (30 groups, one wave of clusters), STEPS steps each on
    its own carry: every output of those lanes bitwise equal, groups
    leaving ADMM at different iterations."""
    if traced:
        monkeypatch.setattr(profiling, "tracing", lambda: True)
    c = Cell(cell, cuda_device)
    full, cut = c.carry(c.B), c.carry(CUT)
    exits = set()
    for k in range(STEPS):
        full, fo = c.step(full, c.B, k)
        cut, co = c.step(cut, CUT, k)
        for name, t in co.items():
            assert torch.equal(fo[name][..., :CUT], t), (k, name)
        exits |= set(fo["diag"][4].reshape(-1, fk.GROUP).amax(dim=1).tolist())
    torch.cuda.synchronize()
    assert len(exits) > 1, exits
    assert fit(c.route.kernel, True) is not None and fit(c.route.kernel, False) is not None


@pytest.mark.cuda
def test_fit_table_reads_the_groups_each_path_holds_at_once(cuda_device):
    """At N=20: the co-resident launch (B=4,096) holds the card's block
    places over 8 (two blocks an SM: 264 / 8 = 33 on the H100), the
    clustered one (B=256) the clusters the card holds at once (30)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for cell in CELLS:
        c = Cell(cell, cuda_device)
        c.step(c.carry(c.B), c.B, 0)
        c.step(c.carry(256), 256, 0)
        torch.cuda.synchronize()
        res, clu = fit(c.route.kernel, True), fit(c.route.kernel, False)
        assert res == 2 * sms // 8 and 0 < clu < res, (cell, res, clu)
        if sms == 132:
            assert (res, clu) == (33, 30)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_back_to_back_co_resident_launches_give_one_launchs_outputs(cell, cuda_device):
    """200 launches in a row on the same inputs, one synchronisation after
    them: each gives the outputs of a single launch (the vote's slots at
    rest between launches, whatever the launches before)."""
    c = Cell(cell, cuda_device)
    carry = c.carry(c.B)
    _, one = c.step(carry, c.B, 0)
    torch.cuda.synchronize()
    n0 = c.launches()
    runs = [c.step(carry, c.B, 0)[1] for _ in range(200)]
    torch.cuda.synchronize()
    assert c.launches() - n0 == 200
    for i, outs in enumerate(runs):
        for name, t in one.items():
            assert torch.equal(outs[name], t), (i, name)
    assert fit(c.route.kernel, True) == 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count // 8

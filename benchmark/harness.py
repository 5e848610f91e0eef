"""One run of one cell: set-up, warm-up, the measured window, the metrics
and the comparison that decides ``correct``.

Everything a cell needs is found by name: its file ``workloads/<cell>.json``
(configuration, route, warm-up, sampling, limits), the configuration
``configs/<config>.json``, the route ``routes/<route>.py``, the plain
reference ``reference/<name>.py`` that ``check.reference`` names
(``tracker`` where it names none), and one reader per metric,
``metrics/<metric>.py``, for the metrics that ``BENCHMARK.json`` lists for
the cell.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, trace
from benchmark.traffic import ScenarioStream

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "autonomous_racing_lpv_mpp_mpc_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(kind: str, name: str, root: Path = HERE):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind.rstrip('s')} named {name!r} ({path})")
    mod_name = f"benchmark_{kind}_{hashlib.sha1(str(path).encode()).hexdigest()[:12]}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is a JAX
    package's, compared whole (the port's own name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json that the
    cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


class Reservoir:
    """A uniform sample of ``k`` of the window's steps, drawn from the seed
    (Li's algorithm L: one draw per replacement, none per step)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.i = k, rng, [], 0
        self.w = math.exp(math.log(rng.random()) / k) if k else 0.0
        self.next = k + self._skip() if k else math.inf

    def _skip(self) -> int:
        return int(math.floor(math.log(self.rng.random()) / math.log(1.0 - self.w))) if self.w < 1 else 0

    def offer(self, item_fn):
        i = self.i
        self.i += 1
        if i < self.k:
            self.items.append(item_fn())
        elif i == self.next:
            self.items[int(self.rng.integers(self.k))] = item_fn()
            self.w *= math.exp(math.log(self.rng.random()) / self.k)
            self.next = i + 1 + self._skip()


def sample_groups(B: int, n: int, group: int, rng: np.random.Generator) -> list:
    """``n`` of the batch's ``group``-lane groups drawn from the seed, the
    first and the last among them."""
    n_g = -(-B // group)
    if n >= n_g:
        return list(range(n_g))
    rest = rng.choice(np.arange(1, n_g - 1), size=n - 2, replace=False)
    return sorted({0, n_g - 1, *(int(g) for g in rest)})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Per-step boundaries on the stream: CUDA events on the card (a host
    stall lands in the step that waited for it), host times on the CPU."""

    def __init__(self, device, n: int):
        self.cuda = device.type == "cuda"
        self.marks = [self._new() for _ in range(n)] if self.cuda else []
        self.used = 0

    def _new(self):
        return torch.cuda.Event(enable_timing=True)

    def mark(self):
        if not self.cuda:
            self.marks.append(time.perf_counter())
        else:
            if self.used == len(self.marks):
                self.marks.extend(self._new() for _ in range(1024))
            self.marks[self.used].record()
        self.used += 1

    def intervals_ms(self) -> np.ndarray:
        if not self.cuda:
            return np.diff(np.asarray(self.marks)) * 1e3
        m = self.marks[:self.used]
        return np.asarray([a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])], dtype=np.float64)


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, device, *, t_start: float,
             root: Path = HERE, bench: dict | None = None, route=None, max_steps: int | None = None,
             controls: tuple = ()) -> dict:
    """Run one cell and return its result (the last line's object).

    ``route``: a route object to drive instead of the cell's own (tests
    plant faults this way); ``max_steps``: end the window after this many
    steps as well (CPU tests); ``controls``: precisions ("tf32") at which
    the reference is also put in the program's place, from the same carries
    (the control of the comparison; its numbers under ``_controls``);
    ``root``: the benchmark's folder, whose ``BENCHMARK.json`` sits in its
    parent."""
    device = torch.device(device)
    root = Path(root)
    bench = load_json(root.parent / "BENCHMARK.json") if bench is None else bench
    work = load_json(root / "workloads" / f"{cell}.json")
    config = load_json(root / "configs" / f"{work['config']}.json")
    sample = work["check"]
    ref = plugin("reference", sample.get("reference", "tracker"), root)
    S = ref.setup_from_config(config)
    table = ref.track(config, device)
    length = float(table["length"])
    B = int(config["batch"])
    sweep_steps = int(config["sweep_steps"])
    rng = np.random.default_rng(seed)
    ctx = SimpleNamespace(config=config, device=device, trace=trace_on, seed=seed)
    if device.type == "cuda":
        from benchmark import program

        program.build_kernels()
    route = plugin("routes", work["route"], root).make(ctx) if route is None else route

    # warm-up: the cell's own shapes, a sweep start and a few steps, with
    # the sample kept as the window keeps it (the allocator's pool grows here)
    stream = ScenarioStream(config, seed, device, length)
    # the done-at sums that the traced run's per-layer metrics read; the
    # untraced run adds no device work of its own to the program's steps
    acc = torch.zeros((2, B), dtype=torch.float32, device=device) if trace_on else None
    held = []
    state = route.start(stream.next())
    n_warm = int(work["warm_steps"])
    nonfinite = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n_warm):
        prev = state
        state = route.step(prev)
        if acc is not None:
            route.accumulate(acc, state)
        if i < int(sample["steps"]):
            held.append((prev, state))
    nonfinite += _nonfinite_lanes(route, state)
    _sync(device)
    if trace_on:
        # a first profiler session here, so that the profiler's start-up
        # and first records fall outside the window's session
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities):
            for _ in range(2):
                state = route.step(state)
            _sync(device)
    t0 = time.perf_counter()
    for _ in range(2):
        state = route.step(state)
    _sync(device)
    t_step = max((time.perf_counter() - t0) / 2, 1e-5)
    del held, state, prev
    if acc is not None:
        acc.zero_()
    clock = Clock(device, int(seconds / t_step * 1.5) + 64)
    stream = ScenarioStream(config, seed, device, length)
    reservoir = Reservoir(int(sample["steps"]) - 1, rng)
    scen, first = [], []
    nonfinite.zero_()

    def keep(k, prev, state):
        """After each step of the measured window: the done-at sums (traced
        run) and the sample for the comparison."""
        if acc is not None:
            with trace.span(ctx, trace.OWN_SPAN):
                route.accumulate(acc, state)
        sweep = len(scen) - 1
        if k == 0:
            first.append((prev, state, sweep))
        else:
            reservoir.offer(lambda: (prev, state, sweep))

    def drive(secs, clock=None, keep=None):
        """Step fresh sweeps of the stream for ``secs`` seconds (or
        ``max_steps`` steps), a new sweep every ``sweep_steps``; the card is
        synchronised at the end. Returns the steps and the seconds."""
        scen.append(stream.next())
        t0 = time.perf_counter()
        if clock is not None:
            clock.mark()
        state = route.start(scen[-1])
        k = 0
        while True:
            prev = state
            state = route.step(prev)
            if keep is not None:
                keep(k, prev, state)
            if clock is not None:
                clock.mark()
            k += 1
            done = time.perf_counter() - t0 >= secs or (max_steps is not None and k >= max_steps)
            if k % sweep_steps == 0 or done:
                with trace.span(ctx, trace.OWN_SPAN):
                    nonfinite.add_(_nonfinite_lanes(route, state))
            if done:
                break
            if k % sweep_steps == 0:
                scen.append(stream.next())
                state = route.start(scen[-1])
        _sync(device)
        return k, time.perf_counter() - t0

    _sync(device)
    setup_s = time.perf_counter() - t_start
    plain_steps, plain_s, prof = 0, 0.0, None
    if trace_on:
        # the traced run's first half runs untraced, so that the whole
        # step's rate (step_mfu) bears no cost of the profiler's; its second
        # half is the traced window
        ctx.trace = False
        plain_steps, plain_s = drive(seconds / 2)
        ctx.trace = True
        prof = profile(activities=activities)
        prof.__enter__()
    launches0 = route.launches()
    with torch.profiler.record_function(trace.WINDOW_SPAN) if trace_on else contextlib.nullcontext():
        steps, window_s = drive(seconds / 2 if trace_on else seconds, clock, keep)
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launches = route.launches() - launches0
    step_ms = clock.intervals_ms()
    conv_sum, iters_sum = (float(v) for v in acc.double().sum(dim=1)) if acc is not None else (None, None)
    del acc, clock

    tr = trace.summarize(prof.profiler.kineto_results.events()) if prof is not None else None
    del prof

    # the comparison, once the window has closed and its state is freed
    samples = first + reservoir.items
    groups = sample_groups(B, int(sample["groups"]), ref.GROUP, rng)
    lanes = check.lanes_of(groups, B, ref.GROUP, device)
    numbers, ctl, info = ref.compare(ctx, S, table, route, samples, scen, lanes, controls)
    limits = sample.get("limits", {})
    correct, rows = check.verdict(numbers, limits)
    if not limits:
        correct = False

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = SimpleNamespace(cell=cell, config=config, setup=S, lanes=B, steps=steps, window_s=window_s,
                          plain_steps=plain_steps, plain_s=plain_s, setup_s=setup_s, step_ms=step_ms,
                          iters_sum=iters_sum, trace=tr, n_cells=int(table["kappa"].shape[0]),
                          device_kind=kind)
    metrics = {}
    for m in cell_metrics(bench, cell, "per_layer" if trace_on else "end_to_end"):
        value = plugin("metrics", m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": int(work["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": (plain_steps + steps) * B,
              "failed": int(nonfinite.item()), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_by_host[:10]}
        if route.kernel and len(tr.durations(route.kernel)) != launches:
            log(f"[trace] the profiler recorded {len(tr.durations(route.kernel))} launches of "
                f"{route.kernel} of the {launches} the window issued")
        log(f"[trace] {tr.own_ops} device ops of the benchmark's own left out of the window's "
            f"{len(tr.ops) + tr.own_ops}; untraced first half: {plain_steps} steps in {plain_s:.4f} s")
    log(f"[run] {cell} seed {seed}: {steps} steps of {B} lanes in {window_s:.4f} s, set-up "
        f"{setup_s:.3f} s, {len(scen)} sweeps, kernel launches {launches}")
    if iters_sum is not None:
        lane_steps = max(1, steps * B)
        log(f"[run] over the traced window: converged share {conv_sum / lane_steps:.6f}, done-at mean "
            f"{iters_sum / lane_steps:.4f} (each lane's own)")
    log("[check] info " + json.dumps(info))
    log("[check] " + json.dumps({k: v for k, v in numbers.items()}))
    result["_numbers"] = numbers
    result["_controls"] = ctl
    # the numbers compared, each beside its limit: the line's last key
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def _nonfinite_lanes(route, state):
    """Lanes whose state is not finite (a lane that goes non-finite stays
    so until its sweep ends, so each sweep's end counts it once)."""
    return (~torch.isfinite(route.outputs(state)["x"])).any(dim=0).sum()


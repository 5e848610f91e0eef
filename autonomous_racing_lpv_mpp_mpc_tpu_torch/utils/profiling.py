"""Profiling and timing tools (the JAX package's ``utils/profiling.py``;
SURVEY.md §5 "Tracing / profiling").

- :func:`timed`: best wall time over a few calls, the card synchronised
  around each call (PyTorch returns before the device finishes).
- :func:`trace_to`: a ``torch.profiler`` session over a region, written as a
  Chrome / Perfetto JSON trace into a directory.
- The port's own tracing, on exactly while a ``torch.profiler`` session
  records (:func:`tracing`; a ``trace_to`` region, a benchmark's traced
  window): host spans around the stages of the step (:func:`span`:
  ``mpc.prepare``, ``mpc.post``, ``mpc.init``, ``plant.step``,
  ``megastep.check`` / ``.refs`` / ``.alloc`` / ``.init``,
  ``racestep.check`` / ``.refs`` / ``.alloc``, ``fused_kernel.layout`` /
  ``.alloc``, ``cuda.launch.<C entry>``), on the profiler's clock and kept
  in its session, and the section counters inside the megastep, racestep
  and fused kernels (:data:`SECTIONS`, the racestep's with
  :data:`RACE_SECTIONS` after them; read by :func:`sections`). Off, a
  wrapper call costs one flag read and its launch one null pointer.
- :func:`clusters_per_wave`: how many 128-lane groups of a group kernel
  the card holds at once, as its launches found (kept whether or not a
  profiler records); :func:`group_fits` the same per launch path, clustered
  or co-resident.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from typing import Any, Callable, Dict, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_flatten

# The kernels' section counters, in the order of ops/csrc/group_core.cuh's
# Sec: clock64 cycles of each active lane's thread 0 per section (prepare:
# schedule, bounds, stage builds, warm start; factor: the Riccati factor
# and the first linear terms; sweep: each ADMM iteration's backward sweep
# and forward rollout; stage_pass: its z-update and next linear terms;
# vote: the termination test and the 128-lane vote with its wait; finish:
# residuals, accept or limp-home, output stores; plant: the megastep's
# Euler sub-steps), then the active lane-steps, the ADMM iterations they
# executed and their own done-ats, summed over launches.
SECTIONS = ("prepare", "factor", "sweep", "stage_pass", "vote", "finish", "plant",
            "lane_steps", "lane_iters", "lane_doneat")
# The racestep's own sections, which run before the core's and follow them
# in its counters, in the order of ops/csrc/racestep_kernel.cu's RaceSec:
# the measurement with its noise, the EKF, the friction RLS, and the
# reference rows with the stores of the four and the group barrier that
# closes them.
RACE_SECTIONS = ("measure", "ekf", "rls", "refs")

_NO_SPAN = contextlib.nullcontext()
_SECTION_BUFFERS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def tracing() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) session records
    now: the flag the profiler sets on start and clears on stop. A wrapper
    reads it once per call and hands it to its spans and its launch."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, on: bool):
    """A host span ``name`` (``record_function``: on the profiler's clock,
    shared with its device trace) when ``on``, else the shared null
    context."""
    return _autograd_profiler.record_function(name) if on else _NO_SPAN


def section_names(kernel: str) -> Tuple[str, ...]:
    """The counters of ``kernel``, in the order its launch adds them."""
    return SECTIONS + RACE_SECTIONS if kernel == "racestep_kernel" else SECTIONS


def section_buffer(kernel: str, device, on: bool):
    """The section counters of ``kernel`` ("megastep_kernel",
    "fused_kernel", "racestep_kernel") on ``device`` when ``on`` (allocated
    zeroed on first use, then summed into by every traced launch: each
    block of the kernel adds its lanes' sums), else None: the launch passes
    a null pointer."""
    if not on:
        return None
    key = (kernel, torch.device(device))
    buf = _SECTION_BUFFERS.get(key)
    if buf is None:
        buf = _SECTION_BUFFERS[key] = torch.zeros(len(section_names(kernel)), dtype=torch.int64,
                                                  device=device)
    return buf


def sections(kernel: str) -> Dict[str, int]:
    """{name: total} of the counters of ``kernel`` (:func:`section_names`)
    over every traced launch since the last :func:`reset_sections`, summed
    over devices (one device-to-host read each); empty where no traced
    launch ran (a CPU run: the plain versions count nothing)."""
    bufs = [b for (k, _), b in _SECTION_BUFFERS.items() if k == kernel]
    if not bufs:
        return {}
    tot = sum(b.cpu() for b in bufs)
    return dict(zip(section_names(kernel), (int(v) for v in tot)))


def reset_sections() -> None:
    """Zero every kernel's section counters."""
    for b in _SECTION_BUFFERS.values():
        b.zero_()


def group_fits(kernel: str) -> Dict[Tuple[int, int, bool], int]:
    """{(device index, dynamic shared-memory bytes per block, co-resident):
    groups} of the group kernel ``kernel`` ("megastep_kernel",
    "fused_kernel", "racestep_kernel"): how many of its 128-lane groups the
    card holds at once at that launch shape, on the launch's path. A
    clustered launch (co-resident False) holds the clusters
    ``cudaOccupancyMaxActiveClusters`` gives and runs B lanes in
    ceil(B / 128 / groups) waves; a co-resident one (``ops/csrc/arl_sync.cuh``,
    ``launch_group``: early exit, more groups than the clusters, the whole
    grid on the card at once) holds the card's block places over 8 and runs
    in one wave. Each shape and path is asked once, at its first launch;
    where two instantiations of the kernel (traced and untraced) share one,
    the fewer. Empty where the kernel library is not loaded (a CPU run) or
    the kernel has not run."""
    from ..ops import _cuda

    if not _cuda.library.cache_info().currsize:
        return {}
    cap = 64
    out = (ctypes.c_int * (4 * cap))()
    n = min(_cuda.library().arl_cluster_fits(kernel.encode(), out, cap), cap)
    fits: Dict[Tuple[int, int, bool], int] = {}
    for i in range(n):
        key, groups = (out[4 * i], out[4 * i + 1], bool(out[4 * i + 3])), out[4 * i + 2]
        fits[key] = min(fits.get(key, groups), groups)
    return fits


def clusters_per_wave(kernel: str) -> Dict[Tuple[int, int], int]:
    """{(device index, dynamic shared-memory bytes per block): groups} of
    the group kernel ``kernel``: :func:`group_fits` over both launch paths,
    the fewer where both ran at a shape (a clustered launch's clusters, a
    co-resident launch's groups held at once)."""
    fits: Dict[Tuple[int, int], int] = {}
    for (dev, smem, _), groups in group_fits(kernel).items():
        fits[(dev, smem)] = min(fits.get((dev, smem), groups), groups)
    return fits


def _cuda_devices(*trees):
    """The CUDA devices of the tensors in ``trees``."""
    return {t.device for t in tree_flatten(trees)[0] if isinstance(t, torch.Tensor) and t.is_cuda}


def _sync(devices) -> None:
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> Tuple[float, Any]:
    """(best seconds, last result) of ``fn(*args)``. Where the arguments or
    the result are CUDA tensors, each call is timed between two
    ``torch.cuda.synchronize()`` of their devices."""
    devs = _cuda_devices(args)
    out = None
    for _ in range(max(0, warmup)):
        out = fn(*args)
        devs |= _cuda_devices(out)
        _sync(devs)
    best = float("inf")
    for _ in range(iters):
        _sync(devs)
        t0 = time.perf_counter()
        out = fn(*args)
        devs |= _cuda_devices(out)
        _sync(devs)
        best = min(best, time.perf_counter() - t0)
    return best, out


class Trace:
    """What :func:`trace_to` yields: the ``torch.profiler.profile`` session
    (``prof``) and, once the region has ended, the trace file (``path``)."""

    def __init__(self, prof):
        self.prof = prof
        self.path = None


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the region into ``logdir``: CPU activity of every thread, and
    CUDA activity (every kernel, the hand-written ones included, with its
    stream) where a card is present. Yields a :class:`Trace`; on exit the card is
    synchronised and the trace is written as
    ``<logdir>/trace.<pid>.<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``). Raises ``RuntimeError`` after writing it when the
    host launched kernels in the region but the profiler returned no
    record of any of them: an empty device trace is never handed back as
    a measurement (in a long-lived process the profiler has been seen to
    lose the first kernel records of a session)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # every thread's ops (a planner thread's too), not only this one's
    with profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        trace = Trace(prof)
        yield trace
        if cuda:
            torch.cuda.synchronize()
    trace.path = os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(trace.path)
    if cuda:
        # the profiler's raw records (prof.events() would rebuild every
        # event in Python first)
        events = prof.profiler.kineto_results.events()
        launched = sum(1 for e in events if e.device_type() == DeviceType.CPU and "Launch" in e.name())
        recorded = sum(1 for e in events if e.device_type() == DeviceType.CUDA)
        if launched and not recorded:
            raise RuntimeError(f"trace_to: the host launched {launched} kernel(s) or graph(s) but the profiler "
                               f"recorded none on the device ({trace.path}); trace a longer region, or trace "
                               f"from a fresh process")

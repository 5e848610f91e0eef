"""Profiling and timing tools (the JAX package's ``utils/profiling.py``;
SURVEY.md §5 "Tracing / profiling").

- :func:`timed`: best wall time over a few calls, the card synchronised
  around each call (PyTorch returns before the device finishes).
- :func:`trace_to`: a ``torch.profiler`` session over a region, written as a
  Chrome / Perfetto JSON trace into a directory.
- :func:`cost_analysis`: the FLOPs of the PyTorch ops a call runs, from
  ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_flatten


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


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": ...}`` of ``fn(*args)``: the FLOPs that
    ``FlopCounterMode`` counts for the PyTorch ops the call runs (matmuls,
    convolutions, attention). The hand-written CUDA kernels are opaque to
    it, as Pallas calls are to XLA's cost analysis: a call that spends its
    work in them counts none of it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}

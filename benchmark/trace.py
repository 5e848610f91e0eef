"""Reduce a torch.profiler trace of the measured window to what the
per-layer metrics read: the program's device operations in the window
(kernels, copies, sets), the union of their intervals, and the idle gaps
labelled by what the host was doing.

The window is the host span ``WINDOW_SPAN`` that the harness opens around
the measured loop; the route files open one span per call into the program
(``<route>.<entry>``, through ``span``). The harness's own device work in
the window (the done-at sums, the count of non-finite lanes) runs inside
``OWN_SPAN`` and is left out: the device operations that an operation
inside that span launched (the profiler's correlation ids) count neither as
operations nor as busy time."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import NamedTuple

import numpy as np
from torch.profiler import record_function

WINDOW_SPAN = "bench.window"
OWN_SPAN = "bench.own"
GAPS_LABELLED = 400      # the longest gaps that are labelled by the host's work


def span(ctx, name: str):
    """A host span named ``name`` while ``ctx.trace`` is on (the traced
    window), nothing otherwise."""
    return record_function(name) if ctx.trace else contextlib.nullcontext()


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: list                 # (name, start_s, duration_s) of each device operation in the window
    idle_by_host: list        # [(label, seconds)], largest first, of the GAPS_LABELLED longest gaps
    own_ops: int              # the harness's own device operations in the window, left out

    def durations(self, kernel: str) -> list:
        """Device seconds of each operation whose name holds ``kernel``."""
        return [d for n, _, d in self.ops if kernel in n]

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for name, _, d in self.ops:
            tot[name] += d
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def _device_type_name(e) -> str:
    return str(e.device_type()).split(".")[-1].upper()


def union(intervals: np.ndarray) -> np.ndarray:
    """Merged (k, 2) start/end intervals of (n, 2) ones."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(events) -> Trace:
    """``events``: the profiler's kineto events (``prof.profiler.
    kineto_results.events()``), or objects with the same accessors."""
    host, dev, window, own = [], [], None, []
    for e in events:
        kind = _device_type_name(e)
        start, dur = e.start_ns(), e.duration_ns()
        if kind == "CPU":
            if e.name() == WINDOW_SPAN:
                window = (start, start + dur)
            else:
                host.append((start, start + dur, e.name(), e.correlation_id()))
                if e.name() == OWN_SPAN:
                    own.append((start, start + dur))
        elif kind == "CUDA":
            dev.append((start, start + dur, e.name(), e.linked_correlation_id()))
    # a host span (record_function) is also drawn on the device's timeline
    # under its own name; no kernel, copy or set is named like a host event
    host_names = {h[2] for h in host} | {WINDOW_SPAN}
    dev = [d for d in dev if d[2] not in host_names]
    # what an operation inside the harness's own spans launched
    own_ids = set()
    if own:
        own = np.asarray(sorted(own), dtype=np.float64)
        hs = np.asarray([h[0] for h in host], dtype=np.float64)
        he = np.asarray([h[1] for h in host], dtype=np.float64)
        i = np.searchsorted(own[:, 0], hs, side="right") - 1
        inside = (i >= 0) & (he <= own[np.maximum(i, 0), 1])
        own_ids = {host[j][3] for j in np.nonzero(inside)[0]} - {0}
    n_dev = len(dev)
    dev = [d for d in dev if d[3] not in own_ids]
    n_own = n_dev - len(dev)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n, _ in dev if e > w0 and s < w1]
    iv = np.asarray([(s, e) for s, e, _ in dev], dtype=np.float64).reshape(-1, 2)
    busy = union(iv)
    busy_ns = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)   # idle (start, end) pairs
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAPS_LABELLED]
    idle = defaultdict(float)
    if len(longest):
        hs = np.asarray([h[0] for h in host], dtype=np.float64)
        he = np.asarray([h[1] for h in host], dtype=np.float64)
        for g0, g1 in longest:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside) == 0:
                label = "host idle (no span)"
            else:
                spans = sorted(inside, key=lambda i: he[i] - hs[i], reverse=True)
                # the outermost span (a route's layer) and the innermost op
                outer, inner = host[spans[0]][2], host[spans[-1]][2]
                label = outer if outer == inner else f"{outer} > {inner}"
            idle[label] += (g1 - g0) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 ops=[(n, s * 1e-9, (e - s) * 1e-9) for s, e, n in dev],
                 idle_by_host=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1]), own_ops=n_own)

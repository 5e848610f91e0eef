"""Online receding-horizon replanning: planner and tracker at two rates (the
JAX package's ``planner/online.py``).

The obstacle-aware planner re-plans a receding horizon from the car's
current state every ``replan_every`` tracker steps, so obstacles that
appear mid-lap are avoided; the tracker follows the latest table. The host
drives the outer loop; each tracking segment is ``replan_every`` steps of
``mpc_step`` + ``plant_step`` on one car.

:func:`replanning_loop` plans and tracks in turn.
:func:`pipelined_replanning_loop` plans segment k+1 while segment k is
tracked: on a second card where there is one, otherwise on a second CUDA
stream of the tracker's card, issued from a second host thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, MPPConfig, SolverConfig, VehicleParams
from ..models import model_nx
from ..track.track import Track
from .mpp import plan_mpp
from .opponents import pad_blocks
from .reftable import RefTable


class ReplanLog(NamedTuple):
    log: NamedTuple               # ClosedLoopLog over the T steps, (T, ...)
    replan_steps: np.ndarray      # step indices where replanning happened
    plan_progress: np.ndarray     # planned span per replan [m]


def _track_segment(p, cfg: MPCConfig, scfg: SolverConfig, track: Track, T_seg: int, sim_tire):
    """``run(x0, carry, table, obstacles=None)``: T_seg closed-loop steps of
    one car, returning the final state and carry and the segment's log."""
    # (imported here: loop.mpc imports planner.reftable, so a module-level
    # import would make the planner package circular)
    from ..loop.closed_loop import ClosedLoopLog, plant_step
    from ..loop.mpc import mpc_step

    def run(x0, carry, table: RefTable, obstacles=None):
        x, outs = x0, []
        for _ in range(T_seg):
            u, carry, diag = mpc_step(p, cfg, scfg, track, x, table, carry, obstacles=obstacles)
            x = plant_step(p, cfg, track, x, u, n_sub=10, sim_tire=sim_tire)
            outs.append((x, u, diag.converged, diag.iters, diag.r_prim, diag.r_dual,
                         diag.certified_infeasible))
        return x, carry, ClosedLoopLog(*(torch.stack(col) for col in zip(*outs)))

    return run


def replanning_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    pcfg: MPPConfig,
    track: Track,
    x0: torch.Tensor,
    T: int,
    replan_every: int = 60,
    obstacles_fn: Optional[Callable[[int], Optional[np.ndarray]]] = None,
    sim_tire: Optional[str] = None,
    plan_scfg: Optional[SolverConfig] = None,
    max_obstacle_rows: int = 8,
) -> ReplanLog:
    """Run T tracker steps from x0 (nx,), re-planning every ``replan_every``
    steps.

    ``obstacles_fn(step)`` returns the (n_obs, 4) blocks visible at that
    step (or None); they may appear and move between replans. The blocks
    reach both the planner (corridor-shifted reference) and the tracker QP
    (per-stage e_y corridor), padded to ``max_obstacle_rows``, so avoidance
    holds even when the tracker lags the planned line.
    """
    from ..loop.mpc import mpc_init

    if cfg.model != pcfg.model:
        raise ValueError(f"tracker model {cfg.model!r} and planner model {pcfg.model!r} differ")
    segment = _track_segment(p, cfg, scfg, track, replan_every, sim_tire)
    carry = mpc_init(p, cfg, track, x0)
    x = x0
    logs: List = []
    replan_steps, spans = [], []
    t = 0
    while t < T:
        obs = obstacles_fn(t) if obstacles_fn is not None else None
        if obs is not None:
            obs = torch.as_tensor(pad_blocks(obs, max_obstacle_rows), device=x.device)
        table, diag = plan_mpp(p, pcfg, track, scfg=plan_scfg, obstacles=obs, x0_state=x)
        replan_steps.append(t)
        spans.append(float(diag.progress))
        x, carry, log = segment(x, carry, table, obs)
        logs.append(log)
        t += replan_every
    cat = type(logs[0])(*(torch.cat(cols, dim=0) for cols in zip(*logs)))
    return ReplanLog(log=cat, replan_steps=np.asarray(replan_steps), plan_progress=np.asarray(spans))


def _boundary_predictor(cfg: MPCConfig, steps: int):
    """``predict(table, x)``: the tracker state at the next segment boundary,
    ``steps`` control periods on from x (nx,). Arc length is integrated
    along the table's velocity profile (s += v(s) dt, one step at a time)
    and the racing line is read there; the other states are 0. Crude on
    purpose: it only seeds the pipelined planner (latency compensation),
    and the tracker absorbs the residual like any reference deviation. Both
    models: (vx, s, e_y) at the model's indices."""
    from ..engine.assembly import _s_index, state_indices

    nx = model_nx(cfg.model)
    s_i = _s_index(cfg.model)
    vx_i, ey_i = state_indices(cfg.model)

    def predict(table: RefTable, x: torch.Tensor) -> torch.Tensor:
        s = x[s_i]
        for _ in range(steps):
            v, _ey, _dl = table.lookup(s)
            s = s + v * cfg.dt
        v, ey, _dl = table.lookup(s)
        out = torch.zeros((nx,), dtype=torch.float32, device=x.device)
        out[vx_i], out[s_i], out[ey_i] = v, s, ey
        return out

    return predict


def _on_device(obj, device):
    """A copy of the dataclass ``obj`` (a Track, a RefTable, VehicleParams)
    with its tensor fields on ``device``; ``obj`` itself when they are
    there already."""
    moved = {f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor) and getattr(obj, f.name).device != device}
    return dataclasses.replace(obj, **moved) if moved else obj


def _table_tensors(table: RefTable):
    return [getattr(table, f.name) for f in dataclasses.fields(table)]


class _PlanJob:
    """``fn(*args)`` on a thread of its own, started at once; ``result()``
    joins it and returns its value or re-raises its exception in the
    caller."""

    def __init__(self, fn, *args):
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(fn, args), name="planner", daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out = fn(*args)
        except Exception as e:       # handed to the caller by result()
            self._err = e

    def join(self):
        self._thread.join()

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


def pipelined_replanning_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    pcfg: MPPConfig,
    track: Track,
    x0: torch.Tensor,
    T: int,
    replan_every: int = 60,
    obstacles_fn: Optional[Callable[[int], Optional[np.ndarray]]] = None,
    sim_tire: Optional[str] = None,
    plan_scfg: Optional[SolverConfig] = None,
    max_obstacle_rows: int = 8,
    planner_device=None,
) -> ReplanLog:
    """Pipelined replanning (SURVEY.md §2.2 "planner->tracker pipelining"):
    the plan for segment k+1 is made while segment k is tracked.

    The first plan is made from x0 before the loop. Each later plan starts
    from the state predicted ``replan_every`` steps along the current table
    from the state at the start of the segment being tracked (not from its
    end, which does not exist yet), with ``obstacles_fn(t_next)``; no plan
    is made after the last segment. Same API and obstacle semantics as
    :func:`replanning_loop`; the tracker runs on the track's device.

    Where it runs. ``planner_device`` (default: the next card where
    ``torch.cuda.device_count() > 1``, otherwise the tracker's card) holds
    the planner. On the card each plan is issued from a host thread of its
    own (PyTorch's current stream is per thread) onto a stream of its own,
    so its kernels and CUDA-graph replays overlap the tracker's on the
    caller's current stream:

    - the planner's stream waits on an event recorded on the tracker's
      stream once the segment's start state exists, and the tracker's
      stream waits on an event recorded after the plan before it uses the
      new table;
    - tensors that one stream made and the other reads are marked with
      ``record_stream``, so the allocator does not hand out their memory
      while the other stream may still read it;
    - neither thread synchronises the device inside the loop; the plan's
      own host reads (the velocity profile, the track's scalars) wait on
      the planner's stream only;
    - the first plan runs on the caller's thread before any concurrency,
      so it captures the planner's CUDA graphs (one per QP shape; blocks
      change no shape, so a block appearing mid-run replays the same
      graphs), and later plans only replay them.

    Where the planner has a card of its own, the caller's thread copies
    each new table to the tracker's card after that card's current stream
    (on which the copy runs) has waited on the plan's event.

    On CPU tensors each plan is made on the caller's thread before the
    segment it follows: the same results, computed one after the other. An
    exception raised while planning re-raises from this call. Planned spans
    stay device scalars until the loop ends.
    """
    from ..loop.mpc import mpc_init

    if cfg.model != pcfg.model:
        raise ValueError(f"tracker model {cfg.model!r} and planner model {pcfg.model!r} differ")
    dev = track.kappa.device
    concurrent = dev.type == "cuda"
    if planner_device is not None:
        pdev = torch.device(planner_device)
        if pdev.type == "cuda" and pdev.index is None:
            pdev = torch.device("cuda", torch.cuda.current_device())
    elif concurrent and torch.cuda.device_count() > 1:
        pdev = torch.device("cuda", (dev.index + 1) % torch.cuda.device_count())
    else:
        pdev = dev
    concurrent = concurrent and pdev.type == "cuda"
    p_p, track_p = _on_device(p, pdev), _on_device(track, pdev)
    segment = _track_segment(p, cfg, scfg, track, replan_every, sim_tire)
    predict = _boundary_predictor(cfg, replan_every)
    ts = torch.cuda.current_stream(dev) if concurrent else None
    ps = torch.cuda.Stream(device=pdev) if concurrent else None

    def plan(x_state, obs_raw):
        obs = (torch.as_tensor(pad_blocks(obs_raw, max_obstacle_rows), device=pdev)
               if obs_raw is not None else None)
        return plan_mpp(p_p, pcfg, track_p, scfg=plan_scfg, obstacles=obs, x0_state=x_state)

    def plan_next(x_p, table_p, obs_raw, ready):
        """The worker thread's job: predict and plan on the planner's
        stream once the tracker's ``ready`` event has passed."""
        with torch.cuda.device(pdev), torch.cuda.stream(ps):
            ps.wait_event(ready)
            table_n, diag = plan(predict(table_p, x_p), obs_raw)
            return table_n, diag, ps.record_event()

    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    carry = mpc_init(p, cfg, track, x)
    with torch.cuda.device(pdev) if pdev.type == "cuda" else contextlib.nullcontext():
        table, diag = plan(x.to(pdev), obstacles_fn(0) if obstacles_fn else None)
    table = _on_device(table, dev)
    logs: List = []
    # device scalars until the loop ends: a float() here would wait for the
    # planner's stream and serialize the pipeline
    replan_steps, spans = [0], [diag.progress]

    t, job = 0, None
    try:
        while t < T:
            t_next = t + replan_every
            if t_next < T:
                # 1. the next plan, from x and the current table
                x_p, table_p = x.to(pdev), _on_device(table, pdev)
                obs_next = obstacles_fn(t_next) if obstacles_fn else None
                if concurrent:
                    ready = ts.record_event()
                    for tt in [x_p] + _table_tensors(table_p):
                        tt.record_stream(ps)
                    job = _PlanJob(plan_next, x_p, table_p, obs_next, ready)
                else:
                    planned = plan(predict(table_p, x_p), obs_next)
            # 2. segment k on the tracker's stream, meanwhile
            obs_now = obstacles_fn(t) if obstacles_fn is not None else None
            obs_t = (torch.as_tensor(pad_blocks(obs_now, max_obstacle_rows), device=dev)
                     if obs_now is not None else None)
            x, carry, log = segment(x, carry, table, obs_t)
            logs.append(log)
            # 3. join: the tracker's stream waits for the plan
            if t_next < T:
                if concurrent:
                    table_n, diag, done = job.result()
                    job = None
                    # the stream that reads the table next waits for the
                    # plan: the tracker's, or on a second card that card's
                    # current stream of this thread, on which the copy to
                    # the tracker's card runs (and the tracker's stream
                    # waits for the copy)
                    rs = ts if pdev == dev else torch.cuda.current_stream(pdev)
                    rs.wait_event(done)
                    for tt in _table_tensors(table_n) + [diag.progress]:
                        tt.record_stream(rs)
                else:
                    table_n, diag = planned
                table = _on_device(table_n, dev)
                replan_steps.append(t_next)
                spans.append(diag.progress)
            t = t_next
    finally:
        if job is not None:     # the caller failed: no plan outlives the call
            job.join()

    if concurrent:
        ps.synchronize()
    cat = type(logs[0])(*(torch.cat(cols, dim=0) for cols in zip(*logs)))
    return ReplanLog(log=cat, replan_steps=np.asarray(replan_steps),
                     plan_progress=np.asarray([float(s) for s in spans]))

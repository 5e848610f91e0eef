"""The five BASELINE configurations and the flagship programs as runnable
presets (the JAX package's ``bench/presets.py``, same names, knobs and
result keys).

Each preset returns a JSON-serializable dict; the CLI (``cli.py``) drives
them by name. Every preset takes ``device``: ``None`` (the default) runs on
the CUDA card and raises where there is none, ``device="cpu"`` runs the
plain versions on the CPU. What runs on the card depends on the route:

- ``SolverConfig.backend="fused"``: the tracker's step is one fused-kernel
  launch (``ops.fused_kernel``);
- ``backend="admm"`` (the JAX "pallas"): the solver-only kernel
  (``ops.admm_kernel``);
- ``race_sweep``, ``race_learn`` and ``race`` with its own
  ``backend="mega"``: the racestep kernel (``ops.racestep_kernel``);
- ``backend="plain"`` (the JAX "xla", the default): no kernel, the plain
  PyTorch composition launched eagerly on the card, some 0.3 s a step for
  one car.

``config5`` runs ``parallel.sharded_closed_loop`` on every rank of the
process group: one process alone, or each rank of a ``torchrun`` launch.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, MPCWeights, MPPConfig, SolverConfig, VehicleParams
from ..core.device import resolve_device
from ..loop import closed_loop, constant_refs, mpc_init, mpc_step_batched, plant_step
from ..parallel import make_scenario_grid
from ..planner import plan_mpp
from ..track import oval_track, racetrack
from ..utils.metrics import as_numpy as _np
from ..utils.metrics import lap_stats
from ..utils.tree import tree_map

# the race presets' own ``backend`` names, the JAX package's included
_RACE_BACKENDS = {"xla": "plain", "plain": "plain", "mega": "mega"}


def _warn_unused(preset: str, kw: Dict) -> None:
    """A mistyped knob (mutrue= for mu_true=) must not be dropped silently:
    the run would report plausible numbers for the wrong configuration."""
    if kw:
        warnings.warn(f"{preset} preset ignoring unknown knobs: {sorted(kw)}", stacklevel=3)


def _race_backend(backend: str) -> str:
    if backend not in _RACE_BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {sorted(_RACE_BACKENDS)}")
    return _RACE_BACKENDS[backend]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _state(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=dev)


def _maybe_plot(cfg, track, log, plot):
    if plot:
        from ..utils.plotting import plot_run

        plot_run(cfg, track, log, path=plot)


def _lap_result(cfg, track, log, vx_ref=None, extra=None):
    st = lap_stats(cfg, log, float(track.length), vx_ref=vx_ref)
    out = {
        "laps": st.n_laps,
        "lap_times_s": st.lap_times,
        "ey_rms_m": round(st.ey_rms, 4),
        "ey_max_m": round(st.ey_max, 4),
        "vx_mean": round(st.vx_mean, 3),
        "converged_frac": round(st.converged_frac, 3),
        "mean_iters": round(st.mean_iters, 1),
    }
    if extra:
        out.update(extra)
    return out


def _planner_extra(diag) -> Dict:
    return {"planner_lap_time_s": round(float(diag.lap_time), 3),
            "planner_sqp_converged": bool(_np(diag.converged).all())}


def config1(p: VehicleParams, scfg: SolverConfig, T: int = 400, plot: str = "", device=None,
            **kw) -> Dict:
    """Kinematic bicycle LPV-MPC, N=10, single lap on the reference oval."""
    _warn_unused("config1", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=10, model="kinematic", weights=MPCWeights.for_model("kinematic"))
    track = oval_track(device=dev)
    log = closed_loop(p, cfg, scfg, track, _state([0.5, 0.0, 0.0, 0.0], dev),
                      constant_refs(cfg, 1.5, device=dev), T=T)
    _maybe_plot(cfg, track, log, plot)
    return _lap_result(cfg, track, log, vx_ref=1.5)


def config1_planner(p: VehicleParams, scfg: SolverConfig, T: int = 500, plot: str = "",
                    device=None, **kw) -> Dict:
    """Kinematic planner -> tracker pipeline: BASELINE config 1's model
    driven by the full config3-style MPP racing line."""
    _warn_unused("config1_planner", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=10, model="kinematic", weights=MPCWeights.for_model("kinematic"))
    track = oval_track(device=dev)
    table, diag = plan_mpp(p, MPPConfig.for_model("kinematic", H=256, n_sqp=3), track)
    scfg_t = scfg.replace(max_iter=max(scfg.max_iter, 100))
    log = closed_loop(p, cfg, scfg_t, track, _state([0.5, 0.0, 0.0, 0.0], dev), table, T=T)
    _maybe_plot(cfg, track, log, plot)
    return _lap_result(cfg, track, log, extra=_planner_extra(diag))


def config2(p: VehicleParams, scfg: SolverConfig, T: int = 700, plot: str = "", device=None,
            **kw) -> Dict:
    """Dynamic bicycle (Pacejka plant), N=20, full racetrack lap."""
    _warn_unused("config2", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=20, model="dynamic")
    track = racetrack(device=dev)
    log = closed_loop(p, cfg, scfg, track, _state([0.7, 0.0, 0.0, 0.0, 0.0, 0.0], dev),
                      constant_refs(cfg, 1.8, device=dev), T=T, sim_tire="pacejka")
    _maybe_plot(cfg, track, log, plot)
    return _lap_result(cfg, track, log, vx_ref=1.8)


def config3(p: VehicleParams, scfg: SolverConfig, T: int = 800, plot: str = "", device=None,
            **kw) -> Dict:
    """MPP planner -> tracking MPC pipeline on the racetrack."""
    _warn_unused("config3", kw)
    dev = resolve_device(device)
    track = racetrack(device=dev)
    table, diag = plan_mpp(p, MPPConfig(), track)
    cfg = MPCConfig(N=20, model="dynamic")
    scfg_t = scfg.replace(max_iter=max(scfg.max_iter, 100))
    log = closed_loop(p, cfg, scfg_t, track, _state([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], dev), table,
                      T=T, sim_tire="pacejka")
    _maybe_plot(cfg, track, log, plot)
    return _lap_result(cfg, track, log, extra=_planner_extra(diag))


def config4(p: VehicleParams, scfg: SolverConfig, batch: int = 4096, steps: int = 10,
            device=None, **kw) -> Dict:
    """Batched scenario sweep on one chip: solves/s + convergence."""
    _warn_unused("config4", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=20, model="dynamic")
    track = racetrack(device=dev)
    x_ref = constant_refs(cfg, 1.8, device=dev)
    scen = make_scenario_grid(p, cfg, n_ey=min(64, batch), n_mu=max(1, batch // 64), vx0=1.5,
                              device=dev)

    def k_steps(xs, carries):
        convs = []
        for _ in range(steps):
            u, carries, d = mpc_step_batched(scen.params, cfg, scfg, track, xs, x_ref, carries)
            xs = plant_step(scen.params, cfg, track, xs, u, n_sub=4)
            convs.append(d.converged.to(torch.float32).mean())
        return xs, carries, torch.stack(convs)

    state = (scen.x0, mpc_init(scen.params, cfg, track, scen.x0))
    state = k_steps(*state)[:2]                                  # warm
    _sync(dev)
    t0 = time.perf_counter()
    xs, carries, convs = k_steps(*state)
    _sync(dev)
    dt_wall = time.perf_counter() - t0
    return {
        "batch": scen.batch,
        "solves_per_s": round(scen.batch * steps / dt_wall, 1),
        "batched_step_ms": round(dt_wall / steps * 1e3, 2),
        "converged_frac": round(float(convs.mean()), 3),
    }


def config5(p: VehicleParams, scfg: SolverConfig, per_device: int = 128, T: int = 30,
            trials: int = 1, device=None, **kw) -> Dict:
    """Mesh-wide sweep with collective metric reduction (all ranks).

    ``per_device`` scenarios per rank (one rank per card) on the racetrack,
    ``MPCConfig(N=14)``, a Pacejka plant, through
    ``parallel.sharded_closed_loop`` on ``scfg.backend``: one process at
    world size 1, or every rank of a ``torchrun`` launch. Each rank builds
    the same global grid and runs its contiguous slice.

    On more than one rank the weak-scaling efficiency is reported too: each
    rank also times its own slice with no cross-rank collective, on a mesh
    of itself alone, concurrently with the other ranks (so that contention
    is matched); efficiency = max over ranks of t_local / max of t_global.
    With ``trials > 1`` the local and global legs interleave and each leg's
    minimum is taken (contention only adds time)."""
    from ..parallel import make_mesh

    _warn_unused("config5", kw)
    dev = resolve_device(device)
    own_group = not torch.distributed.is_initialized()
    mesh = make_mesh(device=dev)
    try:
        return _config5_run(p, scfg, mesh, dev, per_device, T, trials)
    finally:
        if own_group:       # the group this call started ends with it
            torch.distributed.destroy_process_group()


def _config5_run(p, scfg, mesh, dev, per_device, T, trials) -> Dict:
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel import scenario_sharding, sharded_closed_loop
    from ..parallel.collectives import barrier, pmax_scalar

    n_dev = mesh.size()
    cfg = MPCConfig(N=14, model="dynamic")
    track = racetrack(device=dev)
    B = per_device * n_dev
    scen = make_scenario_grid(p, cfg, n_ey=min(64, B), n_mu=max(1, B // 64), vx0=1.5, device=dev)
    Bm = (scen.batch // n_dev) * n_dev      # a multiple of the mesh
    scen = tree_map(lambda a: a[:Bm], scen)
    local = scenario_sharding(mesh, scen)
    x_ref = constant_refs(cfg, 1.8, device=dev)

    def timed_run(mesh_):
        sharded_closed_loop(mesh_, local, cfg, scfg, track, x_ref, T=T, sim_tire="pacejka")   # warm
        _sync(dev)
        barrier()                                            # lockstep start
        t0 = time.perf_counter()
        _log, m = sharded_closed_loop(mesh_, local, cfg, scfg, track, x_ref, T=T, sim_tire="pacejka")
        _sync(dev)
        return m, time.perf_counter() - t0

    # every rank's wall: the slowest rank's is the figure
    wall_max = lambda t: float(pmax_scalar(torch.tensor(t, dtype=torch.float64, device=dev)))
    metrics, dt_wall = timed_run(mesh)
    out = {
        "devices": n_dev,
        "processes": n_dev,
        "batch": Bm,
        "total_solves": Bm * T,
        "solves_per_s": round(Bm * T / dt_wall, 1),
        "ey_rms_m": round(float(metrics.ey_rms), 4),
        "converged_frac": round(float(metrics.converged_frac), 3),
        "mean_progress_m": round(float(metrics.mean_progress), 2),
    }
    if n_dev > 1:
        # one single-rank group per rank, made by every rank in the same order
        solo = [torch.distributed.new_group([r]) for r in range(n_dev)]
        mesh_loc = DeviceMesh.from_group(solo[mesh.get_rank()], dev.type, mesh_dim_names=("scenarios",))
        loc_walls, glb_walls = [wall_max(timed_run(mesh_loc)[1])], [wall_max(dt_wall)]
        for _ in range(trials - 1):
            glb_walls.append(wall_max(timed_run(mesh)[1]))
            loc_walls.append(wall_max(timed_run(mesh_loc)[1]))
        dt_loc, dt_glb = min(loc_walls), min(glb_walls)
        out["solves_per_s"] = round(Bm * T / dt_glb, 1)
        out["solves_per_s_local"] = round(local.batch * T / dt_loc, 1)
        out["local_wall_s_max"] = round(dt_loc, 4)
        out["trials"] = trials
        out["scaling_efficiency"] = round(dt_loc / dt_glb, 3)
    return out


def latency(p: VehicleParams, scfg: SolverConfig, batch: int = 128, reps: int = 20,
            device=None, **kw) -> Dict:
    """Per-step solve latency (p50/p99) — the second headline metric.

    One batched receding-horizon step per call, synchronized (batch = one
    128-lane vote group by default); ``on_device_step_ms`` is the wall time
    of K=50 steps enqueued back to back, over K."""
    _warn_unused("latency", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=20, model="dynamic")
    track = racetrack(device=dev)
    x_ref = constant_refs(cfg, 1.8, device=dev)
    scen = make_scenario_grid(p, cfg, n_ey=min(64, batch), n_mu=max(1, batch // 64), vx0=1.5,
                              device=dev)
    carries = mpc_init(scen.params, cfg, track, scen.x0)
    step = lambda cs: mpc_step_batched(scen.params, cfg, scfg, track, scen.x0, x_ref, cs)
    u, carries, d = step(carries)                                # warm
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        u, carries, d = step(carries)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    times = np.sort(np.asarray(times))

    K = 50
    cs = carries
    t0 = time.perf_counter()
    for _ in range(K):
        _, cs, _ = step(cs)
    _sync(dev)
    on_dev_ms = (time.perf_counter() - t0) / K * 1e3
    return {
        "batch": scen.batch,
        "p50_ms": round(float(np.percentile(times, 50)), 3),
        "p99_ms": round(float(np.percentile(times, 99)), 3),
        "on_device_step_ms": round(on_dev_ms, 3),
        "budget_ms": round(1000.0 * cfg.dt, 1),
        "converged_frac": round(float(d.converged.to(torch.float32).mean()), 3),
    }


def adaptive(p: VehicleParams, scfg: SolverConfig, T: int = 400, mu_true: float = 0.5,
             mu0: float = 1.0, plot: str = "", device=None, **kw) -> Dict:
    """Online friction adaptation under model mismatch (loop/friction.py):
    plant at ``mu_true``, controller starting at ``mu0`` and re-scheduling
    on the RLS mu-hat each step. Reports the estimate trace endpoints and
    the tracking improvement vs the frozen-mu ablation."""
    from ..loop.friction import adaptive_closed_loop

    _warn_unused("adaptive", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=12, model="dynamic", tire="pacejka")
    scfg_a = scfg.replace(max_iter=max(scfg.max_iter, 40))
    track = racetrack(device=dev)
    x0 = _state([1.2, 0.0, 0.0, 0.0, 0.0, 0.0], dev)
    x_ref = constant_refs(cfg, 2.6, device=dev)
    log = adaptive_closed_loop(p, cfg, scfg_a, track, x0, x_ref, T=T, mu_true=mu_true, mu0=mu0)
    log0 = adaptive_closed_loop(p, cfg, scfg_a, track, x0, x_ref, T=T, mu_true=mu_true, mu0=mu0,
                                adapt=False)
    ey_rms = lambda L: float(torch.sqrt(torch.mean(L.X[:, 5] ** 2)))
    ey_max = lambda L: float(torch.max(torch.abs(L.X[:, 5])))
    if plot:
        from ..utils.plotting import plot_run

        plot_run(cfg, track, log, path=plot)
    return {
        "preset": "adaptive",
        "mu_true": mu_true,
        "mu0": mu0,
        "mu_hat_final": round(float(log.mu_hat[-1]), 4),
        "ey_rms_adapted_m": round(ey_rms(log), 4),
        "ey_rms_frozen_m": round(ey_rms(log0), 4),
        "ey_max_adapted_m": round(ey_max(log), 4),
        "ey_max_frozen_m": round(ey_max(log0), 4),
        "converged_frac": round(float(log.converged.to(torch.float32).mean()), 4),
    }


def learn(p: VehicleParams, scfg: SolverConfig, n_laps: int = 6, T_lap: int = 0, vx0: float = 1.0,
          track_name: str = "oval", plot: str = "", device=None, **kw) -> Dict:
    """Lap-over-lap reference learning (loop/lap_learning.py): start from a
    conservative flat-speed table and let the ILC update race it down to the
    friction limit. Reports the lap-time trajectory and the learned-profile
    spread; ``plot=`` writes lap times + learned vx(s) panels."""
    from ..loop import initial_table, iterative_lap_learning

    if not vx0 > 0.0:
        raise ValueError(f"learn preset needs vx0 > 0 (got {vx0})")
    _warn_unused("learn", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=12, model="dynamic")
    track = oval_track(ds=0.05, device=dev) if track_name == "oval" else racetrack(ds=0.05, device=dev)
    if not T_lap:  # enough steps to finish a lap at the seed speed + margin
        T_lap = int(1.4 * float(track.length) / (vx0 * cfg.dt))
    x0 = _state([vx0, 0.0, 0.0, 0.0, 0.0, 0.0], dev)
    out = iterative_lap_learning(p, cfg, scfg, track, x0, n_laps=n_laps, T_lap=T_lap,
                                 table0=initial_table(track, ds=0.05, vx0=vx0))
    lap_s = _np(out.lap_steps) * cfg.dt
    X = _np(out.last_log.X)
    tables_vx = _np(out.tables_vx)
    if plot:
        from ..utils.plotting import _pyplot

        plt = _pyplot()
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 3.6))
        ax0.plot(np.arange(1, n_laps + 1), lap_s, "o-")
        ax0.set_xlabel("lap")
        ax0.set_ylabel("lap time [s]")
        ax0.set_title("lap-over-lap learning")
        s_grid = np.arange(tables_vx.shape[1]) * float(out.table.ds)
        for i, v in enumerate(tables_vx):
            ax1.plot(s_grid, v, alpha=0.3 + 0.7 * i / n_laps, color="C1", lw=1.0 + 1.5 * (i == n_laps))
        ax1.set_xlabel("s [m]")
        ax1.set_ylabel("vx_ref [m/s]")
        ax1.set_title("learned velocity profile")
        fig.tight_layout()
        fig.savefig(plot, dpi=110)
        plt.close(fig)
    return {
        "preset": "learn",
        "track": track_name,
        "lap_times_s": [round(float(t), 3) for t in lap_s],
        "improvement_pct": round(100.0 * (1.0 - lap_s[-1] / lap_s[0]), 1),
        "ey_max_m": round(float(np.abs(X[:, 5]).max()), 4),
        "converged_frac": round(float(_np(out.last_log.converged).astype(np.float64).mean()), 3),
        "vx_profile_min": round(float(tables_vx[-1].min()), 3),
        "vx_profile_max": round(float(tables_vx[-1].max()), 3),
    }


def race(p: VehicleParams, scfg: SolverConfig, T: int = 720, mu_true: float = 0.6,
         mu0: float = 1.0, replan_every: int = 60, track_name: str = "racetrack",
         mode: str = "replan", backend: str = "xla", plot: str = "", device=None, **kw) -> Dict:
    """FLAGSHIP composition (loop/race.py): noisy measurement -> EKF ->
    friction RLS -> mu-aware MPP replanning (or ILC refinement) -> tracker
    -> world-frame Pacejka plant, the reference's full deployment loop in
    one program. ``mode=learn`` switches the table updates from MPP replans
    to between-window ILC refinement; ``backend=mega`` runs the segments on
    the racestep kernel (``"xla"``/``"plain"``: the module composition)."""
    from ..loop import LapLearnConfig, initial_table, race_loop

    _warn_unused("race", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=12, model="dynamic", tire="pacejka")
    scfg_r = scfg.replace(max_iter=max(scfg.max_iter, 60))
    track = racetrack(device=dev) if track_name == "racetrack" else oval_track(device=dev)
    sigma = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
    pcfg = MPPConfig.for_model("dynamic", H=256, n_sqp=2)
    learn_mode = mode == "learn"
    log = race_loop(
        p, cfg, scfg_r, pcfg, track, _state([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], dev), T=T,
        mu_true=mu_true, mu0=mu0, replan_every=replan_every, noise_sigma=sigma,
        use_ekf=True, adapt_mu=True,
        ilc_every=2 if learn_mode else 0,
        ilc_cfg=LapLearnConfig(gain=0.7, dv_max=0.8) if learn_mode else None,
        table0=initial_table(track, ds=0.05, vx0=1.0) if learn_mode else None,
        backend=_race_backend(backend),
    )
    mu_hat, Xf, Z = _np(log.mu_hat), _np(log.Xf), _np(log.Z)
    if plot:
        from ..utils.plotting import _pyplot

        plt = _pyplot()
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 3.6))
        tt = np.arange(T) * cfg.dt
        ax0.plot(tt, mu_hat, label="mu-hat")
        ax0.axhline(mu_true, color="k", ls="--", label="mu true")
        ax0.set_xlabel("t [s]")
        ax0.set_ylabel("mu")
        ax0.legend()
        ax0.set_title("friction adaptation through the EKF")
        ax1.plot(tt, Z[:, 5], ".", ms=2, alpha=0.3, label="measured e_y")
        ax1.plot(tt, Xf[:, 5], lw=1.2, label="EKF e_y")
        ax1.set_xlabel("t [s]")
        ax1.set_ylabel("e_y [m]")
        ax1.legend()
        ax1.set_title("estimator in the loop")
        fig.tight_layout()
        fig.savefig(plot, dpi=110)
        plt.close(fig)
    lap_steps = _np(log.lap_steps)
    lap_lengths = np.diff(np.concatenate([[0], lap_steps]))
    return {
        "preset": "race",
        "mode": mode,
        "backend": backend,
        "mu_true": mu_true,
        "mu_hat_final": round(float(mu_hat[-1]), 4),
        "laps": int(lap_steps.size),
        "lap_times_s": [round(float(s) * cfg.dt, 3) for s in lap_lengths],
        # replan_steps holds the first plan at step 0 too: the updates are
        # the ones after it
        "table_updates": int(_np(log.replan_steps).size) - 1,
        "ey_rms_m": round(float(np.sqrt(np.mean(Xf[:, 5] ** 2))), 4),
        "ey_max_m": round(float(np.abs(Xf[:, 5]).max()), 4),
        "converged_frac": round(float(_np(log.converged).astype(np.float64).mean()), 3),
        "mean_iters": round(float(_np(log.iters).astype(np.float64).mean()), 1),
    }


def _kernels_loaded() -> bool:
    """Whether the CUDA kernels were built and loaded before this point."""
    from ..ops import _cuda

    return _cuda.library.cache_info().currsize > 0


def race_sweep(p: VehicleParams, scfg: SolverConfig, batch: int = 1024, T: int = 600,
               mu_lo: float = 0.5, mu_hi: float = 1.2, backend: str = "mega", device=None,
               **kw) -> Dict:
    """Deployment-stack Monte-Carlo: ``batch`` independent cars, each with
    its own plant friction (swept mu_lo..mu_hi), sensor noise, EKF,
    friction RLS and tracker, following a worst-surface-planned shared
    table. ``backend="mega"`` (default) runs every composed step as one
    racestep launch; ``backend="xla"``/``"plain"`` the module composition.
    Reports the per-lane adaptation quality and corridor statistics;
    ``wall_includes_compile`` says whether the wall time holds the kernels'
    build at first use."""
    from ..loop import batched_race_sweep, mega_race_sweep

    _warn_unused("race_sweep", kw)
    dev = resolve_device(device)
    route = _race_backend(backend)
    cfg = MPCConfig(N=12, model="dynamic", tire="pacejka")
    scfg_r = scfg.replace(max_iter=max(scfg.max_iter, 40))
    if route == "mega":
        # the kernel path supports (and profits from) early exit
        scfg_r = scfg_r.replace(early_exit=True, check_termination=2)
    track = racetrack(device=dev)
    table, _ = plan_mpp(p.replace(mu=float(np.float32(mu_lo))),
                        MPPConfig.for_model("dynamic", H=256, n_sqp=2), track)
    mu_true_b = torch.linspace(mu_lo, mu_hi, batch, dtype=torch.float32, device=dev)
    x0_b = torch.zeros((batch, 6), dtype=torch.float32, device=dev)
    x0_b[:, 0] = 1.0
    sigma = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
    sweep_fn = mega_race_sweep if route == "mega" else batched_race_sweep
    built = dev.type == "cpu" or _kernels_loaded()
    t0 = time.time()
    log = sweep_fn(p, cfg, scfg_r, track, table, x0_b, T=T, mu_true_b=mu_true_b,
                   mu0=0.5 * (mu_lo + mu_hi), noise_sigma=sigma)
    mu_fin = _np(log.mu_hat[:, -1])
    wall = time.time() - t0
    mu_b = _np(mu_true_b)
    err = np.abs(mu_fin - mu_b)
    ey = np.abs(_np(log.Xf[..., 5]))
    return {
        "preset": "race_sweep",
        "backend": backend,
        "wall_includes_compile": not built,
        "batch": batch,
        "composed_steps": batch * T,
        "wall_s": round(wall, 1),
        "steps_per_s": round(batch * T / wall, 1),
        "mu_err_median": round(float(np.median(err)), 4),
        "mu_err_p90": round(float(np.percentile(err, 90)), 4),
        "mu_corr": round(float(np.corrcoef(mu_fin, mu_b)[0, 1]), 4),
        "ey_p99_m": round(float(np.percentile(ey, 99)), 4),
        "ey_max_m": round(float(ey.max()), 4),
        "converged_frac": round(float(_np(log.converged).astype(np.float64).mean()), 3),
    }


def race_learn(p: VehicleParams, scfg: SolverConfig, batch: int = 256, n_windows: int = 8,
               T_window: int = 300, mu_lo: float = 0.45, mu_hi: float = 1.2, device=None,
               **kw) -> Dict:
    """PER-LANE composed learning at kernel rate (loop/race.py::
    mega_race_learn): every lane races the full noisy-EKF + friction-RLS +
    tracker + plant stack on the racestep kernel following its own table,
    and between windows the batched ILC refines each lane's table at its
    own mu-hat: corner speeds separate by grip from one shared seed."""
    from ..loop import LapLearnConfig, initial_table, mega_race_learn

    _warn_unused("race_learn", kw)
    dev = resolve_device(device)
    cfg = MPCConfig(N=12, model="dynamic", tire="pacejka")
    scfg_r = scfg.replace(max_iter=max(scfg.max_iter, 40), rho_interval=0, early_exit=True,
                          check_termination=2)
    track = racetrack(device=dev)
    mu_true_b = torch.linspace(mu_lo, mu_hi, batch, dtype=torch.float32, device=dev)
    x0_b = torch.zeros((batch, 6), dtype=torch.float32, device=dev)
    x0_b[:, 0] = 1.0
    x0_b[:, 4] = torch.as_tensor(np.linspace(0.0, float(track.length), batch, endpoint=False),
                                 dtype=torch.float32, device=dev)
    sigma = np.array([0.03, 0.01, 0.02, 0.01, 0.02, 0.01], np.float32)
    t0 = time.time()
    log = mega_race_learn(p, cfg, scfg_r, track, x0_b, n_windows=n_windows, T_window=T_window,
                          mu_true_b=mu_true_b, mu0=0.5 * (mu_lo + mu_hi), noise_sigma=sigma,
                          llcfg=LapLearnConfig(gain=0.5, dv_max=0.5),
                          table0=initial_table(track, ds=0.05, vx0=1.2))
    mu_fin = _np(log.mu_hat[-1, :, -1])
    wall = time.time() - t0
    mu_b = _np(mu_true_b)
    corr_mu = float(np.corrcoef(mu_fin, mu_b)[0, 1])
    # corner-speed separation: mean learned vx where |kappa| is large
    kap = np.abs(_np(track.kappa))
    ds_t = float(np.reshape(_np(log.table.ds), (-1,))[0])
    tables_vx = _np(log.tables_vx)
    n = tables_vx.shape[-1]
    node_kap = kap[np.clip(((np.arange(n) * ds_t) / float(track.ds)).astype(int), 0, kap.size - 1)]
    corner = node_kap > 0.5 * kap.max()
    cv = tables_vx[-1][:, corner].mean(axis=1)
    corr_cv = float(np.corrcoef(cv, mu_b)[0, 1])
    progress = _np(log.progress)
    steps = batch * n_windows * T_window
    return {
        "preset": "race_learn",
        "batch": batch,
        "windows": n_windows,
        "composed_steps": steps,
        "wall_s": round(wall, 1),
        "steps_per_s": round(steps / wall, 1),
        "mu_corr": round(corr_mu, 4),
        "corner_vx_vs_mu_corr": round(corr_cv, 4),
        "corner_vx_lo_mean": round(float(cv[:batch // 4].mean()), 3),
        "corner_vx_hi_mean": round(float(cv[-batch // 4:].mean()), 3),
        # windows may be shorter than a lap, so progress (not lap steps,
        # whose T+1 sentinel would dominate) is the pace metric: the median
        # distance covered per window, first vs last
        "progress_m_first_window": round(float(np.median(progress[0])), 2),
        "progress_m_last_window": round(float(np.median(progress[-1])), 2),
        "converged_frac": round(float(_np(log.converged).astype(np.float64).mean()), 3),
    }


PRESETS: Dict[str, Callable] = {
    "config1": config1,
    "config1_planner": config1_planner,
    "adaptive": adaptive,
    "learn": learn,
    "race": race,
    "race_sweep": race_sweep,
    "race_learn": race_learn,
    "config2": config2,
    "config3": config3,
    "config4": config4,
    "config5": config5,
    "latency": latency,
}


def run_preset(name: str, p: Optional[VehicleParams] = None, scfg: Optional[SolverConfig] = None,
               **kw) -> Dict:
    """Run preset ``name`` with vehicle ``p`` (default VehicleParams()) and
    solver ``scfg`` (default SolverConfig(max_iter=60)); ``kw`` are the
    preset's knobs, ``device`` among them."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](p or VehicleParams(), scfg or SolverConfig(max_iter=60), **kw)

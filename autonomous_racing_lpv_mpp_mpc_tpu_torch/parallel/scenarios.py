"""Scenario sweeps over the rank mesh (the JAX package's
``parallel/scenarios.py``): thousands of closed-loop solves per card, the
batch split over the mesh's ``scenarios`` dim.

Each rank runs its own shard of the batch (``mesh.scenario_sharding``)
through the single-card path: the ``mpc_step_batched`` route of
``scfg.backend`` (the fused kernel or the solver-only kernel on the card),
the megastep, or the racestep scan. No collective touches a kernel: only
the metric reduction crosses ranks, one ``psum_tree`` of
:class:`SweepMetrics`, replicated on every rank. Logs are batch-first, (b,
T, ...), the local shard, as each process of the JAX package addresses
its shards.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..core.device import resolve_device
from ..loop.closed_loop import ClosedLoopLog, closed_loop, plant_step
from ..loop.mpc import mpc_init, mpc_step_batched
from ..models import model_nx
from ..ops.stage_math import model_s_ey
from ..track.track import Track
from .collectives import barrier, psum_tree
from .mesh import SCENARIO_AXIS


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """A batch of scenarios: stacked initial states and vehicle params."""

    x0: torch.Tensor          # (B, nx)
    params: VehicleParams     # batched leaves are (B,) tensors

    @property
    def batch(self) -> int:
        return self.x0.shape[0]


class SweepMetrics(NamedTuple):
    """Sweep statistics summed over every rank's lanes (0-d tensors)."""

    n_scenarios: torch.Tensor
    ey_rms: torch.Tensor          # mean over scenarios of the per-scenario RMS
    converged_frac: torch.Tensor
    mean_iters: torch.Tensor
    mean_progress: torch.Tensor   # mean final s


def make_scenario_grid(base: VehicleParams, cfg: MPCConfig, n_ey: int = 8,
                       n_mu: int = 8, ey_span: float = 0.25, mu_range=(0.7, 1.0),
                       vx0: float = 1.0, device=None) -> ScenarioBatch:
    """(initial e_y) x (friction mu) grid, e_y-major like the JAX package,
    on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    nx = model_nx(cfg.model)
    _, ey_i = model_s_ey(cfg.model)
    eys = torch.linspace(-ey_span, ey_span, n_ey, dtype=torch.float32, device=device)
    mus = torch.linspace(mu_range[0], mu_range[1], n_mu, dtype=torch.float32, device=device)
    ey_g, mu_g = torch.meshgrid(eys, mus, indexing="ij")
    ey_f, mu_f = ey_g.reshape(-1), mu_g.reshape(-1)
    B = ey_f.shape[0]
    x0 = torch.zeros((B, nx), dtype=torch.float32, device=device)
    x0[:, 0] = vx0
    x0[:, ey_i] = ey_f
    return ScenarioBatch(x0=x0, params=base.replace(mu=mu_f))


def _local_metrics(X, converged, iters, ey_i: int, s_i: int) -> SweepMetrics:
    """This rank's sums from X (b, T, nx), converged and iters (b, T)."""
    ey_rms = torch.sqrt(torch.mean(X[..., ey_i] ** 2, dim=-1))
    return SweepMetrics(
        n_scenarios=torch.tensor(float(X.shape[0]), dtype=torch.float32, device=X.device),
        ey_rms=torch.sum(ey_rms),
        converged_frac=torch.sum(torch.mean(converged.to(torch.float32), dim=-1)),
        mean_iters=torch.sum(torch.mean(iters.to(torch.float32), dim=-1)),
        mean_progress=torch.sum(X[:, -1, s_i]),
    )


def _metrics_from_log(cfg: MPCConfig, log: ClosedLoopLog) -> SweepMetrics:
    s_i, ey_i = model_s_ey(cfg.model)
    return _local_metrics(log.X, log.converged, log.iters, ey_i, s_i)


def _finalize(m: SweepMetrics) -> SweepMetrics:
    n = torch.clamp_min(m.n_scenarios, 1.0)
    return SweepMetrics(n_scenarios=m.n_scenarios, ey_rms=m.ey_rms / n, converged_frac=m.converged_frac / n,
                        mean_iters=m.mean_iters / n, mean_progress=m.mean_progress / n)


def _reduce(mesh: DeviceMesh, local: SweepMetrics) -> SweepMetrics:
    return _finalize(psum_tree(local, mesh.get_group(SCENARIO_AXIS)))


def sharded_closed_loop(mesh: DeviceMesh, scen: ScenarioBatch, cfg: MPCConfig, scfg: SolverConfig,
                        track: Track, x_ref, T: int, sim_tire: Optional[str] = None):
    """B closed loops split over the mesh's scenario dim; ``scen`` is this
    rank's shard. Returns (the local log, a ``ClosedLoopLog`` with leaves
    (b, T, ...), and the mesh-wide :class:`SweepMetrics` on every rank)."""
    log = closed_loop(scen.params, cfg, scfg, track, scen.x0, x_ref, T, sim_tire=sim_tire)
    log = ClosedLoopLog(*(t.movedim(0, 1) for t in log))
    return log, _reduce(mesh, _metrics_from_log(cfg, log))


def sharded_mega_loop(mesh: DeviceMesh, scen: ScenarioBatch, cfg: MPCConfig, scfg: SolverConfig,
                      track: Track, x_ref, T: int, n_sub: int = 4, sim_tire: Optional[str] = None):
    """The closed-loop sweep on the megastep, one launch per step for the
    rank's shard ``scen`` (the plain version on CPU tensors). Returns
    (X_log (b, T, nx), the mesh-wide SweepMetrics); ``mean_iters`` is the
    megastep's done-at."""
    from ..ops.megastep_kernel import megastep, megastep_init, megastep_params

    b = scen.batch
    carry = megastep_init(scen.params, cfg, track, scen.x0)
    prm = megastep_params(scen.params, b, device=scen.x0.device)
    xs, conv, iters = [], [], []
    for _ in range(T):
        carry, _u0, diag = megastep(cfg, scfg, track, prm, x_ref, carry, n_sub=n_sub, sim_tire=sim_tire)
        xs.append(carry.x)
        conv.append(diag[2])
        iters.append(diag[4])
    X_log = torch.stack(xs).permute(2, 0, 1)              # (b, T, nx)
    s_i, ey_i = model_s_ey(cfg.model)
    local = _local_metrics(X_log, torch.stack(conv).T, torch.stack(iters).T, ey_i, s_i)
    return X_log, _reduce(mesh, local)


def _rank_generator(device, seed: int, rank: int) -> torch.Generator:
    """The noise stream of scenario rank ``rank``: rank 0's is the
    single-card sweep's ``seed`` stream, the others' are seeded apart."""
    return torch.Generator(device=device).manual_seed(int(seed) + (int(rank) << 32))


def sharded_race_sweep(mesh: DeviceMesh, p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig,
                       track: Track, table, x0_b: torch.Tensor, T: int, mu_true_b: torch.Tensor,
                       mu0: float = 1.0, noise_sigma=None, seed: int = 0):
    """The composed deployment sweep (racestep: measurement, EKF, friction
    RLS, tracker, world plant, one launch per step) split over the scenario
    dim: ``x0_b`` (b, 6) and ``mu_true_b`` (b,) are this rank's shard; it
    runs ``loop.mega_race_sweep`` on them. JAX splits one key per shard;
    here each rank draws its sensor noise from its own generator
    (:func:`_rank_generator`), so rank 0 draws what ``mega_race_sweep``
    draws from the same ``seed``. Returns (mu_hat (b, T), Xf (b, T, 6), the
    mesh-wide SweepMetrics; ``mean_iters`` is 0, as in JAX)."""
    from ..loop.race import mega_race_sweep

    rank = mesh.get_local_rank(SCENARIO_AXIS)
    log = mega_race_sweep(p, cfg, scfg, track, table, x0_b, T, mu_true_b, mu0=mu0, noise_sigma=noise_sigma,
                          generator=_rank_generator(x0_b.device, seed, rank))
    local = _local_metrics(log.Xf, log.converged, torch.zeros_like(log.converged), 5, 4)
    return log.mu_hat, log.Xf, _reduce(mesh, local)


def sharded_solve_step(mesh: DeviceMesh, scen: ScenarioBatch, cfg: MPCConfig, scfg: SolverConfig,
                       track: Track, x_ref, carries=None):
    """One batched MPC control step of this rank's shard (the latency path).
    No collective: ``mesh`` is taken for the JAX signature. Returns (u (b,
    nu), new carries, diag)."""
    if carries is None:
        carries = mpc_init(scen.params, cfg, track, scen.x0)
    return mpc_step_batched(scen.params, cfg, scfg, track, scen.x0, x_ref, carries)


def sweep_chunk_fn(mesh: DeviceMesh, cfg: MPCConfig, scfg: SolverConfig, track: Track, x_ref,
                   save_every: int, sim_tire: Optional[str] = None):
    """The ``save_every``-step sweep chunk of :func:`checkpointed_sweep`:
    ``fn(xs, params, carries, acc) -> (xs', carries', acc')`` on this
    rank's shard, ``acc`` the running sums {"conv", "ey_sq", "iters"} (b,).
    The chunk holds no collective (``mesh``: the JAX signature)."""
    _, ey_i = model_s_ey(cfg.model)

    def fn(xs, params, carries, acc):
        acc = dict(acc)
        for _ in range(save_every):
            u, carries, diag = mpc_step_batched(params, cfg, scfg, track, xs, x_ref, carries)
            xs = plant_step(params, cfg, track, xs, u, sim_tire=sim_tire)
            acc = {"conv": acc["conv"] + diag.converged.to(torch.float32),
                   "ey_sq": acc["ey_sq"] + xs[:, ey_i] ** 2,
                   "iters": acc["iters"] + diag.iters.to(torch.float32)}
        return xs, carries, acc

    return fn


def initial_sweep_state(scen: ScenarioBatch, cfg: MPCConfig, track: Track) -> dict:
    """The state :func:`checkpointed_sweep` saves, at step 0: plant states,
    MPC carries and the running sums of :func:`sweep_chunk_fn`; also the
    template that a saved step is restored into."""
    zeros = torch.zeros((scen.batch,), dtype=torch.float32, device=scen.x0.device)
    return {"xs": scen.x0, "carries": mpc_init(scen.params, cfg, track, scen.x0),
            "acc": {"conv": zeros, "ey_sq": zeros, "iters": zeros}}


def checkpointed_sweep(mesh: DeviceMesh, scen: ScenarioBatch, cfg: MPCConfig, scfg: SolverConfig,
                       track: Track, x_ref, T: int, checkpoint_dir: str, save_every: int = 50,
                       sim_tire: Optional[str] = None):
    """A resumable mesh-wide sweep: ``T`` closed-loop steps of this rank's
    shard ``scen`` in chunks of ``save_every``. After each chunk the sweep
    state (:func:`initial_sweep_state`) is saved, one file per rank
    (``utils.record.SweepCheckpoint``); a call on a directory that holds a
    complete step resumes from the latest one, and its final metrics equal
    an uninterrupted run's bit for bit.

    Returns (SweepMetrics, the steps run by this call)."""
    from ..utils.record import SweepCheckpoint

    s_i, _ = model_s_ey(cfg.model)
    fn = sweep_chunk_fn(mesh, cfg, scfg, track, x_ref, save_every, sim_tire=sim_tire)
    chunk = lambda st: dict(zip(("xs", "carries", "acc"), fn(st["xs"], scen.params, st["carries"], st["acc"])))
    ckpt = SweepCheckpoint(checkpoint_dir, rank=dist.get_rank(), world_size=dist.get_world_size())
    # every rank's step is on disk before any rank goes on
    state, steps = ckpt.run(initial_sweep_state(scen, cfg, track), chunk, T, save_every, after_save=barrier)
    acc = state["acc"]
    local = SweepMetrics(
        n_scenarios=torch.tensor(float(scen.batch), dtype=torch.float32, device=scen.x0.device),
        ey_rms=torch.sum(torch.sqrt(acc["ey_sq"] / T)), converged_frac=torch.sum(acc["conv"] / T),
        mean_iters=torch.sum(acc["iters"] / T), mean_progress=torch.sum(state["xs"][:, s_i]))
    return _reduce(mesh, local), steps

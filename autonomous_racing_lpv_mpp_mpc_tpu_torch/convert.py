"""Hand objects of the JAX package to the port, and carries back.

The JAX package is never imported here: its objects are read by attribute
and their leaves turned into numpy arrays (``np.asarray``), so the same
functions accept the JAX objects themselves or any object with the same
fields holding numpy arrays or floats. The reverse direction returns plain
numpy dictionaries, from which the JAX side rebuilds its carry
(``MPCCarry(**d)``). For a system without model weights, this is how state
carries across: a test can run one step on each side and re-sync one from
the other.

Every function that makes tensors takes ``device``; ``None`` is the CUDA
card, ``device="cpu"`` a CPU run.

SolverConfig backends map "xla" -> "plain", "pallas" -> "admm",
"mega" -> "mega", "fused" -> "fused".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import MPCBounds, MPCConfig, MPCWeights, MPPConfig, SolverConfig, VehicleParams
from .core.device import resolve_device
from .loop.estimator import EKFState
from .loop.friction import FrictionState
from .loop.mpc import MPCCarry
from .loop.race import RaceCarry
from .ops.megastep_kernel import MegaCarry
from .ops.racestep_kernel import RaceMegaCarry
from .planner.opponents import OpponentSet
from .planner.reftable import RefTable
from .solver.admm import BoxQP
from .solver.riccati import LQRCost, LQRDynamics
from .track.track import Track

BACKENDS = {"xla": "plain", "pallas": "admm", "mega": "mega", "fused": "fused"}


def tensor(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=resolve_device(device))


def vehicle_params(obj, device=None) -> VehicleParams:
    """Scalar leaves become floats, batched (B,) leaves float32 tensors."""
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(VehicleParams):
        v = np.asarray(getattr(obj, f.name))
        out[f.name] = float(v) if v.ndim == 0 else tensor(v, device)
    return VehicleParams(**out)


def _floats(cls, obj):
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        out[f.name] = tuple(float(x) for x in v) if isinstance(v, (tuple, list)) else v
    return out


def mpc_config(obj) -> MPCConfig:
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(MPCConfig)
          if f.name not in ("weights", "bounds")}
    kw["dt"] = float(kw["dt"])
    kw["a_lat_frac"] = float(kw["a_lat_frac"])
    return MPCConfig(weights=MPCWeights(**_floats(MPCWeights, obj.weights)),
                     bounds=MPCBounds(**{k: float(v) for k, v in _floats(MPCBounds, obj.bounds).items()}),
                     **kw)


def mpp_config(obj) -> MPPConfig:
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(MPPConfig) if f.name != "bounds"}
    for name in ("dt", "w_progress", "a_lat_frac", "ey_margin", "ds_ref"):
        kw[name] = float(kw[name])
    for name in ("q_trust", "r", "dr"):
        kw[name] = tuple(float(x) for x in kw[name])
    return MPPConfig(bounds=MPCBounds(**{k: float(v) for k, v in _floats(MPCBounds, obj.bounds).items()}),
                     **kw)


def solver_config(obj) -> SolverConfig:
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(SolverConfig)}
    for name in ("rho", "sigma", "alpha", "eps_abs", "eps_rel", "eps_fallback", "cache_drift_tol"):
        kw[name] = float(kw[name])
    if kw["backend"] not in BACKENDS:
        raise NotImplementedError(f"backend {kw['backend']!r} has no counterpart in the port yet")
    kw["backend"] = BACKENDS[kw["backend"]]
    return SolverConfig(**kw)


def track(obj, device=None) -> Track:
    return Track(**{f.name: tensor(getattr(obj, f.name), device) for f in dataclasses.fields(Track)})


def mpc_carry(obj, device=None) -> MPCCarry:
    return MPCCarry(*(tensor(getattr(obj, n), device) for n in MPCCarry._fields))


def mega_carry(obj, device=None) -> MegaCarry:
    return MegaCarry(*(tensor(getattr(obj, n), device) for n in MegaCarry._fields))


def race_mega_carry(obj, device=None) -> RaceMegaCarry:
    return RaceMegaCarry(*(tensor(getattr(obj, n), device) for n in RaceMegaCarry._fields))


def ref_table(obj, device=None) -> RefTable:
    """A RefTable, shared (channels (n,), 0-d ds/length) or per lane (the
    JAX package's table with every leaf broadcast to (B,) + shape)."""
    return RefTable(*(tensor(getattr(obj, f.name), device) for f in dataclasses.fields(RefTable)))


def opponent_set(obj, device=None) -> OpponentSet:
    return OpponentSet(*(tensor(getattr(obj, n), device) for n in OpponentSet._fields))


def ekf_state(obj, device=None) -> EKFState:
    return EKFState(*(tensor(getattr(obj, n), device) for n in EKFState._fields))


def friction_state(obj, device=None) -> FrictionState:
    return FrictionState(*(tensor(getattr(obj, n), device) for n in FrictionState._fields))


def race_carry(obj, device=None) -> RaceCarry:
    """A (batched) JAX ``RaceCarry``. Its PRNG key has no counterpart: the
    carry comes without a noise stream (``generator=None``, clean
    measurements) until the caller ``_replace``s one in."""
    return RaceCarry(xg=tensor(obj.xg, device), mpc=mpc_carry(obj.mpc, device),
                     ekf=ekf_state(obj.ekf, device), fric=friction_state(obj.fric, device),
                     x_prev_f=tensor(obj.x_prev_f, device), u_prev=tensor(obj.u_prev, device),
                     generator=None)


def _shared_rows(a, device, ndim=2):
    """Per-row data shared by the batch: ``ndim`` dims, or one more (a
    leading batch) with identical entries per lane."""
    a = np.asarray(a)
    if a.ndim == ndim + 1:
        if not (a == a[:1]).all():
            raise ValueError("constraint rows differ across the batch")
        a = a[0]
    return tensor(a, device)


def boxqp(obj, device=None) -> BoxQP:
    t = lambda a: tensor(a, device)
    return BoxQP(
        dyn=LQRDynamics(t(obj.dyn.A), t(obj.dyn.B), t(obj.dyn.c)),
        cost=LQRCost(t(obj.cost.Q), t(obj.cost.q), t(obj.cost.R), t(obj.cost.r), t(obj.cost.M)),
        Dx=_shared_rows(obj.Dx, device), Du=_shared_rows(obj.Du, device),
        lb=t(obj.lb), ub=t(obj.ub), x0=t(obj.x0), soft=_shared_rows(obj.soft, device, ndim=1),
    )


def to_numpy(carry) -> dict:
    """A port carry (MPCCarry, MegaCarry, RaceMegaCarry, EKFState,
    FrictionState, RaceCarry), OpponentSet or RefTable as a dict of numpy
    arrays; nested carries become nested dicts and RaceCarry's generator is
    left out."""
    if isinstance(carry, RefTable):
        return {f.name: getattr(carry, f.name).detach().cpu().numpy() for f in dataclasses.fields(carry)}
    out = {}
    for n in carry._fields:
        v = getattr(carry, n)
        if isinstance(v, torch.Tensor):
            out[n] = v.detach().cpu().numpy()
        elif isinstance(v, tuple):
            out[n] = to_numpy(v)
    return out


def boxqp_to_numpy(qp: BoxQP) -> dict:
    """A port BoxQP as nested numpy dicts: {"dyn": {...}, "cost": {...}, ...}."""
    np_ = lambda a: a.detach().cpu().numpy()
    return {
        "dyn": {n: np_(getattr(qp.dyn, n)) for n in LQRDynamics._fields},
        "cost": {n: np_(getattr(qp.cost, n)) for n in LQRCost._fields},
        **{n: np_(getattr(qp, n)) for n in ("Dx", "Du", "lb", "ub", "x0", "soft")},
    }


def race_log_to_numpy(log) -> dict:
    """A port ``RaceLog`` as a dict of numpy arrays, the JAX ``RaceLog``'s
    fields and types."""
    return {n: getattr(log, n).detach().cpu().numpy() for n in log._fields}


def replan_log_to_numpy(log) -> dict:
    """A port ``ReplanLog``: its closed-loop log's fields as numpy arrays,
    beside ``replan_steps`` and ``plan_progress``."""
    out = {n: getattr(log.log, n).detach().cpu().numpy() for n in log.log._fields}
    out.update(replan_steps=np.asarray(log.replan_steps), plan_progress=np.asarray(log.plan_progress))
    return out

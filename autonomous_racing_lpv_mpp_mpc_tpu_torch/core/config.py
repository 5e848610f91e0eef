"""Frozen dataclass configs, field for field the JAX package's
``core/config.py``.

Numeric fields of :class:`VehicleParams` may be Python floats (one car) or
1-D float32 tensors of length B (a batch of cars, e.g. a friction sweep);
:func:`broadcast_params` shapes the tensor leaves against a batch-first
array. Structural fields (horizon, iteration counts, model names) are plain
Python values.

``SolverConfig.backend`` names, and their counterparts in the JAX package:

    "plain" (default)  <->  "xla"    batched PyTorch ADMM (solver/admm.py)
    "admm"             <->  "pallas" solver-only kernel (ops/admm_kernel.py)
    "mega"             <->  "mega"   the whole step, via ops.megastep_kernel
    "fused"            <->  "fused"  assembly + solve kernel (ops/fused_kernel.py)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class VehicleParams(_Replace):
    """Dynamic-bicycle vehicle parameters (1:10 BARC-style car)."""

    m: float = 2.424        # mass [kg]
    Iz: float = 0.02        # yaw inertia [kg m^2]
    lf: float = 0.125       # CoG -> front axle [m]
    lr: float = 0.125       # CoG -> rear axle [m]
    Cf: float = 57.5        # front cornering stiffness [N/rad]
    Cr: float = 67.5        # rear cornering stiffness [N/rad]
    mu: float = 1.0         # tire-road friction coefficient [-]
    g: float = 9.81         # gravity [m/s^2]
    cd0: float = 0.0        # F_drag = cd0 * sign(vx) + cd1 * vx
    cd1: float = 0.0


FIELDS = tuple(f.name for f in dataclasses.fields(VehicleParams))


def broadcast_params(p: VehicleParams, ndim: int) -> VehicleParams:
    """Reshape batched (B,) tensor leaves to (B, 1, ..., 1) with ``ndim``
    dims so they broadcast against a batch-first array of that rank."""
    out = {}
    for name in FIELDS:
        v = getattr(p, name)
        if isinstance(v, torch.Tensor) and v.dim() >= 1:
            v = v.reshape(v.shape[:1] + (1,) * (ndim - 1))
        out[name] = v
    return VehicleParams(**out)


@dataclasses.dataclass(frozen=True)
class MPCWeights(_Replace):
    """Quadratic tracking weights (diagonals) in the model's state order."""

    q: Tuple[float, ...] = (120.0, 1.0, 1.0, 70.0, 0.0, 100.0)
    r: Tuple[float, ...] = (1.0, 1.0)
    dr: Tuple[float, ...] = (30.0, 15.0)

    @classmethod
    def for_model(cls, model: str) -> "MPCWeights":
        if model == "dynamic":   # (vx, vy, wz, e_psi, s, e_y)
            return cls(q=(120.0, 1.0, 1.0, 70.0, 0.0, 100.0))
        if model == "kinematic":  # (vx, e_psi, s, e_y)
            return cls(q=(50.0, 20.0, 0.0, 60.0))
        raise ValueError(model)


@dataclasses.dataclass(frozen=True)
class MPCBounds(_Replace):
    """Box bounds on states / inputs / input rates."""

    vx_min: float = 0.2
    vx_max: float = 4.0
    ey_max: float = 0.4          # half track width [m]
    delta_max: float = 0.30      # |steering| [rad]
    a_min: float = -2.0          # accel [m/s^2]
    a_max: float = 3.0
    ddelta_max: float = 0.60     # |Delta delta| per step [rad]
    da_max: float = 3.0          # |Delta a| per step [m/s^2]
    ey_soft: float = 2000.0      # soft e_y corridor weight; inf = hard box


@dataclasses.dataclass(frozen=True)
class MPCConfig(_Replace):
    """Horizon / timing / model-mode config for the tracking MPC."""

    N: int = 12
    dt: float = 1.0 / 30.0
    model: str = "dynamic"          # "dynamic" | "kinematic"
    tire: str = "linear"            # "linear" | "pacejka"
    linearization: str = "lpv"      # "lpv" | "ltv" (exact Jacobians + affine term)
    discretization: str = "expm"    # "expm" (Van Loan) | "euler" | "order2"
    kappa_speed_cap: bool = True
    a_lat_frac: float = 0.9
    weights: MPCWeights = dataclasses.field(default_factory=MPCWeights)
    bounds: MPCBounds = dataclasses.field(default_factory=MPCBounds)


@dataclasses.dataclass(frozen=True)
class SolverConfig(_Replace):
    """Batched ADMM (OSQP semantics) + Riccati x-update solver config.

    Same fields and defaults as the JAX package; see the module docstring
    for the ``backend`` names. ``riccati`` is "scan" (sequential) or
    "assoc" (parallel in the horizon); ``equilibrate``, ``polish`` and
    ``certify_infeasibility`` are the production pipeline's stages
    (``solver.production``). ``cache_build`` switches the megastep's
    discretization cache on (``ops.megastep_kernel.MegaCache``).
    """

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 50
    eps_abs: float = 3e-4
    eps_rel: float = 3e-4
    eps_fallback: float = 2e-2
    rho_interval: int = 10
    riccati: str = "scan"
    check_termination: int = 5
    early_exit: bool = False
    cache_build: bool = False
    cache_drift_tol: float = 0.3
    cache_max_age: int = 8
    backend: str = "plain"
    equilibrate: bool = True
    polish: bool = False
    certify_infeasibility: bool = True


@dataclasses.dataclass(frozen=True)
class MPPConfig(_Replace):
    """MPP planner config: the tracker's LPV machinery with a progress
    reward, a trust region and the planner's per-stage bounds
    (curvature-limited speed, obstacle-shifted corridor)."""

    H: int = 512                    # planning stages
    n_sqp: int = 4                  # relinearizations
    dt: float = 1.0 / 30.0
    model: str = "dynamic"
    tire: str = "linear"
    linearization: str = "lpv"
    discretization: str = "expm"
    # progress reward (linear weight on terminal s) and trust-region weights
    w_progress: float = 50.0
    q_trust: Tuple[float, ...] = (0.0, 0.5, 0.5, 5.0, 0.0, 5.0)
    r: Tuple[float, ...] = (0.05, 0.05)
    dr: Tuple[float, ...] = (20.0, 10.0)
    # share of the friction circle for the curvature speed limit
    # v <= sqrt(a_lat_frac * mu * g / |kappa|)
    a_lat_frac: float = 0.7
    # corridor margin from the track edge [m] (car half-width + safety)
    ey_margin: float = 0.05
    bounds: MPCBounds = dataclasses.field(default_factory=MPCBounds)
    # resolution of the emitted reference table [m]
    ds_ref: float = 0.05

    @classmethod
    def for_model(cls, model: str, **kw) -> "MPPConfig":
        """Per-model defaults in the model's state order."""
        if model == "dynamic":     # (vx, vy, wz, e_psi, s, e_y)
            return cls(model="dynamic", **kw)
        if model == "kinematic":   # (vx, e_psi, s, e_y)
            return cls(model="kinematic", q_trust=(0.0, 5.0, 0.0, 5.0), **kw)
        raise ValueError(model)


@dataclasses.dataclass(frozen=True)
class MeshConfig(_Replace):
    """Rank-mesh layout for scenario-parallel / horizon-parallel runs:
    dim "scenarios" splits the scenario batch, dim "horizon" the horizon's
    stage blocks (``parallel.mesh.from_config``)."""

    scenario_axis: str = "scenarios"
    horizon_axis: str = "horizon"
    n_scenario: int = 1
    n_horizon: int = 1

from .config import (
    MPCBounds,
    MPCConfig,
    MPCWeights,
    MPPConfig,
    SolverConfig,
    VehicleParams,
    broadcast_params,
)
from .device import resolve_device

__all__ = [
    "MPCBounds",
    "MPCConfig",
    "MPCWeights",
    "MPPConfig",
    "SolverConfig",
    "VehicleParams",
    "broadcast_params",
    "resolve_device",
]

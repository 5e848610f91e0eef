from .config import (
    MPCBounds,
    MPCConfig,
    MPCWeights,
    SolverConfig,
    VehicleParams,
    broadcast_params,
)

__all__ = [
    "MPCBounds",
    "MPCConfig",
    "MPCWeights",
    "SolverConfig",
    "VehicleParams",
    "broadcast_params",
]

"""The real-car IO layer (the JAX package's ``io``): the native
shared-memory / UDP bridge and the real-time tracking loop over it."""

from .bridge import (
    BridgeUnavailable,
    CarBridge,
    UDPBridge,
    UDPLink,
    bridge_available,
    monotonic,
)
from .realtime import RealtimeLog, lockstep_car, realtime_tracking_loop

__all__ = [
    "BridgeUnavailable",
    "CarBridge",
    "UDPBridge",
    "UDPLink",
    "bridge_available",
    "monotonic",
    "RealtimeLog",
    "lockstep_car",
    "realtime_tracking_loop",
]

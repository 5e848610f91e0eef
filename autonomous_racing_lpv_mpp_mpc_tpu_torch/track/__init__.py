from .specs import OVAL_SEGMENTS, RACETRACK_SEGMENTS, oval_track, racetrack
from .track import (
    Track,
    centerline_pose,
    compile_track,
    curvature_at,
    frenet_to_global,
    global_to_frenet,
    global_to_frenet_windowed,
    wrap_s,
)

__all__ = [
    "OVAL_SEGMENTS",
    "RACETRACK_SEGMENTS",
    "Track",
    "centerline_pose",
    "compile_track",
    "curvature_at",
    "frenet_to_global",
    "global_to_frenet",
    "global_to_frenet_windowed",
    "oval_track",
    "racetrack",
    "wrap_s",
]

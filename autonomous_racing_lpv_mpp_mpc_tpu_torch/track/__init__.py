from .specs import OVAL_SEGMENTS, RACETRACK_SEGMENTS, oval_track, racetrack
from .track import (
    Track,
    centerline_pose,
    compile_track,
    curvature_at,
    frenet_to_global,
    global_to_frenet,
    global_to_frenet_windowed,
    track_from_centerline,
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
    "track_from_centerline",
    "wrap_s",
]

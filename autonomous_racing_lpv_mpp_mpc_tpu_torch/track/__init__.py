from .specs import OVAL_SEGMENTS, RACETRACK_SEGMENTS, oval_track, racetrack
from .track import Track, compile_track, curvature_at, wrap_s

__all__ = [
    "OVAL_SEGMENTS",
    "RACETRACK_SEGMENTS",
    "Track",
    "compile_track",
    "curvature_at",
    "oval_track",
    "racetrack",
    "wrap_s",
]
